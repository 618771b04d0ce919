"""GDRN batches from BOP records (port of self6dpp_tpu/data/loader.py:
compute_vf_np[_batch], ObjectModels, GDRNDataset, _prefetch_iterator).

Per sample on the host (numpy, a thread pool): read the image and masks
(data/image_io.py), crop the detection box's square to input_res and the
masks and 2D coordinates to output_res (data/aug.py, cv2.warpAffine bit
for bit). Per batch on the dataset's device: the ground-truth labels come
from renders (ops/rasterizer.py, kernel B1 on the card with impl="kernel"),
one batched call for the instances not yet in the label cache, rendered in
a square frame that covers every crop of the instance at label_cache_res
(tile 8, K 64, hard) and warped into each crop with nearest sampling. The
cache stores the attributes in float16 and the mask as bool, as the JAX
package's does, so that both warp the same values. The JAX package pins
these renders to the host CPU and its XLA rasterizer; here they run where
the dataset's `device` is, with its `impl`.

The training mode (train=True) adds, per sample and in the JAX
package's order of draws: background replacement (when bg_images are
given), colour augmentation, the DZI box jitter and depth noise (data/aug.py);
its regions are assigned inside m_obj * m_visib; batches(infinite=True)
draws the instances from cfg.data.sampler (data/samplers.py). Without a
thread pool every draw comes from the dataset's generator; with one, each
sample gets a child generator spawned from the dataset's seed sequence, as
the JAX package spawns them.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..ops.fps import farthest_point_sampling, xyz_to_region_batch
from ..parallel.dist import data_rank, data_size
from .aug import add_noise_depth, aug_bbox_dzi, color_aug, \
    crop_resize_by_warp_affine, get_2d_coord, replace_bg, warp_affine
from .bop import Record
from .image_io import imread
from .meshes import load_ply, pad_mesh
from .ref import DatasetMeta, sym_rotations_from_info
from .samplers import (inference_sampler, infinite_subset_random_sampler,
                       process_shard,
                       repeat_factor_sampler,
                       repeat_factors_from_category_frequency,
                       training_sampler)


def compute_vf_np(fps_points: np.ndarray, K: np.ndarray, R: np.ndarray,
                  t: np.ndarray, center, scale, out_res: int,
                  mask: np.ndarray) -> np.ndarray:
    """Per crop pixel, the unit direction to each projected FPS keypoint,
    masked. Returns (out_res, out_res, 2f) float32."""
    cam = fps_points @ R.T + t                       # (f,3)
    kp = (cam[:, :2] / np.maximum(cam[:, 2:3], 1e-8))
    kp = kp * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])
    lin = (np.arange(out_res, dtype=np.float32) + 0.5) / out_res
    px = center[0] - scale / 2 + scale * lin
    py = center[1] - scale / 2 + scale * lin
    grid = np.stack(np.meshgrid(px, py), axis=-1)    # (o,o,2) x-major cols
    vf = kp[None, None, :, :] - grid[:, :, None, :]  # (o,o,f,2)
    vf /= np.maximum(np.linalg.norm(vf, axis=-1, keepdims=True), 1e-8)
    vf = vf.reshape(out_res, out_res, -1) * mask[..., None]
    return vf.astype(np.float32)


def compute_vf_np_batch(fps_points: np.ndarray, K: np.ndarray, R: np.ndarray,
                        t: np.ndarray, center: np.ndarray, scale: np.ndarray,
                        out_res: int, mask: np.ndarray) -> np.ndarray:
    """compute_vf_np over a batch: fps_points (B,f,3), K/R (B,3,3), t (B,3),
    center (B,2), scale (B,), mask (B,o,o) -> (B,o,o,2f)."""
    B = len(fps_points)
    o = out_res
    cam = np.einsum("bfc,bdc->bfd", fps_points, R) + t[:, None]     # (B,f,3)
    kp = cam[..., :2] / np.maximum(cam[..., 2:3], 1e-8)
    f_xy = np.stack([K[:, 0, 0], K[:, 1, 1]], -1)[:, None]          # (B,1,2)
    c_xy = np.stack([K[:, 0, 2], K[:, 1, 2]], -1)[:, None]
    kp = kp * f_xy + c_xy                                           # (B,f,2)
    lin = (np.arange(o, dtype=np.float32) + 0.5) / o
    px = center[:, 0:1] - scale[:, None] / 2 + scale[:, None] * lin[None]
    py = center[:, 1:2] - scale[:, None] / 2 + scale[:, None] * lin[None]
    gx = np.broadcast_to(px[:, None, :], (B, o, o))    # grid[y,x] = px[x]
    gy = np.broadcast_to(py[:, :, None], (B, o, o))    #             py[y]
    grid = np.stack([gx, gy], axis=-1)                              # (B,o,o,2)
    vf = kp[:, None, None] - grid[..., None, :]                     # (B,o,o,f,2)
    vf /= np.maximum(np.linalg.norm(vf, axis=-1, keepdims=True), 1e-8)
    vf = vf.reshape(B, o, o, -1) * mask[..., None]
    return vf.astype(np.float32)


@dataclass
class ObjectModels:
    """Per-class static mesh and metadata arrays (padded)."""
    names: list[str]
    verts: np.ndarray            # (C, V, 3)
    faces: np.ndarray            # (C, F, 3)
    colors: np.ndarray           # (C, V, 3)
    normals: np.ndarray          # (C, V, 3)
    fps_points: np.ndarray       # (C, n_regions, 3)
    pm_points: np.ndarray        # (C, n_points, 3) FPS-sampled loss points
    extents: np.ndarray          # (C, 3)
    diameters: np.ndarray        # (C,)
    sym_rots: np.ndarray         # (C, S, 3, 3)
    sym_valid: np.ndarray        # (C, S)
    # textured models: per-vertex UVs pre-scaled to the shared padded atlas
    # size, and the atlases; None when untextured
    uvs: np.ndarray | None = None        # (C, V, 2)
    textures: np.ndarray | None = None   # (C, Ht, Wt, 3) float [0,1]

    @classmethod
    def from_meshes(cls, names, meshes: list[dict], n_regions: int = 64,
                    n_points: int = 512, max_sym: int = 32,
                    models_info: dict | None = None,
                    sym_names: tuple[str, ...] = ()) -> "ObjectModels":
        """meshes: dicts with verts/faces[/colors/normals/uv/texture]
        (metres). Vertex normals, where a mesh has none, are area-weighted
        (ops/rasterizer.py::compute_vertex_normals, on the CPU)."""
        from ..ops.rasterizer import compute_vertex_normals

        max_v = max(len(m["verts"]) for m in meshes)
        max_f = max(len(m["faces"]) for m in meshes)
        C = len(meshes)
        verts = np.zeros((C, max_v, 3), np.float32)
        faces = np.zeros((C, max_f, 3), np.int32)
        colors = np.zeros((C, max_v, 3), np.float32)
        normals = np.zeros((C, max_v, 3), np.float32)
        fps_pts = np.zeros((C, n_regions, 3), np.float32)
        pm_pts = np.zeros((C, n_points, 3), np.float32)
        extents = np.zeros((C, 3), np.float32)
        diam = np.zeros((C,), np.float32)
        srots = np.broadcast_to(np.eye(3, dtype=np.float32),
                                (C, max_sym, 3, 3)).copy()
        svalid = np.zeros((C, max_sym), bool)
        svalid[:, 0] = True

        for i, m in enumerate(meshes):
            v, f = m["verts"], m["faces"]
            pv, pf = pad_mesh(v, f, max_v, max_f)
            verts[i], faces[i] = pv, pf
            if "colors" in m:
                colors[i, : len(v)] = m["colors"]
            else:
                ext = v.max(0) - v.min(0)
                colors[i, : len(v)] = (v - v.min(0)) / np.maximum(ext, 1e-8)
            if "normals" in m:
                normals[i, : len(v)] = m["normals"]
            else:
                normals[i, : len(v)] = compute_vertex_normals(
                    torch.as_tensor(v, dtype=torch.float32),
                    torch.as_tensor(f)).numpy()
            idx = farthest_point_sampling(v, min(n_regions, len(v)))
            fps_pts[i, : len(idx)] = v[idx]
            idx2 = farthest_point_sampling(v, min(n_points, len(v)))
            pm_pts[i] = v[np.resize(idx2, n_points)]
            extents[i] = v.max(0) - v.min(0)
            diam[i] = np.linalg.norm(extents[i])
            if models_info is not None and names[i] in models_info:
                sr, sv = sym_rotations_from_info(models_info[names[i]], max_sym)
                srots[i], svalid[i] = sr, sv
            elif names[i] in sym_names:
                # default: 180° z-flip symmetry (eggbox/glue style)
                srots[i, 1] = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
                svalid[i, 1] = True

        uvs = textures = None
        if any("uv" in m and "texture" in m for m in meshes):
            # atlases padded to a common size; UVs pre-scaled so that
            # sampling the shared (Ht, Wt) lands on each atlas's own texels
            ht = max(m["texture"].shape[0] for m in meshes if "texture" in m)
            wt = max(m["texture"].shape[1] for m in meshes if "texture" in m)
            uvs = np.zeros((C, max_v, 2), np.float32)
            textures = np.zeros((C, ht, wt, 3), np.float32)
            for i, m in enumerate(meshes):
                if "uv" not in m or "texture" not in m:
                    continue
                tex = m["texture"]
                textures[i, : tex.shape[0], : tex.shape[1]] = tex
                u = m["uv"][:, 0] * (tex.shape[1] - 1) / max(wt - 1, 1)
                # BOP texture_v is bottom-up; image rows are top-down
                v = (1.0 - m["uv"][:, 1]) * (tex.shape[0] - 1) / max(ht - 1, 1)
                uvs[i, : len(u)] = np.stack([u, v], axis=1)
        return cls(list(names), verts, faces, colors, normals, fps_pts,
                   pm_pts, extents, diam, srots, svalid, uvs, textures)

    @classmethod
    def from_ply_files(cls, names, paths, scale: float = 1e-3, **kw):
        """BOP PLY models (mm, scaled by `scale`), with the PNG texture a
        PLY names beside it, read or raised on (never skipped)."""
        meshes = []
        for p in paths:
            m = load_ply(p)
            m["verts"] = m["verts"] * scale
            tf = m.pop("texture_file", None)
            if tf is not None:
                tp = os.path.join(os.path.dirname(p), tf)
                m["texture"] = (imread(tp, "color") / 255.0).astype(np.float32)
            meshes.append(m)
        return cls.from_meshes(list(names), meshes, **kw)


class GDRNDataset:
    """Fixed-shape GDRN batches from BOP records, augmented and sampled
    when train.

    device: where the label renders run (CUDA by default); impl: their
    fine stage, 'kernel' (B1 on the card) or 'plain'. bg_images: float32
    (H, W, 3) backgrounds for the replacement at cfg.data.bg_replace_prob
    (train only). `timings` collects, per assembled batch, the host
    seconds of its samples (read, augmentation, crop, labels) and of its
    label render (included in the former)."""

    def __init__(self, cfg: Config, records: list[Record],
                 models: ObjectModels, meta: DatasetMeta,
                 train: bool = False, seed: int = 0, device=None,
                 impl: str = "kernel",
                 bg_images: list[np.ndarray] | None = None):
        if impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl: {impl!r}")
        self.cfg = cfg
        self.records = records
        self.models = models
        self.meta = meta
        self.train = train
        self.bg_images = bg_images or []
        self.device = resolve_device(device)
        self.impl = impl
        self.rng = np.random.default_rng(seed)
        self.index: list[tuple[int, int]] = [
            (ri, ii) for ri, r in enumerate(records)
            for ii in range(len(r.instances))
        ]
        self._coord2d_cache: dict[tuple, np.ndarray] = {}
        # VSD needs the observed full-frame depth for its visibility masks;
        # it stays on the host (evaluator.HOST_ONLY_KEYS)
        self.emit_full_depth = (not train) and "vsd" in cfg.test.error_types
        # per-sample child generators for the thread pool, spawned serially
        # in make_samples as the JAX package spawns them
        self._seed_seq = np.random.SeedSequence(seed + 0x5EED)
        # (ri, ii) -> (attr float16 (S,S,C), mask bool, center_c, side_c)
        self._label_cache: "OrderedDict[tuple[int, int], tuple]" = \
            OrderedDict()
        self._mesh_tensors = None
        self.timings: list[dict[str, float]] = []
        self._render_s = 0.0

    def __len__(self):
        return len(self.index)

    # ------------------------------------------------------------------
    def _load_image(self, rec: Record) -> np.ndarray:
        return imread(rec.file_name, "color").astype(np.float32) / 255.0

    def _load_mask(self, path: str | None, shape) -> np.ndarray:
        if path is None or not os.path.exists(path):
            return np.ones(shape[:2], np.float32)
        return (imread(path, "gray") > 0).astype(np.float32)

    def _load_depth(self, rec: Record) -> np.ndarray | None:
        if rec.depth_file is None or not os.path.exists(rec.depth_file):
            return None
        d = imread(rec.depth_file, "unchanged")
        return d.astype(np.float32) * rec.depth_scale / 1000.0

    # ------------------------------------------------------------------
    def _sample_host(self, ri: int, ii: int,
                     rng: np.random.Generator | None = None
                     ) -> dict[str, np.ndarray]:
        """The host part of one sample (read, augmentation when train,
        crops, SITE targets); the rendered labels are filled per batch by
        _finish_samples."""
        cfg = self.cfg
        rng = rng if rng is not None else self.rng
        rec = self.records[ri]
        inst = rec.instances[ii]
        meta = self.meta
        s_in = cfg.model.input_res
        s_out = cfg.model.output_res

        img = self._load_image(rec)
        im_h, im_w = img.shape[:2]
        cls_idx = meta.objects.index(meta.id2obj[inst.obj_id])

        mask_visib = self._load_mask(inst.mask_visib_path, img.shape)
        mask_full = self._load_mask(inst.mask_full_path, img.shape)

        if self.train and self.bg_images and \
                rng.random() < cfg.data.bg_replace_prob:
            bg = self.bg_images[rng.integers(len(self.bg_images))]
            img = replace_bg(img, mask_full, bg,
                             truncate_fg=cfg.data.truncate_fg, rng=rng)
        if self.train and cfg.data.color_aug_prob > 0:
            img = color_aug(img, rng, cfg.data.color_aug_prob)

        bbox = inst.bbox_visib
        dzi = cfg.data.dzi if self.train else \
            type(cfg.data.dzi)(type="none", pad_scale=cfg.data.dzi.pad_scale)
        center, scale = aug_bbox_dzi(dzi, bbox, im_h, im_w, rng)

        roi_img = crop_resize_by_warp_affine(img, center, scale, s_in)
        m_visib = crop_resize_by_warp_affine(mask_visib, center, scale, s_out,
                                             interpolation="nearest")
        m_full = crop_resize_by_warp_affine(mask_full, center, scale, s_out,
                                            interpolation="nearest")

        key = (im_w, im_h)
        if key not in self._coord2d_cache:
            self._coord2d_cache[key] = get_2d_coord(im_w, im_h)
        coord2d = crop_resize_by_warp_affine(
            self._coord2d_cache[key], center, scale, s_out)

        R, t = inst.R, inst.t

        roi_depth = None
        if cfg.data.with_depth:
            depth = self._load_depth(rec)
            if depth is None:
                depth = np.zeros(img.shape[:2], np.float32)
            if self.train and cfg.data.depth_aug_prob > 0 and \
                    rng.random() < cfg.data.depth_aug_prob:
                depth = add_noise_depth(depth, rng,
                                        level=cfg.data.depth_aug_level)
            roi_depth = crop_resize_by_warp_affine(
                depth, center, scale, s_in, interpolation="nearest")

        # SITE targets
        obj_center = rec.K @ t
        obj_center = obj_center[:2] / obj_center[2]
        bw = max(bbox[2] - bbox[0], 1.0)
        bh = max(bbox[3] - bbox[1], 1.0)
        resize_ratio = s_out / scale
        trans_ratio = np.array([
            (obj_center[0] - center[0]) / bw,
            (obj_center[1] - center[1]) / bh,
            t[2] / resize_ratio], np.float32)

        sample = {
            "roi_img": roi_img.astype(np.float32),
            "roi_cls": np.int32(cls_idx),
            "roi_cam": rec.K.astype(np.float32),
            "roi_center": center.astype(np.float32),
            "roi_wh": np.array([bw, bh], np.float32),
            "roi_extent": self.models.extents[cls_idx],
            "resize_ratio": np.float32(resize_ratio),
            "roi_coord_2d": coord2d.astype(np.float32),
            "gt_mask_visib": m_visib.astype(np.float32),
            "gt_mask_full": m_full.astype(np.float32),
            "gt_rot": R.astype(np.float32),
            "gt_trans": t.astype(np.float32),
            "gt_trans_ratio": trans_ratio,
            "gt_points": self.models.pm_points[cls_idx],
            "sym_rots": self.models.sym_rots[cls_idx],
            "sym_valid": self.models.sym_valid[cls_idx],
            "scene_im_id_scene": np.int32(rec.scene_id),
            "scene_im_id_im": np.int32(rec.im_id),
            "obj_id": np.int32(inst.obj_id),
            "score": np.float32(inst.score),
            # render-job fields consumed by _finish_samples
            "_scale": np.float32(scale),
            "_bbox": np.asarray(bbox, np.float32),
        }
        if roi_depth is not None:
            sample["roi_depth"] = roi_depth.astype(np.float32)
        if self.emit_full_depth:
            full = self._load_depth(rec)
            sample["full_depth"] = (
                np.zeros(img.shape[:2], np.float32) if full is None
                else full.astype(np.float32))
        if inst.pose_est is not None:
            sample["pose_est_rot"] = inst.pose_est[:, :3].astype(np.float32)
            sample["pose_est_trans"] = inst.pose_est[:, 3].astype(np.float32)
        if inst.pose_refine is not None:
            sample["pseudo_rot"] = inst.pose_refine[:, :3].astype(np.float32)
            sample["pseudo_trans"] = inst.pose_refine[:, 3].astype(np.float32)
        return sample

    # ------------------------------------------------------------------
    def _batched_render(self, cls, K, R, t, center, scale, out_res: int,
                        with_normals: bool):
        """One rasterizer call for the batch on the dataset's device: the
        square crops (center, side scale) at out_res², tile 8, K 64, hard.
        Returns host (attr (B,o,o,3|6), mask (B,o,o))."""
        from ..ops.rasterizer import rasterize_batch
        from ..ops.zoom import zoom_K
        t0 = time.perf_counter()
        dev = self.device
        if self._mesh_tensors is None:
            self._mesh_tensors = tuple(
                torch.as_tensor(x, device=dev) for x in
                (self.models.verts, self.models.faces, self.models.normals))
        verts, faces, normals = self._mesh_tensors
        ci = torch.as_tensor(np.asarray(cls), dtype=torch.long, device=dev)
        v = verts[ci]
        a = torch.cat([v, normals[ci]], dim=-1) if with_normals else v
        x1 = center[:, 0] - scale / 2
        y1 = center[:, 1] - scale / 2
        boxes = np.stack([x1, y1, x1 + scale, y1 + scale], axis=1)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        Kz = zoom_K(f32(K), f32(boxes), (out_res, out_res))
        out = rasterize_batch(v, faces[ci], a, Kz, f32(R), f32(t),
                              height=out_res, width=out_res, tile_px=8,
                              faces_per_tile=64, with_prob=False,
                              impl=self.impl, device=dev)
        attr, mask = out.attr.cpu().numpy(), out.mask.cpu().numpy()
        self._render_s += time.perf_counter() - t0
        return attr, mask

    def _cache_frame(self, bbox: np.ndarray) -> tuple[np.ndarray, float]:
        """(center, side) of the per-instance cached render frame: a square
        that covers every DZI-jittered crop of this bbox."""
        dzi = self.cfg.data.dzi
        cx, cy = 0.5 * (bbox[0] + bbox[2]), 0.5 * (bbox[1] + bbox[3])
        b = max(bbox[2] - bbox[0], bbox[3] - bbox[1], 1.0)
        cover = dzi.pad_scale * (1.0 + dzi.scale_ratio) + 2 * dzi.shift_ratio
        return np.array([cx, cy], np.float32), float(b * cover)

    def _labels_from_cache(self, keys, samples, s_out: int,
                           with_normals: bool):
        """Misses rendered once (batched, padded to the batch size) in the
        instance's cache frame at label_cache_res, then every crop warped
        from the cache with nearest sampling."""
        cfg = self.cfg
        S = cfg.data.label_cache_res or 2 * s_out
        cache = self._label_cache

        miss = [i for i, k in enumerate(keys) if k not in cache]
        if miss:
            pad = miss + [miss[0]] * (len(samples) - len(miss))
            cls = np.asarray([samples[i]["roi_cls"] for i in pad])
            K = np.stack([samples[i]["roi_cam"] for i in pad])
            R = np.stack([samples[i]["gt_rot"] for i in pad])
            t = np.stack([samples[i]["gt_trans"] for i in pad])
            frames = [self._cache_frame(samples[i]["_bbox"]) for i in pad]
            c_c = np.stack([f[0] for f in frames])
            s_c = np.asarray([f[1] for f in frames], np.float32)
            attr, m = self._batched_render(cls, K, R, t, c_c, s_c, S,
                                           with_normals)
            for j, i in enumerate(miss):
                cache[keys[i]] = (attr[j].astype(np.float16),
                                  m[j] > 0, c_c[j], float(s_c[j]))
            while len(cache) > cfg.data.label_cache_entries:
                cache.popitem(last=False)

        attr_out = np.zeros((len(samples), s_out, s_out,
                             6 if with_normals else 3), np.float32)
        mask_out = np.zeros((len(samples), s_out, s_out), np.float32)
        for i, (k, s) in enumerate(zip(keys, samples)):
            a16, m8, c_c, side_c = cache[k]
            cache.move_to_end(k)
            center, scale = s["roi_center"], float(s["_scale"])
            # dst->src affine between the two square-crop frames
            # (crop pixel u <-> image x: u = x*s + tx, aug.get_affine_transform)
            sc, st = S / side_c, s_out / scale
            a = sc / st
            tx = s_out / 2.0 - center[0] * st
            ty = s_out / 2.0 - center[1] * st
            txc = S / 2.0 - c_c[0] * sc
            tyc = S / 2.0 - c_c[1] * sc
            M = np.array([[a, 0, txc - tx * a], [0, a, tyc - ty * a]],
                         np.float64)
            attr_out[i] = warp_affine(a16.astype(np.float32), M,
                                      (s_out, s_out), "nearest", True)
            mask_out[i] = warp_affine(m8.astype(np.float32), M,
                                      (s_out, s_out), "nearest", True)
        return attr_out, mask_out

    def _finish_samples(self, samples: list[dict],
                        keys: list[tuple[int, int]]) -> list[dict]:
        """Fill the rendered labels (xyz, region, object mask, vf, normals)
        from the label cache (or one batched render of the crops)."""
        cfg = self.cfg
        gh = cfg.model.geo_head
        s_out = cfg.model.output_res
        cls = np.asarray([s["roi_cls"] for s in samples])
        K = np.stack([s["roi_cam"] for s in samples])
        R = np.stack([s["gt_rot"] for s in samples])
        t = np.stack([s["gt_trans"] for s in samples])
        center = np.stack([s["roi_center"] for s in samples])
        scale = np.asarray([s["_scale"] for s in samples])

        if cfg.data.label_cache:
            attr, m_obj = self._labels_from_cache(keys, samples, s_out,
                                                  gh.with_norm)
        else:
            attr, m_obj = self._batched_render(cls, K, R, t, center, scale,
                                               s_out, gh.with_norm)
        for s in samples:
            s.pop("_scale"), s.pop("_bbox")
        xyz_obj = attr[..., :3]                              # (B,o,o,3)
        m_visib = np.stack([s["gt_mask_visib"] for s in samples])
        ext = np.maximum(self.models.extents[cls], 1e-8)     # (B,3)
        xyz_norm = np.where(
            m_obj[..., None] > 0,
            xyz_obj / ext[:, None, None] + 0.5, 0.0).astype(np.float32)
        xyz_bin = np.clip((xyz_norm * gh.xyz_bin).astype(np.int32), 0,
                          gh.xyz_bin - 1)
        region = xyz_to_region_batch(
            xyz_obj, self.models.fps_points[cls],
            m_obj * m_visib if self.train else m_obj).astype(np.int32)
        trunc = (m_visib * m_obj).astype(np.float32)
        if gh.with_vf:
            f = gh.num_vf_points
            fpsb = self.models.fps_points[cls][:, :f]
            vf_vis = compute_vf_np_batch(fpsb, K, R, t, center, scale,
                                         s_out, m_visib * m_obj)
            vf_full = compute_vf_np_batch(fpsb, K, R, t, center, scale,
                                          s_out, m_obj)
        if gh.with_norm:
            n_cam = np.einsum("bhwc,bdc->bhwd", attr[..., 3:6], R)
            n_cam /= np.maximum(
                np.linalg.norm(n_cam, axis=-1, keepdims=True), 1e-8)
            norm_b = (n_cam * m_obj[..., None]).astype(np.float32)
        for i, s in enumerate(samples):
            s["gt_xyz"] = xyz_norm[i]
            s["gt_xyz_bin"] = xyz_bin[i]
            s["gt_mask_trunc"] = trunc[i]
            s["gt_mask_obj"] = m_obj[i].astype(np.float32)
            s["gt_region"] = region[i]
            if gh.with_vf:
                s["gt_vf_vis"] = vf_vis[i]
                s["gt_vf_full"] = vf_full[i]
            if gh.with_norm:
                s["gt_norm"] = norm_b[i]
        return samples

    def make_samples(self, keys: list[tuple[int, int]],
                     pool=None) -> list[dict[str, np.ndarray]]:
        if pool is not None:
            # deterministic child generators, spawned serially here
            rngs = [np.random.default_rng(s)
                    for s in self._seed_seq.spawn(len(keys))]
            partials = list(pool.map(
                lambda kr: self._sample_host(kr[0][0], kr[0][1], rng=kr[1]),
                zip(keys, rngs)))
        else:
            partials = [self._sample_host(ri, ii) for ri, ii in keys]
        return self._finish_samples(partials, keys)

    # ------------------------------------------------------------------
    def _index_sampler(self, n: int) -> Iterator[int]:
        """The training index stream of cfg.data.sampler ('training',
        'repeat_factor' by object frequency, 'inf_subset'), seeded by one
        draw of the dataset's generator."""
        name = self.cfg.data.sampler
        seed = int(self.rng.integers(2 ** 31))
        if name == "training":
            return training_sampler(n, seed=seed)
        if name == "repeat_factor":
            cats = np.asarray([self.records[ri].instances[ii].obj_id
                               for ri, ii in self.index])
            rf = repeat_factors_from_category_frequency(
                cats, self.cfg.data.repeat_thresh)
            return repeat_factor_sampler(rf, seed=seed)
        if name == "inf_subset":
            return infinite_subset_random_sampler(
                n, self.cfg.data.subset_ratio, seed=seed)
        raise ValueError(f"unknown sampler: {name}")

    def batches(self, batch_size: int, infinite: bool | None = None,
                num_workers: int | None = None, prefetch: int | None = None
                ) -> Iterator[dict[str, np.ndarray]]:
        """Sampled batches without end (infinite, the default for train),
        or one sequential epoch with the last batch padded by copies of its
        last sample and flagged by `_valid` (1 real, 0 padding).

        num_workers > 0 runs the per-sample host work on a thread pool and
        builds batches ahead on a background thread (`prefetch` of them);
        the label render then runs on that thread too."""
        infinite = self.train if infinite is None else infinite
        num_workers = (self.cfg.data.num_workers if num_workers is None
                       else num_workers)
        prefetch = (self.cfg.data.prefetch if prefetch is None else prefetch)
        n = len(self.index)

        pool = None
        if num_workers and num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=num_workers)

        def timed(keys: list[tuple[int, int]], pad: int = 0):
            t0, r0 = time.perf_counter(), self._render_s
            samples = self.make_samples(keys, pool=pool)
            batch = self._collate(samples + [samples[-1]] * pad)
            self.timings.append({"host_s": time.perf_counter() - t0,
                                 "label_render_s": self._render_s - r0})
            return batch

        def gen():
            try:
                if infinite:
                    # data rank r of W takes the stream's [r::W] (every
                    # rank draws the same stream: data parallel, parallel/
                    # dist.py). The data index, not the rank: under a rank
                    # grid the ranks of one fsdp group take the same
                    # records, as the JAX batch sharding P(data) gives them
                    # (parallel/mesh.py)
                    stream = process_shard(self._index_sampler(n),
                                           data_rank(), data_size())
                    while True:
                        yield timed([self.index[next(stream)]
                                     for _ in range(batch_size)])
                else:
                    order = list(inference_sampler(n))
                    for i in range(0, n, batch_size):
                        keys = [self.index[j] for j in order[i:i + batch_size]]
                        pad = batch_size - len(keys)
                        batch = timed(keys, pad)
                        batch["_valid"] = np.array(
                            [1] * len(keys) + [0] * pad, np.int32)
                        yield batch
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)

        if pool is None or prefetch <= 0:
            return gen()
        return _prefetch_iterator(gen(), prefetch)

    @staticmethod
    def _collate(samples: list[dict]) -> dict[str, np.ndarray]:
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _prefetch_iterator(it: Iterator, depth: int) -> Iterator:
    """Background-thread prefetch of up to `depth` ready batches. The
    producer stops when the consumer generator is closed or collected; an
    exception in the producer is raised in the consumer after the batches
    built before it."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    errors: list[BaseException] = []
    _END = object()

    def work():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:          # handed to the consumer
            errors.append(e)
        finally:
            stop.set()
            try:
                q.put_nowait(_END)
            except queue.Full:
                pass

    threading.Thread(target=work, daemon=True).start()
    try:
        while True:
            try:
                item = q.get(timeout=0.2)
            except queue.Empty:
                if stop.is_set() and q.empty():
                    break
                continue
            if item is _END:
                break
            yield item
        if errors:
            raise errors[0]
    finally:
        stop.set()
