"""Evaluation: the inference loop, the per-object recall tables (ADD(-S),
rotation and translation, projection, and with bop19 the BOP19 VSD / MSSD /
MSPD average recalls), BOP CSV export and import, and the test-time PnP
from the predicted xyz map and mask (port of
self6dpp_tpu/engine/evaluator.py).

The errors of all instances of an object are computed in one batched call
on the evaluator's device (ops/pose_errors.py); VSD renders the estimated
and the ground-truth depth full-frame through ops/rasterizer.py (kernel B1
on the card with impl="kernel": tile 16, K 128, hard).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Callable, Iterable

import numpy as np
import torch

from .. import resolve_device
from ..data.loader import ObjectModels
from ..data.ref import DatasetMeta
from ..ops import pnp as PNP
from ..ops import pose_errors as PE

# batch keys the evaluator reads on the host that never go to the device
# (the full-frame observed depth would waste the transfer)
HOST_ONLY_KEYS = ("_valid", "full_depth")


def bop_csv_rows(results: list[dict]) -> str:
    """results: dicts with scene_id, im_id, obj_id, score, R (3,3), t (3,) m,
    time. Returns csv text (BOP19 format: R row-major, t in mm)."""
    lines = ["scene_id,im_id,obj_id,score,R,t,time"]
    for r in results:
        R = " ".join(f"{x:.8f}" for x in np.asarray(r["R"]).reshape(-1))
        t = " ".join(f"{x:.8f}" for x in np.asarray(r["t"]).reshape(-1) * 1000.0)
        lines.append(
            f"{r['scene_id']},{r['im_id']},{r['obj_id']},{r.get('score', 1.0):.8f},"
            f"{R},{t},{r.get('time', -1.0):.8f}")
    return "\n".join(lines) + "\n"


def save_bop_csv(path: str, results: list[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(bop_csv_rows(results))


def load_bop_csv(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        f.readline()
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 6:
                continue
            out.append({
                "scene_id": int(parts[0]), "im_id": int(parts[1]),
                "obj_id": int(parts[2]), "score": float(parts[3]),
                "R": np.array(parts[4].split(), np.float64).reshape(3, 3),
                "t": np.array(parts[5].split(), np.float64) / 1000.0,
                "time": float(parts[6]) if len(parts) > 6 else -1.0,
            })
    return out


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x)


class PoseEvaluator:
    """Collects per-instance predictions and computes recall tables per
    object, on `device` (CUDA by default) with the VSD renders' fine stage
    `impl` ('kernel' or 'plain')."""

    def __init__(self, models: ObjectModels, meta: DatasetMeta,
                 n_error_points: int = 512, device=None,
                 impl: str = "kernel"):
        if impl not in ("kernel", "plain"):
            raise ValueError(f"unknown impl: {impl!r}")
        self.models = models
        self.meta = meta
        self.preds: dict[int, list[dict]] = defaultdict(list)
        self.n_pts = n_error_points
        self.device = resolve_device(device)
        self.impl = impl

    def process(self, batch: dict, output: dict) -> None:
        """batch: host arrays with roi_cls, the ground truth and the ids;
        output: rot (B,3,3), trans (B,3) [and a 'time' scalar]."""
        rot = _host(output["rot"])
        trans = _host(output["trans"])
        valid = np.asarray(batch.get("_valid", np.ones(len(rot), np.int32)))
        for i in range(len(rot)):
            if not valid[i]:
                continue
            cls = int(batch["roi_cls"][i])
            self.preds[cls].append({
                "R": rot[i], "t": trans[i],
                "R_gt": np.asarray(batch["gt_rot"][i]),
                "t_gt": np.asarray(batch["gt_trans"][i]),
                "K": np.asarray(batch["roi_cam"][i]),
                "scene_id": int(batch.get("scene_im_id_scene", [0] * len(rot))[i]),
                "im_id": int(batch.get("scene_im_id_im", [0] * len(rot))[i]),
                "obj_id": int(batch.get("obj_id", [0] * len(rot))[i]),
                "score": float(batch.get("score", [1.0] * len(rot))[i]),
                "time": float(output.get("time", -1.0)),
                # the observed full-frame depth for VSD's visibility, when
                # the loader gives it (zeros otherwise: every rendered
                # pixel then counts visible)
                "depth_obs": (np.asarray(batch["full_depth"][i])
                              if "full_depth" in batch else None),
            })

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def evaluate(self, bop19: bool = False, vsd_chunk: int = 16,
                 vsd_scale: float = 1.0) -> dict[str, dict[str, float]]:
        """{obj_name: recall_table} and 'avg'. bop19=True adds the BOP19
        ar_vsd / ar_mssd / ar_mspd / bop19_ar columns (VSD on full-frame
        hard renders, MSSD/MSPD over the object's symmetry set)."""
        tables: dict[str, dict[str, float]] = {}
        for cls, preds in sorted(self.preds.items()):
            name = self.models.names[cls]
            pts = self.models.pm_points[cls][: self.n_pts]
            diam = float(self.models.diameters[cls])
            n = len(preds)
            R_est = self._t(np.stack([p["R"] for p in preds]))
            t_est = self._t(np.stack([p["t"] for p in preds]))
            R_gt = self._t(np.stack([p["R_gt"] for p in preds]))
            t_gt = self._t(np.stack([p["t_gt"] for p in preds]))
            K = self._t(np.stack([p["K"] for p in preds]))
            P = self._t(pts)[None].expand(n, *pts.shape)
            is_sym = self.meta.is_sym(name) if name in self.meta.objects else False
            add = _host(PE.add_or_adi_error(
                R_est, t_est, R_gt, t_gt, P, self._t([is_sym] * n, torch.bool)))
            re = _host(PE.re_error(R_est, R_gt))
            te = _host(PE.te_error(t_est, t_gt))
            proj = _host(PE.proj_error(R_est, t_est, R_gt, t_gt, K, P))
            tables[name] = PE.recall_table(add, re, te, proj, diam)
            tables[name]["auc_add"] = PE.auc_add(add)
            if bop19:
                sym_r = self._t(self.models.sym_rots[cls])[None].expand(
                    n, *self.models.sym_rots[cls].shape)
                sym_v = self._t(self.models.sym_valid[cls], torch.bool)[None] \
                    .expand(n, *self.models.sym_valid[cls].shape)
                mssd = _host(PE.mssd_error(
                    R_est, t_est, R_gt, t_gt, P, sym_r, sym_v))
                mspd = _host(PE.mspd_error(
                    R_est, t_est, R_gt, t_gt, K, P, sym_r, sym_v))
                vsd = self._vsd_errors(cls, preds, chunk=vsd_chunk,
                                       scale=vsd_scale)
                tables[name].update(PE.bop19_average_recalls(
                    vsd, mssd, mspd, diam, self.meta.width))
            tables[name]["n"] = n
        if tables:
            keys = next(iter(tables.values())).keys()
            tables["avg"] = {
                k: float(np.mean([t[k] for t in tables.values()])) for k in keys}
        return tables

    def _vsd_errors(self, cls: int, preds: list[dict], chunk: int = 16,
                    delta: float = 0.015, scale: float = 1.0) -> np.ndarray:
        """Per-prediction BOP19 VSD errors (N, 10), taus = BOP19_TH fractions
        of the diameter. The estimated and ground-truth depths are hard
        renders of the full frame (rasterize_batch: tile 16, K 128), `chunk`
        predictions a call; scale < 1 renders a uniformly scaled frame (an
        approximation; the toolkit is scale 1)."""
        from ..ops.rasterizer import rasterize_batch
        H = max(1, int(round(self.meta.height * scale)))
        W = max(1, int(round(self.meta.width * scale)))
        verts = self._t(self.models.verts[cls])
        faces = torch.as_tensor(self.models.faces[cls], device=self.device)
        attrs = torch.zeros_like(verts)
        diam = float(self.models.diameters[cls])
        kw = dict(height=H, width=W, tile_px=16, faces_per_tile=128,
                  with_prob=False, impl=self.impl, device=self.device)
        out = []
        for i0 in range(0, len(preds), chunk):
            ch = preds[i0:i0 + chunk]
            Kc = self._t(np.stack([p["K"] for p in ch]))
            Re = self._t(np.stack([p["R"] for p in ch]))
            tte = self._t(np.stack([p["t"] for p in ch]))
            Rg = self._t(np.stack([p["R_gt"] for p in ch]))
            tg = self._t(np.stack([p["t_gt"] for p in ch]))
            d_est = rasterize_batch(verts, faces, attrs, Kc, Re, tte,
                                    **kw).depth
            d_gt = rasterize_batch(verts, faces, attrs, Kc, Rg, tg,
                                   **kw).depth
            d_obs = self._t(np.stack([
                _resize_depth_nearest(p["depth_obs"], H, W)
                if p.get("depth_obs") is not None
                else np.zeros((H, W), np.float32) for p in ch]))
            e = PE.vsd_error(d_est, d_gt, d_obs, taus=PE.BOP19_TH,
                             delta=delta, K=Kc, diameter=diam)
            out.append(_host(e))
        return np.concatenate(out, 0) if out else np.zeros((0, len(PE.BOP19_TH)))

    def results_for_csv(self) -> list[dict]:
        return [p for preds in self.preds.values() for p in preds]


def table_to_markdown(tables: dict[str, dict[str, float]],
                      keys=("ad_2", "ad_5", "ad_10", "rete_2", "rete_5",
                            "re_2", "te_2", "proj_2", "proj_5", "re", "te")
                      ) -> str:
    """The per-object metric table as markdown; the BOP19 AR columns are
    appended when evaluate(bop19=True) produced them."""
    if any("bop19_ar" in t for t in tables.values()):
        keys = tuple(keys) + ("ar_vsd", "ar_mssd", "ar_mspd", "bop19_ar")
    lines = ["| obj | " + " | ".join(keys) + " |",
             "|" + "----|" * (len(keys) + 1)]
    for name, tab in tables.items():
        vals = " | ".join(f"{tab.get(k, 0.0):.2f}" for k in keys)
        lines.append(f"| {name} | {vals} |")
    return "\n".join(lines)


def _resize_depth_nearest(d: np.ndarray, H: int, W: int) -> np.ndarray:
    """Nearest-neighbour depth resize (interpolating depth across object
    boundaries would invent surfaces), for VSD at vsd_scale < 1."""
    d = np.asarray(d, np.float32)
    if d.shape == (H, W):
        return d
    ys = (np.arange(H) * d.shape[0] / H).astype(int)
    xs = (np.arange(W) * d.shape[1] / W).astype(int)
    return d[ys[:, None], xs[None, :]]


def to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """The batch's arrays but HOST_ONLY_KEYS as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items() if k not in HOST_ONLY_KEYS}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_inference(eval_fn: Callable[[dict], dict], batches: Iterable[dict],
                  evaluator: PoseEvaluator, to_device_fn=None,
                  device=None) -> PoseEvaluator:
    """The inference loop: eval_fn(device batch) -> {'rot', 'trans'} on each
    batch, fed to the evaluator with the per-image time of the call. The
    first batch also runs once untimed first (warm-up). The clock is read
    after torch.cuda.synchronize() on a CUDA device. evaluator.timings gets
    one {'wait_s', 'step_s'} per batch: the seconds spent waiting for the
    batch and in the timed call."""
    dev = resolve_device(device)
    to_dev = to_device_fn or (lambda b: to_device(b, dev))
    evaluator.timings = []
    warmed = False
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        wait = time.perf_counter() - t0
        db = to_dev(batch)
        if not warmed:
            eval_fn(db)
            _sync(dev)
            warmed = True
        t0 = time.perf_counter()
        out = eval_fn(db)
        _sync(dev)
        dt = time.perf_counter() - t0
        out = {k: _host(v) for k, v in out.items()}
        out["time"] = dt / max(len(next(iter(batch.values()))), 1)
        evaluator.timings.append({"wait_s": wait, "step_s": dt})
        evaluator.process(batch, out)
    return evaluator


# ---------------------------------------------------------------------------
# PnP post-processing (host, test time)
# ---------------------------------------------------------------------------

def pnp_from_xyz_mask(coor: np.ndarray, mask_prob: np.ndarray,
                      extents: np.ndarray, roi_center: np.ndarray,
                      roi_wh_crop: float, K: np.ndarray,
                      mask_thresh: float = 0.5, min_pts: int = 8,
                      ransac: bool = True):
    """Predicted xyz map + mask -> 2D-3D correspondences -> PnP
    (gdrn_evaluator.py's get_img_model_points_with_coords2d + pnp_v2).
    coor (o, o, 3) in [0, 1]; mask_prob (o, o); extents (3,); the ROI's
    centre and side in the frame; K (3, 3). Each pixel above mask_thresh
    gives its centre mapped into the frame and its object point, the
    coordinates denormalised by the extents. ransac: EPnP in RANSAC, then
    EPnP on the inliers (ops/pnp.py::pnp_ransac, its draws from a numpy
    generator seeded 0 on each call); else SOLVEPNP_ITERATIVE
    (pnp_iterative). Returns (R (3, 3), t (3,)) in float32, or None with
    fewer than min_pts pixels or when the solver finds no pose."""
    o = coor.shape[0]
    sel = mask_prob > mask_thresh
    if sel.sum() < min_pts:
        return None
    ys, xs = np.nonzero(sel)
    obj_pts = ((coor[ys, xs] - 0.5) * extents).astype(np.float64)
    scale = roi_wh_crop / o
    x1 = roi_center[0] - roi_wh_crop / 2
    y1 = roi_center[1] - roi_wh_crop / 2
    img_pts = np.stack([x1 + (xs + 0.5) * scale,
                        y1 + (ys + 0.5) * scale], axis=1).astype(np.float64)
    K = np.asarray(K, np.float64)
    if ransac:
        res = PNP.pnp_ransac(obj_pts, img_pts, K, np.random.default_rng(0))
        res = None if res is None else res[:2]
    else:
        res = PNP.pnp_iterative(obj_pts, img_pts, K)
    if res is None:
        return None
    R, t = res
    # through the rotation vector, as the reference returns cv2.Rodrigues
    # of solvePnP's rvec
    R = PNP.rodrigues(PNP.rodrigues_inv(R))
    return R.astype(np.float32), t.reshape(3).astype(np.float32)
