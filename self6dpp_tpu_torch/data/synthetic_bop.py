"""A miniature BOP-format dataset rendered by the port (port of
tools/make_synthetic_bop.py: generate, generate_full): scene_gt,
scene_camera and scene_gt_info jsons, rgb / depth / mask / mask_visib
PNGs (data/image_io.py), the 'synthetic' meta of data/ref.py (2 objects,
160x120 frames). Every object of every image is one render
(ops/rasterizer.py::rasterize_single, tile 8, K 64: kernel B1 on the card
with impl="kernel"), drawn from `seed` as the JAX tool draws.

    python -m self6dpp_tpu_torch.data.synthetic_bop ROOT [--full]
        [--images N] [--device cpu] [--impl plain]
"""

from __future__ import annotations

import json
import os

import numpy as np

from .image_io import write_png


def generate(root: str, n_scenes: int = 1, n_images: int = 4,
             objects: tuple[str, ...] = ("ape", "can"), seed: int = 0,
             width: int = 160, height: int = 120, device=None,
             impl: str = "kernel") -> str:
    """Write <root>/test/<scene>/... and return that split's directory.
    Renders on `device` (CUDA by default) with the fine stage `impl`."""
    from scipy.spatial.transform import Rotation

    from .. import resolve_device
    from ..ops.rasterizer import rasterize_single
    from .meshes import make_cube, make_icosphere

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K = np.array([[160.0, 0, width / 2], [0, 160.0, height / 2], [0, 0, 1]],
                 dtype=np.float32)

    meshes = []
    for i, name in enumerate(objects):
        if i % 2 == 0:
            v, f = make_cube(size=0.12)
        else:
            v, f = make_icosphere(radius=0.07, subdivisions=2)
        meshes.append((v, f))

    split = os.path.join(root, "test")
    for s in range(n_scenes):
        sdir = os.path.join(split, f"{s:06d}")
        for sub in ("rgb", "depth", "mask", "mask_visib"):
            os.makedirs(os.path.join(sdir, sub), exist_ok=True)
        scene_gt, scene_cam, scene_info = {}, {}, {}
        for im in range(n_images):
            rgb = np.zeros((height, width, 3), np.float32)
            rgb += rng.uniform(0, 0.3, (height, width, 3))       # noise bg
            depth = np.zeros((height, width), np.float32)
            gts, infos = [], []
            for oi, (v, f) in enumerate(meshes):
                R = Rotation.random(random_state=int(rng.integers(1 << 30))
                                    ).as_matrix().astype(np.float32)
                t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.08, 0.08),
                              rng.uniform(0.6, 0.9)], np.float32)
                colors = (v - v.min(0)) / np.ptp(v, 0)
                # hard render: the JAX tool's silhouette is never read
                out = rasterize_single(v, f, colors, K, R, t, height=height,
                                       width=width, tile_px=8,
                                       faces_per_tile=64, with_prob=False,
                                       impl=impl, device=dev)
                m = out.mask.cpu().numpy()
                d = out.depth.cpu().numpy()
                c = out.attr.cpu().numpy()
                # nearer-object-wins composite
                closer = (d > 0) & ((depth == 0) | (d < depth))
                vis = closer
                rgb = np.where(vis[..., None], c, rgb)
                depth = np.where(closer, d, depth)
                ys, xs = np.nonzero(m)
                if len(ys) == 0:
                    continue
                bbox_obj = [int(xs.min()), int(ys.min()),
                            int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]
                ysv, xsv = np.nonzero(vis)
                bbox_vis = [int(xsv.min()), int(ysv.min()),
                            int(xsv.max() - xsv.min() + 1),
                            int(ysv.max() - ysv.min() + 1)] if len(ysv) else bbox_obj
                gi = len(gts)
                write_png(os.path.join(sdir, "mask", f"{im:06d}_{gi:06d}.png"),
                          (m * 255).astype(np.uint8))
                write_png(os.path.join(sdir, "mask_visib",
                                       f"{im:06d}_{gi:06d}.png"),
                          (vis * 255).astype(np.uint8))
                gts.append({"obj_id": oi + 1,
                            "cam_R_m2c": R.reshape(-1).tolist(),
                            "cam_t_m2c": (t * 1000).tolist()})
                infos.append({"bbox_obj": bbox_obj, "bbox_visib": bbox_vis,
                              "visib_fract": float(vis.sum() / max(m.sum(), 1))})
            write_png(os.path.join(sdir, "rgb", f"{im:06d}.png"),
                      (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            write_png(os.path.join(sdir, "depth", f"{im:06d}.png"),
                      (depth * 1000).astype(np.uint16))
            scene_gt[str(im)] = gts
            scene_cam[str(im)] = {"cam_K": K.reshape(-1).tolist(),
                                  "depth_scale": 1.0}
            scene_info[str(im)] = infos
        with open(os.path.join(sdir, "scene_gt.json"), "w") as fp:
            json.dump(scene_gt, fp)
        with open(os.path.join(sdir, "scene_camera.json"), "w") as fp:
            json.dump(scene_cam, fp)
        with open(os.path.join(sdir, "scene_gt_info.json"), "w") as fp:
            json.dump(scene_info, fp)
    return split


def generate_full(root: str, n_scenes: int = 1, n_images: int = 6,
                  seed: int = 0, device=None, impl: str = "kernel") -> dict:
    """The layout the eval CLIs read with the 'synthetic' meta:
    <root>/lm/{train,test,models} and a GT-box detection json."""
    import shutil

    from .bop import load_bop_split, save_detections
    from .meshes import make_cube, make_icosphere, save_ply

    base = os.path.join(root, "lm")
    test = generate(base, n_scenes=n_scenes, n_images=n_images, seed=seed,
                    device=device, impl=impl)
    train = os.path.join(base, "train")
    if not os.path.exists(train):
        shutil.copytree(test, train)

    mdir = os.path.join(base, "models")
    os.makedirs(mdir, exist_ok=True)
    for i, (mk, kw) in enumerate(
            [(make_cube, {"size": 0.12}),
             (make_icosphere, {"radius": 0.07, "subdivisions": 2})]):
        v, f = mk(**kw)
        save_ply(os.path.join(mdir, f"obj_{i + 1:06d}.ply"), v * 1000.0, f)

    dets = {}
    for r in load_bop_split(test):
        dets[r.scene_im_id] = [{
            "obj_id": inst.obj_id,
            "bbox_est": [float(inst.bbox_visib[0]), float(inst.bbox_visib[1]),
                         float(inst.bbox_visib[2] - inst.bbox_visib[0]),
                         float(inst.bbox_visib[3] - inst.bbox_visib[1])],
            "score": 1.0,
        } for inst in r.instances]
    det_path = os.path.join(base, "gt_dets.json")
    save_detections(det_path, dets)
    return {"root": root, "train": train, "test": test, "models": mdir,
            "dets": det_path}


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default="datasets/synthetic_bop")
    ap.add_argument("--full", action="store_true",
                    help="lm layout: train, test, models, GT detections")
    ap.add_argument("--images", type=int, default=6)
    ap.add_argument("--device", default=None)
    ap.add_argument("--impl", default="kernel", choices=("kernel", "plain"))
    a = ap.parse_args()
    kw = dict(n_images=a.images, device=a.device, impl=a.impl)
    print("wrote", generate_full(a.root, **kw) if a.full
          else generate(a.root, **kw))
