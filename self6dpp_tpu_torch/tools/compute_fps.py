"""FPS keypoints of a BOP model directory (port of tools/compute_fps.py):
for each models/obj_XXXXXX.ply, the farthest-point-sampled vertices
(ops/fps.py::fps_points from the centroid, in metres: BOP models are in
mm), written as fps_points.json keyed by str(obj_id) next to the models
or to --out.

    python -m self6dpp_tpu_torch.tools.compute_fps --model-dir DIR \\
        [--num-points 64] [--out FPS.json]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict[str, list]:
    """Writes the json; returns what it wrote."""
    from ..data.meshes import load_ply
    from ..ops.fps import fps_points

    p = argparse.ArgumentParser()
    p.add_argument("--model-dir", required=True)
    p.add_argument("--num-points", type=int, default=64)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    out: dict[str, list] = {}
    for name in sorted(os.listdir(args.model_dir)):
        if not name.endswith(".ply"):
            continue
        obj_id = int(name.split("_")[-1].split(".")[0])
        mesh = load_ply(os.path.join(args.model_dir, name))
        verts = mesh["verts"] * 1e-3          # mm -> m (BOP)
        pts = fps_points(verts, args.num_points)
        out[str(obj_id)] = pts.tolist()
        print(f"obj {obj_id}: {len(verts)} verts -> {len(pts)} fps points")

    dst = args.out or os.path.join(args.model_dir, "fps_points.json")
    with open(dst, "w") as f:
        json.dump(out, f)
    print("wrote", dst)
    return out


if __name__ == "__main__":
    main()
