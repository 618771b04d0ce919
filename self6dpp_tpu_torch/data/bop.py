"""BOP-format dataset records (Instance, Record) read from the scene
jsons, and the detection json (load, inject into records, save). Host
code, copied from self6dpp_tpu/data/bop.py: poses in metres, boxes stored
x1y1x2y2."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class Instance:
    obj_id: int
    bbox_visib: np.ndarray       # (4,) x1y1wh -> stored as x1y1x2y2
    bbox_obj: np.ndarray
    R: np.ndarray                # (3,3)
    t: np.ndarray                # (3,) metres
    mask_visib_path: str | None = None
    mask_full_path: str | None = None
    visib_fract: float = 1.0
    score: float = 1.0           # detection score (est records)
    pose_est: np.ndarray | None = None     # (3,4) initial estimated pose
    pose_refine: np.ndarray | None = None  # (3,4) refined pseudo pose


@dataclass
class Record:
    file_name: str
    depth_file: str | None
    K: np.ndarray                # (3,3)
    depth_scale: float
    scene_id: int
    im_id: int
    instances: list[Instance]

    @property
    def scene_im_id(self) -> str:
        return f"{self.scene_id}/{self.im_id}"


def _xywh_to_xyxy(b) -> np.ndarray:
    x, y, w, h = b
    return np.array([x, y, x + w, y + h], dtype=np.float32)


def load_bop_scene(scene_dir: str, obj_ids: set[int] | None = None,
                   visib_thresh: float = 0.0) -> list[Record]:
    """Load one BOP scene directory (scene_gt.json + scene_gt_info.json +
    scene_camera.json) into records. Poses converted mm -> m."""
    with open(os.path.join(scene_dir, "scene_gt.json")) as f:
        scene_gt = json.load(f)
    with open(os.path.join(scene_dir, "scene_camera.json")) as f:
        scene_cam = json.load(f)
    info_path = os.path.join(scene_dir, "scene_gt_info.json")
    scene_info = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            scene_info = json.load(f)

    scene_id = int(os.path.basename(scene_dir.rstrip("/")))
    records = []
    for im_id_s, gts in scene_gt.items():
        im_id = int(im_id_s)
        cam = scene_cam[im_id_s]
        K = np.asarray(cam["cam_K"], dtype=np.float32).reshape(3, 3)
        depth_scale = float(cam.get("depth_scale", 1.0))
        rgb = os.path.join(scene_dir, "rgb", f"{im_id:06d}.png")
        if not os.path.exists(rgb):
            rgb = os.path.join(scene_dir, "rgb", f"{im_id:06d}.jpg")
        depth = os.path.join(scene_dir, "depth", f"{im_id:06d}.png")
        infos = scene_info.get(im_id_s, [{}] * len(gts))

        insts = []
        for gi, (gt, gin) in enumerate(zip(gts, infos)):
            oid = int(gt["obj_id"])
            if obj_ids is not None and oid not in obj_ids:
                continue
            vf = float(gin.get("visib_fract", 1.0))
            if vf < visib_thresh:
                continue
            R = np.asarray(gt["cam_R_m2c"], dtype=np.float32).reshape(3, 3)
            t = np.asarray(gt["cam_t_m2c"], dtype=np.float32) / 1000.0
            bb_v = _xywh_to_xyxy(gin["bbox_visib"]) if "bbox_visib" in gin \
                else np.zeros(4, np.float32)
            bb_o = _xywh_to_xyxy(gin["bbox_obj"]) if "bbox_obj" in gin else bb_v
            insts.append(Instance(
                obj_id=oid, bbox_visib=bb_v, bbox_obj=bb_o, R=R, t=t,
                mask_visib_path=os.path.join(
                    scene_dir, "mask_visib", f"{im_id:06d}_{gi:06d}.png"),
                mask_full_path=os.path.join(
                    scene_dir, "mask", f"{im_id:06d}_{gi:06d}.png"),
                visib_fract=vf))
        records.append(Record(file_name=rgb, depth_file=depth, K=K,
                              depth_scale=depth_scale, scene_id=scene_id,
                              im_id=im_id, instances=insts))
    return records


def load_bop_split(split_dir: str, **kw) -> list[Record]:
    """Load all scenes under e.g. <root>/lm/test/ (BOP layout)."""
    records = []
    for scene in sorted(os.listdir(split_dir)):
        sdir = os.path.join(split_dir, scene)
        if os.path.isdir(sdir) and scene.isdigit():
            records.extend(load_bop_scene(sdir, **kw))
    return records


# ---------------------------------------------------------------------------
# detection / pseudo-pose injection (test-time est boxes, stage-II pseudo)
# ---------------------------------------------------------------------------

def load_detections(det_json: str) -> dict[str, list[dict]]:
    """Detection json keyed by 'scene_id/im_id' with entries
    {obj_id, bbox_est [x1,y1,w,h], score, time, [pose_est], [pose_refine]}
    (dataset_utils.py:120 contract)."""
    with open(det_json) as f:
        return json.load(f)


def inject_detections(records: list[Record], dets: dict[str, list[dict]],
                      top_k_per_obj: int = 1, score_thresh: float = 0.0,
                      train_with_pseudo: bool = False) -> list[Record]:
    """Replace each record's instances with detected ones (est boxes; for
    stage-II, est/refined pseudo poses become the training targets)."""
    out = []
    for rec in records:
        key = rec.scene_im_id
        if key not in dets:
            if not train_with_pseudo:
                out.append(Record(rec.file_name, rec.depth_file, rec.K,
                                  rec.depth_scale, rec.scene_id, rec.im_id, []))
            continue
        per_obj: dict[int, list[dict]] = {}
        for d in dets[key]:
            if float(d.get("score", 1.0)) < score_thresh:
                continue
            per_obj.setdefault(int(d["obj_id"]), []).append(d)
        insts = []
        for oid, ds in per_obj.items():
            ds = sorted(ds, key=lambda d: -float(d.get("score", 1.0)))[:top_k_per_obj]
            gt_by_obj = {i.obj_id: i for i in rec.instances}
            for d in ds:
                bb = _xywh_to_xyxy(d["bbox_est"])
                gt = gt_by_obj.get(oid)
                pe = np.asarray(d["pose_est"], np.float32).reshape(3, 4) \
                    if "pose_est" in d else None
                pr = np.asarray(d["pose_refine"], np.float32).reshape(3, 4) \
                    if "pose_refine" in d else None
                insts.append(Instance(
                    obj_id=oid, bbox_visib=bb, bbox_obj=bb,
                    R=gt.R if gt is not None else np.eye(3, dtype=np.float32),
                    t=gt.t if gt is not None else np.zeros(3, np.float32),
                    mask_visib_path=gt.mask_visib_path if gt else None,
                    mask_full_path=gt.mask_full_path if gt else None,
                    score=float(d.get("score", 1.0)),
                    pose_est=pe, pose_refine=pr))
        out.append(Record(rec.file_name, rec.depth_file, rec.K,
                          rec.depth_scale, rec.scene_id, rec.im_id, insts))
    return out


def save_detections(path: str, dets: dict[str, list[dict]]) -> None:
    def conv(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(type(o))
    with open(path, "w") as f:
        json.dump(dets, f, default=conv)
