"""Detection evaluation (port of self6dpp_tpu/engine/det_evaluator.py):
COCO-style AP averaged over IoU 0.5:0.95, AP50 and AP75, as a numpy
101-point interpolated AP over each class's ranked detections, on the
host.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between (N,4) and (M,4) xyxy boxes."""
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """101-point interpolated AP (COCO protocol)."""
    if len(recalls) == 0:
        return 0.0
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    xs = np.linspace(0, 1, 101)
    # step interpolation: precision of the envelope at the smallest
    # recall >= x (COCO protocol), not linear interp
    idx = np.searchsorted(mrec, xs, side="left")
    return float(np.mean(mpre[np.minimum(idx, len(mpre) - 1)]))


class DetEvaluator:
    """Accumulates (image_id, class, box, score) predictions + GT; computes
    per-class AP@[.5:.95], AP50, AP75."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.preds: list[tuple] = []                  # (img, cls, box, score)
        self.gts: dict[tuple, list] = defaultdict(list)   # (img, cls) -> boxes

    def add_image(self, image_id, pred_boxes, pred_cls, pred_scores,
                  gt_boxes, gt_cls) -> None:
        for b, c, s in zip(pred_boxes, pred_cls, pred_scores):
            self.preds.append((image_id, int(c), np.asarray(b, float), float(s)))
        for b, c in zip(gt_boxes, gt_cls):
            self.gts[(image_id, int(c))].append(np.asarray(b, float))

    def _ap_at(self, iou_thr: float) -> dict[int, float]:
        aps = {}
        for cls in range(self.num_classes):
            cls_preds = sorted([p for p in self.preds if p[1] == cls],
                               key=lambda p: -p[3])
            npos = sum(len(v) for (img, c), v in self.gts.items() if c == cls)
            if npos == 0:
                continue
            matched: dict = defaultdict(set)
            tp = np.zeros(len(cls_preds))
            fp = np.zeros(len(cls_preds))
            for i, (img, c, box, score) in enumerate(cls_preds):
                gts = self.gts.get((img, cls), [])
                if not gts:
                    fp[i] = 1
                    continue
                ious = box_iou_xyxy(box[None], np.stack(gts))[0]
                order = np.argsort(-ious)
                hit = False
                for gi in order:
                    if ious[gi] < iou_thr:
                        break
                    if gi not in matched[img]:
                        matched[img].add(gi)
                        hit = True
                        break
                tp[i] = hit
                fp[i] = not hit
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            rec = ctp / npos
            prec = ctp / np.maximum(ctp + cfp, 1e-9)
            aps[cls] = average_precision(rec, prec)
        return aps

    def evaluate(self) -> dict[str, float]:
        thrs = np.arange(0.5, 1.0, 0.05)
        per_thr = {f"{t:.2f}": self._ap_at(t) for t in thrs}
        all_cls = set().union(*[set(v) for v in per_thr.values()]) or set()
        out = {}
        if all_cls:
            out["AP"] = float(np.mean([
                np.mean([per_thr[f"{t:.2f}"].get(c, 0.0) for t in thrs])
                for c in all_cls]))
            out["AP50"] = float(np.mean(
                [per_thr["0.50"].get(c, 0.0) for c in all_cls]))
            out["AP75"] = float(np.mean(
                [per_thr["0.75"].get(c, 0.0) for c in all_cls]))
        else:
            out = {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
        return out
