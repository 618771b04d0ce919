"""The port's detection evaluator (self6dpp_tpu_torch/engine/
det_evaluator.py) against the JAX package's: the AP table (AP, AP50,
AP75) equal on random predictions with tied scores, boxes that tie on
IoU, a class with ground truth and no prediction, a class predicted with
no ground truth, and an image without ground truth."""

import numpy as np
import pytest

from self6dpp_tpu.engine import det_evaluator as J
from self6dpp_tpu_torch.engine import det_evaluator as T


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _fill(ev, rng, n_images=12, num_classes=4):
    for img in range(n_images):
        ng = int(rng.integers(0, 5)) if img else 0
        gt = _boxes(rng, ng)
        gcls = rng.integers(0, num_classes - 1, ng)   # the last class: no GT
        npred = int(rng.integers(0, 8))
        pred = np.concatenate([gt + rng.normal(0, 4, gt.shape),
                               _boxes(rng, npred)])[:ng + npred]
        pcls = np.concatenate([gcls, rng.integers(0, num_classes, npred)])
        # scores on a 0.1 grid: many ties
        score = np.round(rng.uniform(0, 1, len(pred)), 1)
        if len(pred) > 1:
            pred[1] = pred[0]          # two predictions tie on IoU
        ev.add_image(f"0/{img}", pred, pcls, score, gt, gcls)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_table_matches_jax(seed):
    je, te = J.DetEvaluator(num_classes=5), T.DetEvaluator(num_classes=5)
    _fill(je, np.random.default_rng(seed), num_classes=5)
    _fill(te, np.random.default_rng(seed), num_classes=5)
    a, b = je.evaluate(), te.evaluate()
    assert a == b and set(b) == {"AP", "AP50", "AP75"}
    assert 0.0 < b["AP50"] <= 1.0


def test_empty_and_helpers_match_jax():
    assert T.DetEvaluator(3).evaluate() == J.DetEvaluator(3).evaluate() \
        == {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
    rng = np.random.default_rng(4)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    assert np.array_equal(T.box_iou_xyxy(a, b), J.box_iou_xyxy(a, b))
    rec = np.sort(rng.uniform(0, 1, 9))
    prec = rng.uniform(0, 1, 9)
    assert T.average_precision(rec, prec) == J.average_precision(rec, prec)
    assert T.average_precision(np.zeros(0), np.zeros(0)) == 0.0
