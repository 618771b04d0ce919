"""The yardstick's counters on tiny shapes against counts by hand."""

import pytest
import torch

from portbench import counts
from portbench.reference.ops.rasterizer import raster_inputs
from portbench.reference.ops.raster_plain import fine_raster_plain


def test_bound_takes_the_slowest_resource():
    assert counts.bound_ms(counts.PEAK_BYTES * 1e-3, 0.0) == pytest.approx(1)
    assert counts.bound_ms(0.0, counts.PEAK_F32 * 2e-3) == pytest.approx(2)
    assert counts.bound_ms(1.0, 1.0, counts.PEAK_SFU * 3e-3) \
        == pytest.approx(3)


def one_triangle():
    """One large triangle facing the camera in a 16 x 16 image, one tile."""
    verts = torch.tensor([[[-0.05, -0.05, 0.0], [0.05, -0.05, 0.0],
                           [0.0, 0.05, 0.0]]])
    faces = torch.tensor([[0, 2, 1]], dtype=torch.int32)
    colors = torch.ones((1, 3, 3))
    K = torch.tensor([[[100.0, 0, 8], [0, 100.0, 8], [0, 0, 1]]])
    R = torch.eye(3)[None]
    t = torch.tensor([[0.0, 0.0, 1.0]])
    ftab, cand = raster_inputs(verts, faces, colors, K, R, t, 16, 16, 16, 4,
                               False)
    out = fine_raster_plain(ftab, cand, 16, 16, 16, 1.0, True, True)
    return ftab, cand, out.mask


def test_raster_counts_and_b1_ops_by_hand():
    ftab, cand, mask = one_triangle()
    n = counts.raster_counts(ftab, cand, mask, 16, 16, 16)
    covered = int(mask.sum())
    assert 0 < covered < 256
    assert n["face_rows_read"] == 1 and n["occupied_tiles"] == 1
    assert n["covered_pixels"] == covered
    want = (256 * counts.OPS_TEST + counts.OPS_CAND
            + covered * counts.OPS_WIN_FWD
            + (256 - covered) * counts.OPS_SEG)
    assert counts.b1_ops(n) == want
    C = ftab.shape[2]
    want_bytes = C * 4 + cand.numel() * 4 + 256 * (4 + 3 + 3) * 4
    call = ((ftab, cand, 16, 16, 16, 1.0, True, True), mask)
    assert counts.b1_bound_ms(call) == pytest.approx(counts.bound_ms(
        want_bytes, want))


def test_lab_ops_by_hand():
    pred = torch.full((1, 2, 2, 3), 0.5)     # power and cube-root branches
    gt = torch.full((1, 2, 2, 3), 0.01)      # linear and linear branches
    ops, sfu = counts.lab_ops(pred, gt)
    px = 4
    assert ops == px * (counts.OPS_LAB + 3 * 13 + 3 * 17 + 3 * 1 + 3 * 2)
    assert sfu == px * (3 * 3 + 3 * 2)


def test_model_flops_by_hand():
    lin = torch.nn.Linear(8, 4)
    x = torch.randn(3, 8)
    assert counts.model_flops(lambda: lin(x)) == 2 * 3 * 8 * 4
    # backward: the input's and the weight's gradients, one product each
    xg = torch.randn(3, 8, requires_grad=True)
    assert counts.model_flops(lambda: lin(xg).sum().backward()) \
        == 3 * (2 * 3 * 8 * 4)
    conv = torch.nn.Conv2d(2, 3, 3)
    assert counts.model_flops(lambda: conv(torch.randn(1, 2, 5, 5))) \
        == 2 * (3 * 3 * 3) * (2 * 3 * 3)


def test_idle_gaps_named_by_the_marker_launches():
    """Marks at 0 (start), 25 (fwd's end) and 46 (bwd's end): each gap
    goes to the phase that launched the operation ending it."""
    from portbench import trace

    def kernel(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}
    events = [launch(0, 1), kernel("spin_kernel(long)", 1, 1, 1),
              launch(5, 2), kernel("conv", 10, 10, 2), launch(25, 3),
              kernel("spin_kernel(long)", 26, 1, 3), launch(30, 4),
              kernel("gemm", 40, 5, 4), launch(46, 5),
              kernel("spin_kernel(long)", 47, 1, 5)]
    red = trace.reduce(events, 1e-4, ["start", "fwd", "bwd"])
    gaps = dict(red["idle_gaps"])
    # 2-10 (conv, launched at 5: fwd), 20-26 (fwd's marker), 27-40 (gemm,
    # launched at 30: bwd), 45-47 (bwd's marker)
    assert gaps == pytest.approx({"fwd": 14e-6, "bwd": 15e-6})
    assert red["busy_s"] == pytest.approx(18e-6)
