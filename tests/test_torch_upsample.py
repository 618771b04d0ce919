"""The geo head's align-corners 2x upsample on the CPU: the plain
gather-form backward (the arithmetic of csrc/upsample2x.cu's backward)
against autograd of the plain forward, the cached tables, and the
dispatcher's CPU path. The kernels themselves are held on a card by
tests/test_torch_kernels.py."""

import pytest
import torch

from self6dpp_tpu_torch.models import layers as L

SHAPES = [(1, 1), (2, 3), (5, 7), (8, 8), (16, 16), (16, 32)]
CPU = torch.device("cpu")
# one bfloat16 rounding: half an ulp, at most 2^-8 of the value, plus the
# float32 sums' own error before that rounding, far under 2^-16 of the sum
# of the terms' magnitudes (at most 5 x 5 terms an input)
BF16_REL = 2.0 ** -8
F32_SUM_REL = 2.0 ** -16


def _pair(h, w, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed + 97 * h + w)
    x = torch.randn(2, 3, h, w, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 3, 2 * h, 2 * w, generator=gen, dtype=torch.float64)
    return x.to(dtype), g.to(dtype)


def table_forward(x, tab):
    """The kernel's forward order on the CPU: along W from the tables (the
    plain version's `top` and `bot` rows), then along H, rounding to x's
    dtype after every operation."""
    def axis(v, ax, dim):
        shape = [1] * 4
        shape[dim] = 2 * ax.n
        p, q = (t.to(v.dtype).view(shape) for t in ax.wt)
        a = v.index_select(dim, ax.idx[0])
        b = v.index_select(dim, ax.idx[1])
        return a * p + b * q
    return axis(axis(x, tab.x, 3), tab.y, 2)


@pytest.mark.parametrize("h,w", SHAPES)
def test_bwd_plain_matches_autograd_float64(h, w):
    x, g = _pair(h, w, torch.float64)
    x.requires_grad_(True)
    L.upsample2x_align_corners_plain(x).backward(g)
    got = L.upsample2x_align_corners_bwd_plain(g)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, x.grad, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("h,w", SHAPES)
def test_bwd_plain_bf16_within_one_rounding(h, w):
    """bf16 against the same sums in float64 on the same (bf16-rounded)
    weights and cotangent: |got - ref| <= 2^-8 |ref| + 2^-16 sum|terms|."""
    _, g = _pair(h, w, torch.bfloat16)
    tab = L.upsample_tables(h, w, torch.bfloat16, CPU)
    got = L.upsample2x_align_corners_bwd_plain(g, tab)
    assert got.dtype == torch.bfloat16
    ref = L.upsample2x_align_corners_bwd_plain(g.double(), tab)
    mag = L.upsample2x_align_corners_bwd_plain(g.double().abs(), tab)
    err = (got.double() - ref).abs()
    assert bool((err <= BF16_REL * ref.abs() + F32_SUM_REL * mag).all())
    # and it is a rounding, not an exact copy: some entries moved
    assert bool((err > 0).any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("h,w", [(5, 7), (16, 16)])
def test_dispatcher_takes_the_plain_path_on_cpu(h, w, dtype):
    x, g = _pair(h, w, dtype, seed=1)
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya = L.upsample2x_align_corners(a)
    yb = L.upsample2x_align_corners_plain(b)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    assert torch.equal(a.grad, b.grad)
    assert torch.equal(L.Upsample2x("bilinear")(x), yb)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w", SHAPES)
def test_tables_give_the_plain_forward_bitwise(h, w, dtype):
    """The tables hold the plain function's indices and rounded weights:
    interpolating along W first (once per input row, as the kernel does)
    gives its output bit for bit."""
    x, _ = _pair(h, w, dtype, seed=2)
    tab = L.upsample_tables(h, w, dtype, CPU)
    assert torch.equal(table_forward(x, tab),
                       L.upsample2x_align_corners_plain(x))


def _same_axis(a, b):
    assert a.n == b.n
    for name in ("idx", "wt", "inv_o", "inv_w", "inv_n"):
        ta, tb = getattr(a, name), getattr(b, name)
        assert ta.dtype == tb.dtype and torch.equal(ta, tb), name
    for name in ("lo_host", "hi_host", "inv_lo_host", "inv_hi_host"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("h,w", SHAPES)
def test_cached_tables_equal_a_fresh_build(h, w):
    for dtype in (torch.bfloat16, torch.float32):
        cached = L.upsample_tables(h, w, dtype, CPU)
        assert L.upsample_tables(h, w, dtype, CPU) is cached
        fresh = L.build_upsample_tables(h, w, dtype, CPU)
        assert fresh is not cached
        _same_axis(cached.y, fresh.y)
        _same_axis(cached.x, fresh.x)
        # the inverse tables list each (output, weight) the forward applies
        for ax in (cached.y, cached.x):
            taps = sorted((int(i), o, float(ax.wt[r, o]))
                          for r in range(2) for o, i in enumerate(ax.idx[r]))
            inv = sorted((i, int(ax.inv_o[i, j]), float(ax.inv_w[i, j]))
                         for i in range(ax.n) for j in range(ax.inv_n[i]))
            assert taps == inv


def test_tables_are_cached_per_shape_and_dtype():
    keys = [(4, 6, torch.bfloat16), (6, 4, torch.bfloat16),
            (4, 6, torch.float32), (5, 6, torch.bfloat16)]
    tabs = [L.upsample_tables(h, w, dt, CPU) for h, w, dt in keys]
    assert len({id(t) for t in tabs}) == len(keys)
    assert tabs[0].y.n == 4 and tabs[0].x.n == 6
    assert tabs[1].y.n == 6 and tabs[1].x.n == 4
    assert tabs[0].x.wt.dtype == tabs[2].x.wt.dtype == torch.float32
    assert not torch.equal(tabs[0].x.wt, tabs[2].x.wt)   # bf16 rounding
    assert L.upsample_tables(4, 6, torch.float64, CPU).x.wt.dtype \
        == torch.float64
