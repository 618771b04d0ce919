"""The preconditions and bounds the fine-raster kernels B1 and B2 rely on,
checked on the CPU (the kernels themselves are held against their plain
versions in tests/test_torch_kernels.py, on a card):

  * rasterizer._bin_faces packs the valid candidates first, by ascending
    face-mean depth with ties to the lower face index (as the JAX package's
    _bin_faces does), so the first inside face in slot order is the z-test
    winner that the plain version's argmin picks;
  * the culling cutoffs hold in float32: a face at the B1 cutoff multiplies
    keep by exactly 1, one at the B2 cutoff has p exactly 0;
  * the box distance the kernels cull by never exceeds the distance to the
    face's nearest edge segment;
  * the plain backward fed the forward's saved face_id and keep gives what
    its recompute gives.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from self6dpp_tpu.ops import rasterizer as JR
from self6dpp_tpu_torch.ops import raster_cuda as RC
from self6dpp_tpu_torch.ops import rasterizer as TR
from test_torch_raster import scene


def random_faces(seed, b=2, f=90, height=40, width=48, tie_every=4):
    """Triangles of 1-6 px radius, a tenth invalid, every `tie_every`-th
    face given its neighbour's depths (equal face-mean depths)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform((0, 0), (width, height), (b, f, 1, 2))
    ang = rng.uniform(0, 2 * np.pi, (b, f, 1)) + np.array([0.0, 2.1, 4.2])
    rad = rng.uniform(1, 6, (b, f, 1, 1))
    v2d = (centre + rad * np.stack([np.cos(ang), np.sin(ang)], -1)
           ).astype(np.float32)
    z = rng.uniform(1, 2, (b, f, 3)).astype(np.float32)
    z[:, 1::tie_every] = z[:, 0::tie_every][:, :z[:, 1::tie_every].shape[1]]
    valid = rng.uniform(size=(b, f)) > 0.1
    attr = rng.uniform(size=(b, f, 3, 3)).astype(np.float32)
    return v2d, z, valid, attr


def table_and_cand(seed, height=40, width=48, tile_px=16, k=24, **kw):
    v2d, z, valid, attr = random_faces(seed, height=height, width=width, **kw)
    v2d_t, z_t = torch.from_numpy(v2d), torch.from_numpy(z)
    valid_t = torch.from_numpy(valid)
    zmean = z_t.mean(dim=2)
    ftab = TR._pack_faces(v2d_t, zmean, valid_t, 1.0 / z_t,
                          torch.from_numpy(attr))
    cand = TR._bin_faces(v2d_t, valid_t, height, width, tile_px, k, zmean)
    return v2d, valid, zmean, ftab, cand


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [8, 64])
def test_bin_faces_sorts_valid_faces_by_depth_with_stable_ties(seed, k):
    v2d, valid, zmean, ftab, cand = table_and_cand(seed, k=k)
    z = zmean.numpy()
    assert (z[:, 1::4] == z[:, 0::4][:, :z[:, 1::4].shape[1]]).all()
    for b in range(cand.shape[0]):
        ref = JR._bin_faces(jnp.asarray(v2d[b]), jnp.asarray(valid[b]), 40, 48,
                            16, k, zmean_f=jnp.asarray(z[b]))
        assert np.asarray(ref).tolist() == cand[b].tolist()
        for row in cand[b].tolist():
            ids = [f for f in row if f >= 0]
            assert row[:len(ids)] == ids                  # valid slots first
            assert all(valid[b][f] for f in ids)
            keys = [(z[b][f], f) for f in ids]
            assert keys == sorted(keys)                   # depth, then index
    assert RC.cand_depth_sorted(ftab, cand.reshape(-1, k))
    assert (cand >= 0).sum() > 0


def test_cand_depth_sorted_rejects_other_orders():
    _, _, _, ftab, cand = table_and_cand(0, k=16)
    cand = cand.reshape(-1, 16)
    assert RC.cand_depth_sorted(ftab, cand)
    t = int(((cand >= 0).sum(1) >= 3).nonzero()[0])
    swapped = cand.clone()
    swapped[t, [0, 1]] = cand[t, [1, 0]]
    hole = cand.clone()
    hole[t, 0] = -1
    invalid = ftab.clone()
    invalid[0, int(cand[t, 0]) if t < cand.shape[0] // 2 else 0, 7] = 0.0
    assert not RC.cand_depth_sorted(ftab, swapped)
    assert not RC.cand_depth_sorted(ftab, hole)
    if t < cand.shape[0] // 2:
        assert not RC.cand_depth_sorted(invalid, cand)


@pytest.mark.parametrize("seed", range(4))
def test_first_inside_face_in_slot_order_is_the_argmin_winner(seed):
    """B1 stops a covered pixel at its first inside face; on _bin_faces'
    order that face is the plain version's argmin winner (equal depths
    included: the lower slot wins both ways)."""
    h, w, tp, k = 40, 48, 16, 64
    _, _, _, ftab, cand = table_and_cand(seed, f=160, k=k)
    cand = cand.reshape(-1, k)
    out = RC.fine_raster_plain(ftab, cand, h, w, tp, 1.0, False, True)
    th, tw = -(-h // tp), -(-w // tp)
    T, P = cand.shape[0], tp * tp
    tiles = torch.arange(T)
    ti = tiles % (th * tw)
    r = torch.arange(P)
    pv = ((ti // tw * tp)[:, None] + r // tp).float()[..., None]
    pu = ((ti % tw * tp)[:, None] + r % tp).float()[..., None]
    rows = ftab[(tiles // (th * tw))[:, None], cand.long().clamp_min(0)]
    x0, y0, x1, y1, x2, y2 = (rows[:, None, :, j] for j in range(6))
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    inv = torch.where(area.abs() > 1e-12, 1.0 / area, torch.zeros_like(area))
    w0 = ((x1 - pu) * (y2 - pv) - (x2 - pu) * (y1 - pv)) * inv
    w1 = ((x2 - pu) * (y0 - pv) - (x0 - pu) * (y2 - pv)) * inv
    w2 = 1.0 - w0 - w1
    inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)
              & ((rows[..., 7] > 0.5) & (cand >= 0))[:, None, :])
    first = inside.int().argmax(-1)                     # first True slot
    fid = torch.where(inside.any(-1), cand.long().gather(1, first), -1)
    want = RC._tile_pixels(out.face_id + 1, tp, th * tw, tw) - 1
    in_img = RC._tile_pixels(torch.ones_like(out.mask), tp, th * tw, tw) > 0
    assert torch.equal(fid[in_img], want.long()[in_img])
    assert (want >= 0).sum() > 100
    # equal depths among a pixel's inside faces occur
    zin = torch.where(inside, rows[:, None, :, 6], torch.inf)
    ties = (zin == zin.amin(-1, keepdim=True)) & inside
    assert (ties.sum(-1) > 1).any() or seed != 0


def test_cull_cutoffs_hold_in_float32():
    """At and beyond B1's cutoff 1 - exp(-x) rounds to 1 in float32 (the
    face's factor of keep is exactly 1); at and beyond B2's exp(-x) is 0.
    The kernels compute x = d² / sigma² from d² >= cutoff * sigma², so the
    check starts a little below each cutoff and runs through the wrappers'
    squared distances for several sigmas."""
    for cut, holds in ((RC.B1_CULL, lambda x: (1.0 - torch.exp(-x)) == 1.0),
                       (RC.B2_CULL, lambda x: torch.exp(-x) == 0.0)):
        x = torch.linspace(cut * (1 - 1e-3), cut + 200.0, 200_001,
                           dtype=torch.float32)
        assert holds(x).all()
    assert (1.0 - torch.exp(torch.tensor(-17.0))) < 1.0   # the cutoff is tight
    assert torch.exp(torch.tensor(-103.0)) > 0.0
    for sigma in (0.5, 1.0, 1.5, 3.0):
        s2 = torch.tensor(sigma ** 2, dtype=torch.float32)
        for d2min, holds in (
                (RC.b1_cull_d2(sigma, True),
                 lambda x: (1.0 - torch.exp(-x)) == 1.0),
                (RC.b2_cull_d2(sigma), lambda x: torch.exp(-x) == 0.0)):
            d2 = torch.linspace(d2min, d2min * 4, 10_001, dtype=torch.float32)
            assert holds(d2 / s2).all(), sigma
        assert RC.b1_cull_d2(sigma, True) >= RC.INSIDE_CULL_D2
    assert RC.b1_cull_d2(1.5, False) == RC.INSIDE_CULL_D2 == 1.0


@pytest.mark.parametrize("seed", range(3))
def test_box_distance_never_exceeds_the_edge_distance(seed):
    """For seeded triangles (degenerate ones among them: a repeated vertex,
    three collinear vertices, one point) and 8 x 4 pixel boxes, the squared
    box distance the kernels cull by is at most the squared distance from
    any pixel of the box to the triangle's nearest edge segment."""
    rng = np.random.default_rng(seed)
    n = 400
    tri = rng.uniform(-20, 60, (n, 3, 2)).astype(np.float32)
    tri[0::10, 1] = tri[0::10, 0]                           # repeated vertex
    tri[1::10, 2] = 0.3 * tri[1::10, 0] + 0.7 * tri[1::10, 1]  # collinear
    tri[2::10, 1:] = tri[2::10, :1]                         # a point
    bx = rng.integers(-10, 60, n).astype(np.float32)
    by = rng.integers(-10, 60, n).astype(np.float32)
    t = torch.from_numpy(tri)
    x0, y0, x1, y1, x2, y2 = (t[:, i // 2, i % 2, None] for i in range(6))
    lx = torch.arange(32) % 8
    ly = torch.arange(32) // 8
    pu = torch.from_numpy(bx)[:, None] + lx
    pv = torch.from_numpy(by)[:, None] + ly
    seg = torch.minimum(torch.minimum(RC._seg_d2(pu, pv, x0, y0, x1, y1),
                                      RC._seg_d2(pu, pv, x1, y1, x2, y2)),
                        RC._seg_d2(pu, pv, x2, y2, x0, y0)).amin(-1)
    box = RC.box_gap_d2(torch.from_numpy(bx), torch.from_numpy(bx) + 7,
                        torch.from_numpy(by), torch.from_numpy(by) + 3,
                        t[..., 0].amin(1), t[..., 0].amax(1),
                        t[..., 1].amin(1), t[..., 1].amax(1))
    # rounding of the segment distance: far below the cutoffs' margins
    assert (box <= seg * (1 + 1e-5) + 1e-6).all()
    assert (box > 0).sum() > n // 4 and (box == 0).sum() > 0


@pytest.mark.parametrize("mesh,with_prob,zbuf,hw", [
    ("sphere", True, "persp", (32, 32)), ("cube", True, "face", (32, 32)),
    ("sphere", False, "persp", (40, 56)), ("sphere", True, "face", (40, 56))])
def test_plain_backward_from_saved_state_equals_recompute(mesh, with_prob,
                                                          zbuf, hw):
    """FineRaster saves the forward's face_id and keep; the plain backward
    fed them gives d ftab equal to its recompute of the winner and the
    product (tests/test_torch_raster_grad.py holds the saved path against
    the JAX vjp)."""
    verts, faces, colors, K, R, t = scene(mesh)
    h, w = hw
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    ftab, cand = TR.raster_inputs(f32(verts), torch.as_tensor(faces),
                                  f32(colors), f32(K), f32(R), f32(t), h, w,
                                  16, 16)
    persp = zbuf == "persp"
    out, keep = RC._fine_plain(ftab, cand, h, w, 16, 1.5, with_prob, persp)
    assert (keep is None) == (not with_prob)
    g = torch.Generator().manual_seed(1)
    cts = [torch.randn(s, generator=g) for s in
           ((2, h, w), (2, h, w), (2, h, w, 3))]
    call = (ftab, cand, *cts, h, w, 16, 1.5, with_prob, persp)
    saved = RC.fine_raster_bwd_plain(*call, (out.face_id, keep))
    recomputed = RC.fine_raster_bwd_plain(*call)
    torch.testing.assert_close(saved, recomputed, rtol=0, atol=0)
    assert saved.abs().max() > 0
    # and through the CPU route of the kernel wrapper
    torch.testing.assert_close(
        RC.fine_raster_bwd(*call, (out.face_id, keep)), saved, rtol=0,
        atol=0)
