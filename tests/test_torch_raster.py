"""The port's rasterizer against the JAX package's, on the same inputs.

The port's fine stage runs its plain PyTorch version here (CPU tensors); it
is held against rasterize_batch(impl="xla") for every output, bary included,
and against impl="pallas" in interpret mode for every output but bary (the
Pallas path returns zeros there). The CUDA kernel itself is held against the
plain version in tests/test_torch_kernels.py, on a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from scipy.spatial.transform import Rotation

import self6dpp_tpu.ops.raster_pallas as RP
from self6dpp_tpu.ops import rasterizer as JR
from self6dpp_tpu_torch.data.meshes import make_cube, make_icosphere
from self6dpp_tpu_torch.ops import raster_cuda as RC
from self6dpp_tpu_torch.ops import rasterizer as TR

_orig_pallas_call = pl.pallas_call


def _interp_pallas_call(*args, **kw):
    kw.setdefault("interpret", True)
    return _orig_pallas_call(*args, **kw)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(RP.pl, "pallas_call", _interp_pallas_call)


def scene(mesh, b=2, seed=0):
    rng = np.random.default_rng(seed)
    if mesh == "cube":
        verts, faces = make_cube(size=0.4)
    else:
        verts, faces = make_icosphere(radius=0.2, subdivisions=2)
    colors = ((verts - verts.min(0)) / (verts.max(0) - verts.min(0))
              ).astype(np.float32)
    K = np.array([[32.0, 0, 16.0], [0, 32.0, 16.0], [0, 0, 1.0]], np.float32)
    R = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    R[0] = np.eye(3)             # axis-aligned: equal face-mean depths (ties)
    t = np.stack([rng.uniform(-0.05, 0.05, b), rng.uniform(-0.05, 0.05, b),
                  rng.uniform(0.9, 1.3, b)], 1).astype(np.float32)
    t[0] = (0.02, -0.01, 1.0)
    return verts, faces, colors, K, R, t


def render_both(mesh, impl, height=32, width=32, **kw):
    verts, faces, colors, K, R, t = scene(mesh)
    kw = dict(height=height, width=width, tile_px=16, faces_per_tile=16, **kw)
    a = JR.rasterize_batch(jnp.asarray(verts), jnp.asarray(faces),
                           jnp.asarray(colors), jnp.asarray(K), jnp.asarray(R),
                           jnp.asarray(t), impl=impl, **kw)
    b = TR.rasterize_batch(verts, faces, colors, K, R, t, impl="kernel",
                           device="cpu", **kw)
    return a, b


def assert_field_equal(name, ref, got, atol=0.0, first=5):
    """Raise naming the field, and for its first differing pixels the image,
    the pixel (row, col) and the values on both sides."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    bad = np.abs(ref.astype(np.float64) - got) > atol
    if bad.ndim == 4:
        bad = bad.any(-1)
    if not bad.any():
        return
    where = np.argwhere(bad)[:first]
    lines = [f"{name}: {int(bad.sum())} pixels differ beyond {atol}"]
    lines += [f"  image {i} pixel ({r}, {c}): jax {ref[i, r, c]} port "
              f"{got[i, r, c]}" for i, r, c in where]
    raise AssertionError("\n".join(lines))


def assert_raster_equal(a, b, with_bary=True):
    mask_a = np.asarray(a.mask)
    assert_field_equal("mask", mask_a, b.mask.numpy())
    assert_field_equal("face_id", a.face_id, b.face_id.numpy())
    for name in ("prob", "depth", "attr"):
        assert_field_equal(name, getattr(a, name), getattr(b, name).numpy(),
                           atol=1e-5)
    if with_bary:
        # the XLA path leaves uncovered pixels' bary unmasked; the port
        # writes zeros there
        cov = mask_a[..., None] > 0.5
        assert_field_equal("bary", np.where(cov, np.asarray(a.bary), 0.0),
                           b.bary.numpy(), atol=1e-5)
    assert mask_a.sum() > 0


CASES = [(m, wp, z, hw)
         for m in ("cube", "sphere") for wp in (False, True)
         for z in ("persp", "face") for hw in ((32, 32),)] + [
            ("sphere", True, "persp", (40, 56)),      # ragged tiles
            ("cube", False, "persp", (24, 40))]


@pytest.mark.parametrize("mesh,with_prob,zbuf,hw", CASES)
def test_plain_matches_jax_xla(mesh, with_prob, zbuf, hw):
    a, b = render_both(mesh, "xla", *hw, with_prob=with_prob, zbuf_mode=zbuf)
    assert_raster_equal(a, b)


@pytest.mark.parametrize("mesh,with_prob,zbuf,hw", CASES)
def test_plain_matches_jax_pallas(interpret_mode, mesh, with_prob, zbuf, hw):
    a, b = render_both(mesh, "pallas", *hw, with_prob=with_prob,
                       zbuf_mode=zbuf)
    assert_raster_equal(a, b, with_bary=False)


def test_bin_faces_keeps_nearest_with_stable_ties():
    """K overflow keeps the K nearest faces; equal depths keep the lower
    face index first, as jax.lax.top_k does."""
    F = 6
    v2d = np.zeros((1, F, 3, 2), np.float32)
    v2d[..., 0] = [[0, 8, 0]]               # every face overlaps tile 0
    v2d[..., 1] = [[0, 0, 8]]
    z = np.array([[2.0, 1.0, 2.0, 1.0, 3.0, 1.0]], np.float32)
    valid = np.array([[True, True, True, True, True, False]])
    cand = TR._bin_faces(torch.from_numpy(v2d), torch.from_numpy(valid),
                         16, 16, 16, 4, torch.from_numpy(z))
    assert cand.tolist() == [[[1, 3, 0, 2]]]
    ref = JR._bin_faces(jnp.asarray(v2d[0]), jnp.asarray(valid[0]), 16, 16,
                        16, 4, zmean_f=jnp.asarray(z[0]))
    assert np.asarray(ref).tolist() == cand[0].tolist()
    # fewer faces than K: padded with -1
    cand = TR._bin_faces(torch.from_numpy(v2d), torch.from_numpy(valid),
                         16, 16, 16, 8, torch.from_numpy(z))
    assert cand.tolist() == [[[1, 3, 0, 2, 4, -1, -1, -1]]]


def test_rasterize_batch_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces, colors, K, R, t = scene("cube")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.rasterize_batch(verts, faces, colors, K, R, t)


def test_wrapper_uses_plain_only_for_cpu_tensors():
    verts, faces, colors, K, R, t = scene("sphere")
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    ftab, cand = TR.raster_inputs(f32(verts), torch.as_tensor(faces),
                                  f32(colors), f32(K), f32(R), f32(t), 32, 32,
                                  16, 16)
    before = RC.fine_raster.launches
    out = RC.fine_raster(ftab, cand, 32, 32, 16, 1.0, True, True)
    ref = RC.fine_raster_plain(ftab, cand, 32, 32, 16, 1.0, True, True)
    assert RC.fine_raster.launches == before      # no kernel on the CPU
    for x, y in zip(out, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA device"):
        RC.fine_raster(ftab.to("meta"), cand.to("meta"), 32, 32, 16, 1.0,
                       True, True)
