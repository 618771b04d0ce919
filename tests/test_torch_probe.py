"""The LAB opaque probe's kernels P1 and P2: the port's plain versions
(what sign_g and sign_g_split run on CPU tensors) against the JAX probe's
own pallas_g and pallas_g_split in Pallas interpret mode, bitwise,
including the sign of zero and the NaN positions. The JAX probe file builds
and times the whole flagship step at import, so only its four kernel
functions are taken from it: parsed with ast and executed in a namespace
whose pallas_call runs in interpret mode. Also the probe's hook into the
step, and the start state it rebuilds for J and J2, at the tiny
configuration."""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.engine import self_engine as se
from self6dpp_tpu_torch.ops import sign_cuda as SC
from self6dpp_tpu_torch.probes import lab_opaque_probe as P

PROBE = Path(__file__).resolve().parents[1] / "tools/probes/lab_opaque_probe.py"
KERNEL_FNS = ("_sign_kernel", "pallas_g", "_sign3_kernel", "pallas_g_split")


@pytest.fixture(scope="module")
def jax_probe():
    tree = ast.parse(PROBE.read_text())
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in KERNEL_FNS]
    assert sorted(d.name for d in defs) == sorted(KERNEL_FNS)
    ns = {"jax": jax, "jnp": jnp, "np": np,
          "pl": types.SimpleNamespace(
              pallas_call=functools.partial(pl.pallas_call, interpret=True),
              BlockSpec=pl.BlockSpec)}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(PROBE), "exec"), ns)
    return ns


def probe_inputs(b=2, s=8, seed=0):
    """ren_m, img_m (b, s, s, 3) float32 with ties (r == i), NaN on either
    side, -0.0 - +0.0 (a difference of -0.0), +0.0 - +0.0, infinities and
    ordinary values."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
    i = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
    flat_r, flat_i = r.reshape(-1), i.reshape(-1)
    n = flat_r.size
    pick = rng.permutation(n)
    ties, nan_r, nan_i, neg0, pos0, inf = np.array_split(pick[: n // 2], 6)
    flat_i[ties] = flat_r[ties]
    flat_r[nan_r] = np.nan
    flat_i[nan_i] = np.nan
    flat_r[neg0], flat_i[neg0] = -0.0, 0.0
    flat_r[pos0], flat_i[pos0] = 0.0, 0.0
    flat_r[inf] = np.where(rng.uniform(size=inf.size) < 0.5, np.inf, -np.inf)
    return r, i


def assert_same_bits(got, ref):
    """Equal bit patterns where ref is a number; NaN exactly where ref is."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  ref.view(np.int32)[~nan])


@pytest.mark.parametrize("split", [False, True])
def test_plain_matches_jax_pallas_bitwise(jax_probe, split):
    r, i = probe_inputs()
    jfn = jax_probe["pallas_g_split" if split else "pallas_g"]
    ref = np.asarray(jax.jit(jfn)(jnp.asarray(r), jnp.asarray(i)))
    before = (SC.sign_g.launches, SC.sign_g_split.launches)
    tfn = P.probe_g_split if split else P.probe_g
    got = tfn(torch.from_numpy(r), torch.from_numpy(i))
    assert (SC.sign_g.launches, SC.sign_g_split.launches) == before
    assert_same_bits(got.numpy(), ref)
    d = r - i
    assert np.signbit(ref[d == 0]).sum() > 0        # -0.0 kept
    assert (ref[d == 0] == 0).all() and np.isnan(ref).sum() > 0
    assert set(np.unique(ref[np.isfinite(ref) & (d != 0)])) == {
        np.float32(-1e-3), np.float32(1e-3)}


def test_split_planes_may_be_strided_views():
    """sign_g_split takes channel views of an NHWC tensor (element stride 3)
    as they are; the plain version gives each plane its own result."""
    r, i = map(torch.from_numpy, probe_inputs(seed=1))
    b, s = r.shape[:2]
    rp = tuple(r[..., k].reshape(b, s * s) for k in range(3))
    ip = tuple(i[..., k].reshape(b, s * s) for k in range(3))
    assert rp[1].stride() == (3 * s * s, 3)
    outs = SC.sign_g_split(rp, ip)
    for k in range(3):
        assert outs[k].is_contiguous()
        assert_same_bits(outs[k].numpy(), SC.sign_g(rp[k], ip[k]).numpy())
    with pytest.raises(ValueError, match="three r"):
        SC.sign_g_split(rp[:2], ip)


@pytest.fixture
def one_thread():
    # oneDNN's conv backward crashes with 4 or more threads on this CPU
    # build (see test_torch_self_engine.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("make_g", ["probe_g", "probe_g_split"])
def test_in_graph_lab_feeds_the_step(monkeypatch, one_thread, make_g):
    """Inside in_graph_lab, the step's loss suite gets lab_linear = (0, g)
    with g = sign(ren_m - img_m) * 1e-3 of the step's own masked render,
    the LAB term reports 0, and the loss function is restored on exit."""
    cfg = tc.stage2_pose_tiny()
    model, state, batch, lpips = se.build_stage2(cfg, 2, "cpu")
    seen = {}
    orig = se.compute_self_loss_pose

    def spy(cfg_loss, ren, out, pseudo, b, **kw):
        seen.update(kw, color=ren["color"].detach(), vis=pseudo["vis_mask"])
        return orig(cfg_loss, ren, out, pseudo, b, **kw)

    monkeypatch.setattr(se, "compute_self_loss_pose", spy)
    step = se.make_self_train_step(cfg, model, lpips, split_lab=True)
    with P.in_graph_lab(getattr(P, make_g)):
        _, m = step(state, batch)
    assert se.compute_self_loss_pose is spy
    val, g = seen["lab_linear"]
    assert val == 0.0 and float(m["loss_color_ab_obj"]) == 0.0
    vis = seen["vis"][..., None]
    want = SC.sign_g_plain(seen["color"] * vis, batch["roi_img"] * vis)
    assert torch.equal(g, want) and g.abs().max() > 0
    assert "loss_percep_obj" in m and "loss_chamfer" in m


def test_build_stage2_repeats_from_the_seed(one_thread):
    """run_probe starts J and J2 from the state A starts from by calling
    build_stage2 again with the same seed: student, teacher, optimizer
    state, batch and LPIPS come out equal."""
    cfg = tc.stage2_pose_tiny()
    m1, s1, b1, l1 = se.build_stage2(cfg, 2, "cpu", seed=3)
    m2, s2, b2, l2 = se.build_stage2(cfg, 2, "cpu", seed=3)
    for a, b in ((m1, m2), (s1.teacher, s2.teacher), (l1, l2)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for p, q in zip(s1.model.parameters(), s2.model.parameters()):
        for k in ("mu", "nu", "slow"):
            assert torch.equal(s1.opt.state[p][k], s2.opt.state[q][k])
    assert s1.step == s2.step == 0 and s1.opt.count == s2.opt.count == 0
    assert b1.keys() == b2.keys()
    for k in b1:
        assert torch.equal(b1[k], b2[k]), k
    other = se.build_stage2(cfg, 2, "cpu", seed=4)[0].state_dict()
    assert any(not torch.equal(v, other[k]) for k, v in m1.state_dict().items())
