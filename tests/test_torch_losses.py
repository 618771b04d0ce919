"""The port's stage-II losses against the JAX package's, on the same numpy
inputs, in float32 on the CPU: the plain version of kernel B3 (LAB value
and image gradient) against lab_value_grad_pallas (Pallas interpret mode on
the CPU) and against jax.value_and_grad of lab_loss; the mask edge weights,
the RW_BCE mask loss, the PM loss with symmetries and the whole pose-mode
loss suite (LPIPS on both sides, MS-SSIM, the depth chamfer, LAB through
its kernel, by autograd or as a given lab_linear), values and gradients.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from self6dpp_tpu.config import base as jc
from self6dpp_tpu.losses import mask_losses as jml
from self6dpp_tpu.losses import pm_loss as jpm
from self6dpp_tpu.losses import self_loss as jsl
from self6dpp_tpu.models import lpips as JL
from self6dpp_tpu.ops import color as jcolor
from self6dpp_tpu.ops.lab_pallas import lab_value_grad_pallas
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.convert import lpips_flax_to_state_dict
from self6dpp_tpu_torch.losses import mask_losses as tml
from self6dpp_tpu_torch.losses import pm_loss as tpm
from self6dpp_tpu_torch.losses import self_loss as tsl
from self6dpp_tpu_torch.models import lpips as TL
from self6dpp_tpu_torch.ops import color as tcolor
from self6dpp_tpu_torch.ops.lab_cuda import lab_value_grad, lab_value_grad_plain

RTOL = 1e-5


def blobs(rng, b, s, n=3):
    """(b, s, s) binary masks: a few discs each, so they have edges."""
    yy, xx = np.mgrid[:s, :s]
    m = np.zeros((b, s, s), np.float32)
    for i in range(b):
        for _ in range(n):
            cy, cx = rng.uniform(0, s, 2)
            r = rng.uniform(s / 8, s / 3)
            m[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1.0
    return m


def lab_inputs(b, s, seed, mask="blobs"):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
    m = blobs(rng, b, s) if mask == "blobs" else np.zeros((b, s, s), np.float32)
    return pred, gt, m


# (batch, side, mask): B*S^2 = 2*32^2, 3*13^2 = 507 (a multiple of no block
# size), and an empty mask
LAB_CASES = [(2, 32, "blobs"), (3, 13, "blobs"), (2, 16, "empty")]


def grad_atol(ref):
    """A gradient element sums terms as large as the largest element, so
    its rounding scales with that: 1e-6 of the largest magnitude (JAX's own
    kernel and its autodiff differ by 7e-7 of it on the 3x13x13 case)."""
    return 1e-6 * float(np.abs(np.asarray(ref)).max()) + 1e-12


@pytest.mark.parametrize("no_l", [True, False])
@pytest.mark.parametrize("b,s,mask", LAB_CASES)
def test_lab_value_grad_plain_matches_jax(b, s, mask, no_l):
    pred, gt, m = lab_inputs(b, s, seed=b * 100 + s, mask=mask)
    # each side as one compiled program: quicker on the CPU than
    # dispatching its operations one by one
    jv, jg = jax.jit(lambda p, g, m_: lab_value_grad_pallas(
        p, g, m_, no_l=no_l))(jnp.asarray(pred), jnp.asarray(gt),
                              jnp.asarray(m))
    av, ag = jax.jit(jax.value_and_grad(
        lambda p: jcolor.lab_loss(p, jnp.asarray(gt), mask=jnp.asarray(m),
                                  no_l=no_l)))(jnp.asarray(pred))
    tv, tg = lab_value_grad_plain(*map(torch.from_numpy, (pred, gt, m)), no_l)
    for name, v, g in (("pallas", jv, jg), ("autodiff", av, ag)):
        np.testing.assert_allclose(tv.item(), float(v), rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=grad_atol(g), err_msg=name)
    if mask == "empty":
        assert tv.item() == 0 and not tg.any()
    else:
        assert tv.item() > 1 and tg.abs().max() > 1e-4


@pytest.mark.parametrize("no_l", [True, False])
def test_lab_value_grad_plain_matches_port_autograd(no_l):
    """The analytic chain against torch.autograd of the ported lab_loss;
    the wrapper takes the plain version for CPU tensors."""
    pred, gt, m = map(torch.from_numpy, lab_inputs(2, 24, seed=7))
    p = pred.clone().requires_grad_(True)
    val = tcolor.lab_loss(p, gt, mask=m, no_l=no_l)
    (g,) = torch.autograd.grad(val, p)
    before = lab_value_grad.launches
    tv, tg = lab_value_grad(pred, gt, m, no_l)
    assert lab_value_grad.launches == before
    torch.testing.assert_close(tv, val.detach(), rtol=RTOL, atol=0)
    torch.testing.assert_close(tg, g, rtol=RTOL, atol=grad_atol(g))


def test_mask_edge_weights_and_rw_bce_match_jax():
    rng = np.random.default_rng(0)
    mask = blobs(rng, 2, 40)
    probs = rng.uniform(0.01, 0.99, mask.shape).astype(np.float32)
    jw = jsl.compute_mask_edge_weights(jnp.asarray(mask))
    tw = tsl.compute_mask_edge_weights(torch.from_numpy(mask))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL)
    assert len(np.unique(np.asarray(jw))) > 1          # edges and interior
    for w in (None, jw):
        jl = jml.weighted_ex_loss_probs(jnp.asarray(probs), jnp.asarray(mask),
                                        weight=w)
        tl = tml.weighted_ex_loss_probs(
            torch.from_numpy(probs), torch.from_numpy(mask),
            weight=None if w is None else torch.from_numpy(np.asarray(w)))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)


def pm_inputs(b=3, n=64, nsym=4, seed=0):
    rng = np.random.default_rng(seed)
    rot = lambda k, s: Rotation.random(k, random_state=s).as_matrix().astype(
        np.float32)
    sym = np.broadcast_to(np.eye(3, dtype=np.float32), (b, nsym, 3, 3)).copy()
    sym[:, 1:] = rot(b * (nsym - 1), seed + 1).reshape(b, nsym - 1, 3, 3)
    valid = np.zeros((b, nsym), bool)
    valid[:, 0] = True
    valid[0, 1:] = True                  # instance 0 is symmetric
    valid[1, 1] = True
    return dict(
        pred_rots=rot(b, seed + 2), gt_rots=rot(b, seed + 3),
        points=rng.normal(0, 0.05, (b, n, 3)).astype(np.float32),
        pred_transes=rng.normal([0, 0, 1], 0.05, (b, 3)).astype(np.float32),
        gt_transes=rng.normal([0, 0, 1], 0.05, (b, 3)).astype(np.float32),
        extents=rng.uniform(0.05, 0.3, (b, 3)).astype(np.float32),
        sym_rots=sym, sym_valid=valid)


@pytest.mark.parametrize("flags", [
    dict(symmetric=True, norm_by_extent=True, disentangle_z=True,
         loss_weight=10.0),
    dict(symmetric=True, r_only=True, loss_type="smooth_l1", beta=0.01),
    dict(disentangle_t=True, loss_type="mse"),
    dict(symmetric=True, t_loss_use_points=False, disentangle_z=True),
    dict()])
def test_pm_loss_matches_jax(flags):
    x = pm_inputs()
    jout = jpm.pm_loss(**{k: jnp.asarray(v) for k, v in x.items()}, **flags)
    tout = tpm.pm_loss(**{k: torch.from_numpy(v) for k, v in x.items()},
                       **flags)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].item(), float(jout[k]), rtol=RTOL,
                                   err_msg=k)
    # the symmetric instance takes a non-identity slot
    if flags.get("symmetric"):
        c = tpm.closest_sym_rot(*(torch.from_numpy(x[k]) for k in (
            "pred_rots", "gt_rots", "sym_rots", "sym_valid")))
        assert not torch.allclose(c[0], torch.from_numpy(x["gt_rots"][0]))


def loss_inputs(b=2, s=32, o=8, regions=4, seed=0):
    """Fixed inputs of compute_self_loss_pose: render, student outputs,
    teacher labels and batch, as numpy arrays. The image is the render's
    colour mixed with noise (so every MS-SSIM level is positive, see
    test_torch_ssim.py), the rendered depth is 0.9-1.1 where the render
    covers and 0 elsewhere, the observed depth the plane z = 1."""
    rng = np.random.default_rng(seed)
    vis = blobs(rng, b, s)
    f = s // o
    vis_lr = vis[:, ::f, ::f].copy()
    u = lambda *shape, lo=0.0, hi=1.0: rng.uniform(lo, hi, shape).astype(
        np.float32)
    x = pm_inputs(b, seed=seed)
    mask = (u(b, s, s) > 0.5).astype(np.float32)
    ren = {"color": u(b, s, s, 3), "prob": u(b, s, s, lo=0.02, hi=0.98),
           "mask": mask, "depth": u(b, s, s, lo=0.9, hi=1.1) * mask}
    logits = rng.normal(0, 1, (b, o, o, regions + 1)).astype(np.float32)
    pred = {"rot": x["pred_rots"], "trans": x["pred_transes"],
            "coor": u(b, o, o, 3), "region_logits": logits}
    e = np.exp(logits + rng.normal(0, 0.3, logits.shape))
    pseudo = {"vis_mask": vis, "vis_mask_lr": vis_lr, "rot": x["gt_rots"],
              "trans": x["gt_transes"], "coor": u(b, o, o, 3),
              "region": (e / e.sum(-1, keepdims=True)).astype(np.float32)}
    K = np.array([[1.5 * s, 0, s / 2], [0, 1.5 * s, s / 2 - 1], [0, 0, 1]],
                 np.float32)
    batch = {"roi_img": 0.3 * ren["color"] + 0.7 * u(b, s, s, 3),
             "roi_depth": np.ones((b, s, s), np.float32),
             "roi_zoom_K": np.repeat(K[None], b, 0), "gt_points": x["points"],
             "roi_extent": x["extents"], "sym_rots": x["sym_rots"],
             "sym_valid": x["sym_valid"]}
    return ren, pred, pseudo, batch


def self_cfgs(**kw):
    t = dataclasses.replace(tc.stage2_pose_flagship().self_sup, **kw)
    j = jc.SelfSupConfig(**{f.name: getattr(t, f.name)
                            for f in dataclasses.fields(t)})
    return j, t


DIFF = (("ren", "prob"), ("ren", "color"), ("ren", "depth"), ("pred", "rot"),
        ("pred", "trans"), ("pred", "coor"), ("pred", "region_logits"))


@pytest.fixture(scope="module")
def lpips_pair():
    """JAX's LPIPS at its own init and the port's with the same weights."""
    x = jnp.zeros((2, 32, 32, 3))
    params = jax.jit(JL.LPIPS().init)(jax.random.PRNGKey(1), x, x)["params"]
    model = TL.LPIPS()
    model.load_state_dict(lpips_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), model))
    return (lambda a, b: JL.LPIPS().apply({"params": params}, a, b),
            model.eval().requires_grad_(False))


def run_both(jcfg, tcfg, lpips_pair, lab_linear=None):
    """(JAX terms, JAX gradients, port terms, port gradients) of the summed
    terms, with respect to the render and the student's outputs."""
    ren, pred, pseudo, batch = loss_inputs()
    jlp, tlp = lpips_pair
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    jlin = None if lab_linear is None else tuple(map(jnp.asarray, lab_linear))

    def jloss(ren_d, pred_d):
        ld = jsl.compute_self_loss_pose(jcfg, ren_d, pred_d, to_j(pseudo),
                                        to_j(batch), lpips_fn=jlp,
                                        lab_linear=jlin)
        return sum(jax.tree.leaves(ld)), ld

    (_, jld), (jgr, jgp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(to_j(ren), to_j(pred))
    to_t = lambda d: {k: torch.tensor(v, requires_grad=v.dtype == np.float32)
                      for k, v in d.items()}
    tren, tpred = to_t(ren), to_t(pred)
    tlin = None if lab_linear is None else tuple(map(torch.tensor, lab_linear))
    tld = tsl.compute_self_loss_pose(
        tcfg, tren, tpred, {k: torch.from_numpy(v) for k, v in pseudo.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, lpips_fn=tlp,
        lab_linear=tlin)
    sum(tld[k] for k in sorted(tld)).backward()
    return jld, {"ren": jgr, "pred": jgp}, tld, {"ren": tren, "pred": tpred}


def assert_terms_and_grads(jld, jg, tld, tg):
    assert set(tld) == set(jld)
    for k in jld:
        np.testing.assert_allclose(tld[k].item(), float(jld[k]), rtol=RTOL,
                                   err_msg=k)
    for side, k in DIFF:
        ref = np.asarray(jg[side][k])
        got = tg[side][k].grad
        got = np.zeros_like(ref) if got is None else got.numpy()
        # the depth's gradient comes from the chamfer alone, held at 1e-5 of
        # its largest magnitude as in test_torch_chamfer.py (its minima over
        # ~10^3 candidates and the backprojection's sums round apart)
        atol = (1e-5 * float(np.abs(ref).max()) if k == "depth"
                else grad_atol(ref))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol,
                                   err_msg=f"{side}.{k}")


@pytest.mark.parametrize("kw", [dict(), dict(lab_impl="direct"),
                                dict(mask_loss_type="dice", lab_no_l=False),
                                dict(mask_edge_reweight=False, lab_lw=0.0)])
def test_self_loss_pose_matches_jax(kw, lpips_pair):
    """Every term and the gradient of their sum with respect to the render
    (prob, colour, depth) and the student's outputs. LPIPS and MS-SSIM read
    the masked colour after LAB's kernel gradient is injected into it, so
    the colour's gradient carries LAB's in both packages; the depth's comes
    from the chamfer."""
    jcfg, tcfg = self_cfgs(**kw)
    jld, jg, tld, tg = run_both(jcfg, tcfg, lpips_pair)
    assert {"loss_percep_obj", "loss_ms_ssim", "loss_chamfer"} <= set(tld)
    assert_terms_and_grads(jld, jg, tld, tg)
    for k in ("prob", "color", "depth"):
        assert np.abs(np.asarray(jg["ren"][k])).max() > 0, k


def test_self_loss_pose_lab_linear_matches_jax(lpips_pair):
    """split_lab's loss (LAB weight 0) with a given lab_linear = (value, g):
    the term is the value, and g joins the colour's gradient."""
    jcfg, tcfg = self_cfgs(lab_lw=0.0)
    rng = np.random.default_rng(4)
    g = (1e-2 * rng.standard_normal((2, 32, 32, 3))).astype(np.float32)
    lin = (np.float32(0.37), g)
    jld, jg, tld, tg = run_both(jcfg, tcfg, lpips_pair, lab_linear=lin)
    assert_terms_and_grads(jld, jg, tld, tg)
    assert tld["loss_color_ab_obj"].item() == np.float32(0.37)
    _, jg0, _, _ = run_both(jcfg, tcfg, lpips_pair)
    assert not np.allclose(np.asarray(jg["ren"]["color"]),
                           np.asarray(jg0["ren"]["color"]))


@pytest.mark.parametrize("kw", [dict(perceptual_lw=0.15), dict(ms_ssim_lw=1.0),
                                dict(depth_chamfer_lw=1.0), dict(vf_lw=1.0),
                                dict(norm_lw=1.0), dict(lab_impl="surrogate")])
def test_self_loss_pose_names_the_later_slice(kw):
    """LPIPS, MS-SSIM and the chamfer, once of a later slice, now give
    their terms, and so do vf and norm (held against JAX's on seeded
    student maps and pseudo labels) and the LAB mode 'surrogate' (against
    JAX's and the port's 'direct' term); an unknown LAB mode raises,
    naming lab_impl."""
    _, tcfg = self_cfgs(**kw)
    ren, pred, pseudo, batch = loss_inputs()
    ported = {"perceptual_lw": "loss_percep_obj", "ms_ssim_lw": "loss_ms_ssim",
              "depth_chamfer_lw": "loss_chamfer", "vf_lw": "loss_vf",
              "norm_lw": "loss_norm"}
    (name,) = kw
    if name in ("vf_lw", "norm_lw"):
        rng = np.random.default_rng(9)
        key, ch = ("vf", 8) if name == "vf_lw" else ("norm", 3)
        shape = pred["coor"].shape[:3] + (ch,)
        pred[key] = rng.normal(0, 1, shape).astype(np.float32)
        pseudo[key] = rng.normal(0, 1, shape).astype(np.float32)
        jcfg = jc.SelfSupConfig(**{f.name: getattr(tcfg, f.name)
                                   for f in dataclasses.fields(tcfg)})
        to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
        jld = jsl.compute_self_loss_pose(jcfg, to_j(ren), to_j(pred),
                                         to_j(pseudo), to_j(batch))
    ren, pred, pseudo, batch = ({k: torch.from_numpy(v) for k, v in d.items()}
                                for d in (ren, pred, pseudo, batch))
    if name in ported:
        lp = TL.build_lpips("cpu")
        ld = tsl.compute_self_loss_pose(tcfg, ren, pred, pseudo, batch,
                                        lpips_fn=lp)
        assert torch.isfinite(ld[ported[name]])
        if name in ("vf_lw", "norm_lw"):
            np.testing.assert_allclose(ld[ported[name]].item(),
                                       float(jld[ported[name]]), rtol=RTOL)
        return
    jcfg = jc.SelfSupConfig(**{f.name: getattr(tcfg, f.name)
                               for f in dataclasses.fields(tcfg)})
    jld = jsl.compute_self_loss_pose(
        jcfg, *({k: jnp.asarray(v.numpy()) for k, v in d.items()}
                for d in (ren, pred, pseudo, batch)))
    ld = tsl.compute_self_loss_pose(tcfg, ren, pred, pseudo, batch)
    direct = tsl.compute_self_loss_pose(
        dataclasses.replace(tcfg, lab_impl="direct"), ren, pred, pseudo, batch)
    term = "loss_color_ab_obj"
    np.testing.assert_allclose(ld[term].item(), float(jld[term]), rtol=RTOL)
    assert ld[term].item() == direct[term].item()
    with pytest.raises(ValueError, match="lab_impl"):
        tsl.compute_self_loss_pose(dataclasses.replace(tcfg, lab_impl="fused"),
                                   ren, pred, pseudo, batch)


def test_inject_grad_adds_to_the_cotangent():
    x = torch.randn(4, 3, requires_grad=True)
    g = torch.randn(4, 3)
    y = tsl.InjectGrad.apply(x, g)
    torch.testing.assert_close(y, x.detach(), rtol=0, atol=0)
    (2 * y).sum().backward()
    torch.testing.assert_close(x.grad, 2 + g, rtol=0, atol=0)
