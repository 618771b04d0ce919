"""The port's vf/norm pieces and the stage-I loss against the JAX
package's, on the same numpy inputs, on the CPU: compute_vf and
project_pts, compute_vertex_normals, vf_loss, norm_loss,
compute_self_loss_geo, every term of gdrn_loss (xyz in L1 and CE_coor, the
five mask losses, the second mask, region, vf/norm, the PM variants, rot,
centroid, z, trans, bind, the MTL weighting) with their gradients, the
elementary losses and FPS; and two stage-II pose steps of the MaskNormVF
model with the vf and norm pseudo labels (the keypoint vector field of the
pseudo pose and its normals rendered at output resolution) against
make_self_train_step, the pseudo labels themselves held first.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine import self_engine as jse
from self6dpp_tpu.engine.optim import build_optimizer
from self6dpp_tpu.engine.train_state import create_train_state
from self6dpp_tpu.losses import common as jcom
from self6dpp_tpu.losses import gdrn_loss as jgl
from self6dpp_tpu.losses import mask_losses as jml
from self6dpp_tpu.losses import self_loss as jsl
from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu.ops import geometry as jgeo
from self6dpp_tpu.ops import rasterizer as jrast
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.convert import (gdrn_flax_to_state_dict,
                                        gdrn_state_dict_to_flax)
from self6dpp_tpu_torch.data.meshes import make_cube, make_icosphere
from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.engine import self_engine as tse
from self6dpp_tpu_torch.losses import common as tcom
from self6dpp_tpu_torch.losses import gdrn_loss as tgl
from self6dpp_tpu_torch.losses import mask_losses as tml
from self6dpp_tpu_torch.losses import self_loss as tsl
from self6dpp_tpu_torch.ops import fps as tfps
from self6dpp_tpu_torch.ops import geometry as tgeo
from self6dpp_tpu_torch.ops import rasterizer as trast
from test_torch_gdrn_train import jax_tree, to_jax
from test_torch_self_engine import aim, cpu_run, noisy

RTOL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
STEPS = 2


def grad_atol(ref):
    """1e-6 of the gradient's largest magnitude (a gradient element sums
    terms as large as that)."""
    return 1e-6 * float(np.abs(np.asarray(ref)).max()) + 1e-12


def both(jfn, tfn, inputs, diff=()):
    """(JAX value, JAX grads, port value, port grads) of fn(**inputs): the
    value a 0-d array (or a dict of them, summed for the gradient); the
    gradients with respect to the inputs named in diff."""
    j_in = {k: jnp.asarray(v) for k, v in inputs.items()}

    def jsum(d):
        out = jfn(**{**j_in, **d})
        return sum(jax.tree.leaves(out)), out
    (_, jv), jg = jax.jit(jax.value_and_grad(jsum, has_aux=True))(
        {k: j_in[k] for k in diff})
    t_in = {k: torch.tensor(v, requires_grad=k in diff)
            for k, v in inputs.items()}
    tv = tfn(**t_in)
    total = (sum(tv[k] for k in sorted(tv)) if isinstance(tv, dict) else tv)
    if diff:
        total.backward()
    return jv, jg, tv, {k: t_in[k].grad for k in diff}


def assert_both(jv, jg, tv, tg, rtol=RTOL):
    if isinstance(jv, dict):
        assert set(jv) == set(tv)
        for k in jv:
            np.testing.assert_allclose(tv[k].item(), float(jv[k]), rtol=rtol,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                                   rtol=rtol, atol=1e-7)
    live = 0
    for k, g in jg.items():
        g = np.asarray(g)
        got = np.zeros_like(g) if tg[k] is None else tg[k].numpy()
        np.testing.assert_allclose(got, g, rtol=rtol, atol=grad_atol(g),
                                   err_msg=k)
        live += bool(np.abs(g).max() > 0)
    assert live or not jg


def poses(b, seed):
    rng = np.random.default_rng(seed)
    R = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    t = np.stack([rng.uniform(-0.1, 0.1, b), rng.uniform(-0.1, 0.1, b),
                  rng.uniform(0.6, 1.2, b)], 1).astype(np.float32)
    return R, t


@pytest.mark.parametrize("masked", [False, True])
def test_compute_vf_matches_jax(masked):
    b, o, f = 3, 12, 5
    rng = np.random.default_rng(1)
    R, t = poses(b, 1)
    x = dict(fps_points=rng.normal(0, 0.05, (b, f, 3)).astype(np.float32),
             K=np.repeat(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0],
                                   [0, 0, 1]], np.float32)[None], b, 0),
             R=R, t=t,
             roi_center=rng.uniform(250, 400, (b, 2)).astype(np.float32),
             roi_scale=rng.uniform(80, 200, (b,)).astype(np.float32))
    x["mask"] = ((rng.uniform(size=(b, o, o)) > 0.5).astype(np.float32)
                 if masked else None)
    jv = jax.jit(lambda **a: jgeo.compute_vf(out_res=o, **a))(
        **{k: None if v is None else jnp.asarray(v) for k, v in x.items()})
    tv = tgeo.compute_vf(out_res=o, **{
        k: None if v is None else torch.from_numpy(v) for k, v in x.items()})
    assert tv.shape == (b, o, o, 2 * f)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(
        tgeo.project_pts(*(torch.from_numpy(x[k]) for k in
                           ("fps_points", "K", "R", "t"))).numpy(),
        np.asarray(jgeo.project_pts(*(jnp.asarray(x[k]) for k in
                                      ("fps_points", "K", "R", "t")))),
        rtol=RTOL)


@pytest.mark.parametrize("mesh", ["icosphere", "cube"])
def test_vertex_normals_match_jax(mesh):
    """index_add_ sums each vertex's faces in another order than XLA's
    scatter: within 1e-6 (icosphere vertices have 5-6 faces each)."""
    v, f = make_icosphere(0.06, 3) if mesh == "icosphere" else make_cube(0.1)
    jn = jax.jit(jrast.compute_vertex_normals)(jnp.asarray(v), jnp.asarray(f))
    tn = trast.compute_vertex_normals(torch.from_numpy(v), torch.from_numpy(f))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tn.numpy(), axis=-1), 1.0,
                               atol=1e-6)


def vf_norm_inputs(b=2, o=8, f=3, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    mask = (rng.uniform(size=(b, o, o)) > 0.4).astype(np.float32)
    return dict(pred_vf=n(b, o, o, 2 * f), gt_vf=n(b, o, o, 2 * f),
                pred_n=n(b, o, o, 3), gt_n=n(b, o, o, 3), mask=mask)


def test_vf_and_norm_losses_match_jax():
    x = vf_norm_inputs()
    x["gt_vf"][0, 0, 0, :2] = 0.0          # a zero vector: the 1e-6 floor
    vf = {k: x[k] for k in ("pred_vf", "gt_vf", "mask")}
    assert_both(*both(jsl.vf_loss, tsl.vf_loss, vf, diff=("pred_vf",)))
    nm = {k: x[k] for k in ("pred_n", "gt_n", "mask")}
    assert_both(*both(jsl.norm_loss, tsl.norm_loss, nm, diff=("pred_n",)))


def geo_inputs(b=2, o=8, regions=4, f=3, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    x = vf_norm_inputs(b, o, f, seed)
    e = np.exp(n(b, o, o, regions + 1))
    pred = {"mask_logits": n(b, o, o, 2), "coor": u(b, o, o, 3),
            "region_logits": n(b, o, o, regions + 1), "vf": x["pred_vf"],
            "norm": x["pred_n"]}
    pseudo = {"vis_mask_lr": x["mask"],
              "full_mask_lr": (u(b, o, o) > 0.3).astype(np.float32),
              "coor": u(b, o, o, 3),
              "region": (e / e.sum(-1, keepdims=True)).astype(np.float32),
              "vf": x["gt_vf"], "norm": x["gt_n"]}
    return pred, pseudo


@pytest.mark.parametrize("mask_type", ["RW_BCE", "BCE", "dice"])
def test_self_loss_geo_matches_jax(mask_type):
    from self6dpp_tpu.config import base as jc
    pred, pseudo = geo_inputs()
    t = dataclasses.replace(tc.SelfSupConfig(), vf_lw=0.7, norm_lw=1.3)
    j = dataclasses.replace(jc.SelfSupConfig(), vf_lw=0.7, norm_lw=1.3)
    inputs = {f"p_{k}": v for k, v in pred.items()}
    inputs.update({f"q_{k}": v for k, v in pseudo.items()})

    def make(sl, ml, cfg):
        def fn(**a):
            return sl.compute_self_loss_geo(
                cfg, {k[2:]: v for k, v in a.items() if k[:2] == "p_"},
                {k[2:]: v for k, v in a.items() if k[:2] == "q_"},
                mask_prob_fn=lambda lg: ml.get_mask_prob(lg, mask_type))
        return fn
    res = both(make(jsl, jml, j), make(tsl, tml, t), inputs,
               diff=tuple(f"p_{k}" for k in pred))
    assert set(res[2]) == {"loss_vis_mask_init_pred", "loss_full_mask_init_pred",
                           "loss_init_pred_xyz", "loss_region_init_pred",
                           "loss_vf", "loss_norm"}
    assert_both(*res)


def test_mask_loss_dispatch_matches_jax():
    rng = np.random.default_rng(3)
    gt = (rng.uniform(size=(2, 8, 8)) > 0.5).astype(np.float32)
    for kind in ("L1", "BCE", "RW_BCE", "dice", "CE"):
        logits = rng.normal(0, 2, (2, 8, 8, 2 if kind == "CE" else 1)
                            ).astype(np.float32)
        x = {"out_mask": logits, "gt_mask": gt}
        res = both(lambda **a: jml.mask_loss(loss_type=kind, **a),
                   lambda **a: tml.mask_loss(loss_type=kind, **a), x,
                   diff=("out_mask",))
        assert_both(*res)
    with pytest.raises(ValueError):
        tml.mask_loss(torch.zeros(1, 2, 2, 1), torch.zeros(1, 2, 2), "focal")


def test_elementary_losses_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1.5, (3, 5, 4)).astype(np.float32)
    b = rng.normal(0, 1.5, (3, 5, 4)).astype(np.float32)
    pairs = [("l1", jcom.l1, tcom.l1), ("l2", jcom.l2, tcom.l2),
             ("mse", jcom.mse, tcom.mse),
             ("smooth_l1", lambda p, g: jcom.smooth_l1(p, g, 0.7),
              lambda p, g: tcom.smooth_l1(p, g, 0.7)),
             ("sigmoid_bce", jcom.sigmoid_bce, tcom.sigmoid_bce)]
    for name, jf, tf in pairs:
        res = both(lambda pred, gt: jf(pred, gt).sum(),
                   lambda pred, gt: tf(pred, gt).sum(),
                   {"pred": a, "gt": (b > 0).astype(np.float32)
                    if name == "sigmoid_bce" else b}, diff=("pred",))
        assert_both(*res)
    labels = rng.integers(0, 4, (3, 5))
    res = both(lambda logits: jcom.softmax_ce(logits, jnp.asarray(labels)).sum(),
               lambda logits: tcom.softmax_ce(logits,
                                              torch.from_numpy(labels)).sum(),
               {"logits": a}, diff=("logits",))
    assert_both(*res)


def test_fps_matches_jax():
    """The numpy FPS (its argmax ties to the first index, as the JAX
    package's numpy path does; its native library may tie otherwise and is
    not called here) on a mesh with ties and on a random cloud."""
    cloud = np.random.default_rng(5).normal(0, 0.05, (300, 3)).astype(
        np.float32)
    for pts in (make_icosphere(0.06, 2)[0], cloud):
        for k, center in ((8, True), (16, False)):
            np.testing.assert_array_equal(tfps.fps_numpy(pts, k, center),
                                          jfps.fps_numpy(pts, k, center))
        np.testing.assert_array_equal(tfps.fps_points(pts, 8),
                                      pts[jfps.fps_numpy(pts, 8)])


# ---- gdrn_loss -------------------------------------------------------------

LOSS_CASES = {
    "default": {},
    "ce_coor_rw_bce": dict(xyz_loss_type="CE_coor", mask_loss_type="RW_BCE"),
    "dice_obj_masks": dict(mask_loss_type="dice", xyz_loss_mask_gt="obj",
                           region_loss_mask_gt="trunc", mask_loss_gt="visib"),
    "l1_mask_pm_rt": dict(mask_loss_type="L1", pm_r_only=False,
                          pm_loss_sym=False, pm_norm_by_extent=True,
                          trans_lw=1.0, bind_lw=0.5, rot_lw=0.3),
    "disentangle_z": dict(pm_r_only=False, pm_disentangle_z=True,
                          trans_lw=1.0, trans_loss_disentangle=False,
                          rot_loss_type="l2", rot_lw=0.2,
                          centroid_loss_type="smooth_l1", z_loss_type="mse",
                          bind_lw=1.0, bind_loss_type="smooth_l1"),
    "disentangle_t_nopoints": dict(pm_r_only=False, pm_disentangle_t=True,
                                   pm_t_use_points=False, pm_loss_type="MSE"),
    "mtl": dict(),
}


def gdrn_loss_inputs(xyz_bin, seed=0):
    cfg = tc.masknormvf_tiny()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, geo_head=dataclasses.replace(cfg.model.geo_head,
                                                xyz_bin=xyz_bin)))
    batch = make_gdrn_batch(cfg, 2, seed=seed, n_points=32)
    rng = np.random.default_rng(seed + 10)
    b, o = 2, cfg.model.output_res
    n = lambda *s, sd=1.0: rng.normal(0, sd, s).astype(np.float32)
    R, t = poses(b, seed + 11)
    out = {"coor": rng.uniform(0, 1, (b, o, o, 3)).astype(np.float32),
           "coor_logits": n(b, o, o, 3, 65),
           "mask_logits": n(b, o, o, 2, sd=2.0),
           "region_logits": n(b, o, o, cfg.model.geo_head.num_regions + 1),
           "vf": n(b, o, o, 4 * cfg.model.geo_head.num_vf_points),
           "norm": n(b, o, o, 3), "rot": R, "trans": t,
           "pred_t_net": batch["gt_trans_ratio"] + n(b, 3, sd=0.05)}
    batch["sym_valid"][0, 1] = True
    batch["sym_rots"][0, 1] = Rotation.from_euler(
        "z", 180, degrees=True).as_matrix().astype(np.float32)
    return cfg, out, batch


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_gdrn_loss_matches_jax(case):
    """Every term's value and its gradient with respect to every output."""
    kw = LOSS_CASES[case]
    cfg, out, batch = gdrn_loss_inputs(
        64 if kw.get("xyz_loss_type") == "CE_coor" else 1)
    t_loss = dataclasses.replace(cfg.model.loss, **kw)
    j_loss, j_pnp = to_jax(t_loss), to_jax(cfg.model.pnp_net)
    mtl = None
    if case == "mtl":
        rng = np.random.default_rng(7)
        mtl = {k: rng.normal(0, 0.5, (1,)).astype(np.float32)
               for k in tgl.MTL_TERMS}
    inputs = {f"o_{k}": v for k, v in out.items()}
    inputs.update({f"b_{k}": v for k, v in batch.items()})
    if mtl is not None:
        inputs.update({f"m_{k}": v for k, v in mtl.items()})
    gh = cfg.model.geo_head

    def make(gl, lcfg, pcfg):
        def fn(**a):
            part = lambda p: {k[2:]: v for k, v in a.items() if k[:2] == p}
            return gl.gdrn_loss(lcfg, pcfg, part("o_"), part("b_"),
                                num_regions=gh.num_regions, xyz_bin=gh.xyz_bin,
                                mtl_log_vars=part("m_") or None)
        return fn
    diff = tuple(f"o_{k}" for k in out) + tuple(f"m_{k}" for k in (mtl or {}))
    res = both(make(jgl, j_loss, j_pnp), make(tgl, t_loss, cfg.model.pnp_net),
               inputs, diff=diff)
    assert {"loss_vf_vis", "loss_vf_full", "loss_norm",
            "loss_mask_full"} <= set(res[2])
    assert_both(*res)


# ---- the MaskNormVF pose step ----------------------------------------------

def pose_setup():
    """stage2_pose_tiny with the MaskNormVF heads (4 vector-field points)
    and the pose step's vf and norm terms at weight 1; LPIPS out (lpips
    None on both sides, as the JAX step runs without lpips_params). The
    batch is tests/test_self_engine.py's: the cube, its vertex normals
    (compute_vertex_normals) and its first 8 vertices as mesh_fps, the
    ground-truth pose as the loaded pseudo pose; its image the cube
    rendered at that pose, half mixed with noise (see
    test_torch_self_engine.setup). Teacher and EMA ramp as there."""
    t = tc.masknormvf_tiny()
    t = dataclasses.replace(
        t, solver=dataclasses.replace(t.solver, ema_warmup_iters=1),
        self_sup=dataclasses.replace(t.self_sup, vf_lw=1.0, norm_lw=1.0,
                                     perceptual_lw=0.0))
    tb = tse.stage2_batch(t, 2, "cpu", mesh=make_cube(0.15))
    tb["mesh_normals"] = torch.stack([trast.compute_vertex_normals(v, f)
                                      for v, f in zip(tb["mesh_verts"],
                                                      tb["mesh_faces"])])
    tb["mesh_fps"] = tb["mesh_verts"][:, :8].clone()
    tb["pseudo_rot"], tb["pseudo_trans"] = tb["gt_rot"], tb["gt_trans"]
    with torch.no_grad():
        gt = tse.render_student_pose(t, tb, tb["gt_rot"], tb["gt_trans"])
    tb["roi_img"] = 0.5 * tb["roi_img"] + 0.5 * gt["color"]
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    z_rel = float(np.median(tb["gt_trans"][:, 2].numpy()
                            / tb["resize_ratio"].numpy()))
    jcfg = to_jax(t)
    jmodel = jge.build_gdrn(jcfg)
    variables = aim(gdrn_state_dict_to_flax(
        tge.build_gdrn(t, device="cpu", seed=0)), z_rel)
    teacher = {"params": noisy(variables["params"]),
               "batch_stats": variables["batch_stats"]}
    return dict(t=t, jcfg=jcfg, tb=tb, jb=jb, jmodel=jmodel,
                variables=variables, teacher=teacher)


def _pose_runs():
    s = pose_setup()
    tx, _ = build_optimizer(s["jcfg"].solver, flatten=True)
    jstate = create_train_state(jax_tree(s["variables"]["params"]),
                                jax_tree(s["variables"]["batch_stats"]), tx)
    jstate = jstate.replace(ema_params=jax_tree(s["teacher"]["params"]))
    jstep = jax.jit(jse.make_self_train_step(s["jcfg"], s["jmodel"], None))
    jm = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, None, s["jb"], jax.random.PRNGKey(0))
        jm.append({k: float(v) for k, v in m.items()})

    t = s["t"]
    model = tge.build_gdrn(t, device="cpu")
    model.load_state_dict(gdrn_flax_to_state_dict(s["variables"], model))
    state = tge.init_state(t, model)
    state.teacher.load_state_dict(gdrn_flax_to_state_dict(s["teacher"], model))
    # the pseudo labels of the first step, beside JAX's from its own ops
    with torch.no_grad():
        tout = state.teacher(*tge.model_inputs(s["tb"]))
    labels = tse.vf_norm_labels(t, s["tb"], tout, s["tb"]["pseudo_rot"],
                                s["tb"]["pseudo_trans"])
    step = tse.make_self_train_step(t, model, None)
    tm = []
    for _ in range(STEPS):
        state, m = step(state, s["tb"])
        tm.append({k: float(v) for k, v in m.items()})
    return dict(s=s, jstate=jstate, jm=jm, tstate=state, tm=tm,
                labels=labels, init=gdrn_flax_to_state_dict(s["variables"],
                                                            model))


@pytest.fixture(scope="module")
def pose_runs():
    return cpu_run(_pose_runs)


def jax_pseudo_labels(jcfg, jb):
    """The JAX step's vf and norm pseudo labels at the loaded pose, from
    its public ops as self6dpp_tpu/engine/self_engine.py:246-280 composes
    them (renderer impl 'xla' on the CPU)."""
    o, s = jcfg.model.output_res, jcfg.model.input_res
    f = jcfg.model.geo_head.num_vf_points

    def fn(b):
        cls = b["roi_cls"]
        rot, trans = b["pseudo_rot"], b["pseudo_trans"]
        vf = jgeo.compute_vf(b["mesh_fps"][cls][:, :f], b["roi_cam"], rot,
                             trans, b["roi_center"], o / b["resize_ratio"], o)
        n_cam = jnp.einsum("bij,bvj->bvi", rot, b["mesh_normals"][cls])
        r = o / s
        Ko = jnp.einsum("ij,bjk->bik", jnp.asarray(
            [[r, 0, 0], [0, r, 0], [0, 0, 1.0]]), b["roi_zoom_K"])
        ren = jrast.rasterize_batch(
            b["mesh_verts"][cls], b["mesh_faces"][cls], n_cam, Ko, rot,
            trans, height=o, width=o,
            tile_px=min(jcfg.renderer.tile_px, o),
            faces_per_tile=jcfg.renderer.faces_per_tile, with_prob=False,
            impl="xla")
        nrm = ren.attr / jnp.maximum(
            jnp.linalg.norm(ren.attr, axis=-1, keepdims=True), 1e-8)
        return {"vf": jnp.concatenate([vf, vf], -1),
                "norm": nrm * ren.mask[..., None]}
    return jax.jit(fn)(jb)


def test_pose_step_pseudo_labels_match_jax(pose_runs):
    s = pose_runs["s"]
    ref = jax_pseudo_labels(s["jcfg"], s["jb"])
    got = pose_runs["labels"]
    assert set(got) == {"vf", "norm"}
    covered = (np.abs(np.asarray(ref["norm"])).sum(-1) > 0)
    assert covered.mean() > 0.05, covered.mean()
    for k in ("vf", "norm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=1e-5, err_msg=k)


def test_pose_step_vf_norm_matches_jax(pose_runs):
    """Two pose steps with the vf and norm terms: every term, the
    parameters and the teacher as the JAX step's."""
    for jm, tm in zip(pose_runs["jm"], pose_runs["tm"]):
        assert set(jm) == set(tm)
        assert {"loss_vf", "loss_norm"} <= set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=STEP_RTOL,
                                       err_msg=k)
    j, ts = pose_runs["jstate"], pose_runs["tstate"]
    init = pose_runs["init"]
    for which, net in (("params", ts.model), ("ema_params", ts.teacher)):
        ref = gdrn_flax_to_state_dict(
            {"params": getattr(j, which), "batch_stats": j.batch_stats},
            ts.model)
        moved = 0.0
        for k, v in net.named_parameters():
            v = v.detach()
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"{which} {k}")
            moved = max(moved, ((v - init[k]).abs()
                                / (STEP_ATOL + STEP_RTOL * init[k].abs())
                                ).max().item())
        assert moved > 10, (which, moved)
