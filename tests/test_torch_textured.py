"""Textured meshes in the stage-II render (YCB-V) against the JAX package,
in float32 on the CPU. Two textured models that the test writes (ascii
PLYs with per-vertex normals and BOP texture_u/texture_v, and PNG atlases
of two sizes) go through both packages' ObjectModels (atlases padded to a
common size, UVs rescaled, v flipped once). Then:

  * render_student_pose on them: the UVs rasterised (D = 2) and the class
    atlas sampled, against JAX at impl="xla": colour, silhouette, mask and
    depth within 1e-5; the gradients of a colour loss into the rotation and
    the translation within 1e-4;
  * render_textured and render_shaded (the stand-alone forms) likewise;
  * two ycbv_ss-shaped pose steps (2 classes, test widths: lm_ss's loss
    family with LAB 0.2, LPIPS and MS-SSIM; the teacher 5 % away from the
    student, as tests/test_torch_self_engine.py sets it up): every loss
    and the updated parameters within 1e-4.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self6dpp_tpu.data import loader as jloader
from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine import self_engine as jse
from self6dpp_tpu.models.lpips import LPIPS
from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu.ops import rasterizer as JR
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.convert import gdrn_flax_to_state_dict
from self6dpp_tpu_torch.data import loader as tloader
from self6dpp_tpu_torch.data.meshes import make_icosphere
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.engine import self_engine as tse
from self6dpp_tpu_torch.ops import rasterizer as TR
from test_torch_gdrn import port_to_flax
import test_torch_self_engine as tst

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
STEPS = 2       # Ranger's first update alone moves little
ATLAS_HW = ((48, 64), (40, 56))


def write_textured_ply(path, verts_mm, faces, normals, uv, texture_file):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"comment TextureFile {texture_file}\n"
                f"element vertex {len(verts_mm)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property float nx\nproperty float ny\nproperty float nz\n"
                "property float texture_u\nproperty float texture_v\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        for v, n, t in zip(verts_mm, normals, uv):
            f.write(" ".join(f"{x:.6f}" for x in (*v, *n, *t)) + "\n")
        for fc in faces:
            f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """Two icospheres (radius 60 and 50 mm, 320 faces) with spherical UVs
    and seeded smooth atlases of two sizes."""
    d = tmp_path_factory.mktemp("textured")
    rng = np.random.default_rng(0)
    paths = []
    for i, ((h, w), r) in enumerate(zip(ATLAS_HW, (60.0, 50.0))):
        v, f = make_icosphere(1.0, 2)
        n = v / np.linalg.norm(v, axis=1, keepdims=True)
        uv = np.stack([0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi),
                       0.5 + np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi], 1)
        small = rng.random((h // 8, w // 8, 3)) * 255
        atlas = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
        tex = f"obj_{i + 1:06d}.png"
        cv2.imwrite(str(d / tex), atlas.astype(np.uint8))
        p = str(d / f"obj_{i + 1:06d}.ply")
        write_textured_ply(p, v * r, f, n, uv, tex)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def models(model_files):
    kw = dict(n_regions=4, n_points=32, max_sym=4)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfps, "_lib", False)
    try:
        jm = jloader.ObjectModels.from_ply_files(["a", "b"], model_files,
                                                 **kw)
    finally:
        mp.undo()
    tm = tloader.ObjectModels.from_ply_files(["a", "b"], model_files, **kw)
    return jm, tm


def textured_batch(tm, cfg, batch_size=2):
    """stage2_batch with the models' meshes, UVs and atlases as the
    per-class tables."""
    b = tse.stage2_batch(cfg, batch_size, "cpu")
    for key, arr in (("mesh_verts", tm.verts), ("mesh_faces", tm.faces),
                     ("mesh_colors", tm.colors), ("mesh_uv", tm.uvs),
                     ("mesh_texture", tm.textures)):
        b[key] = torch.as_tensor(arr)
    return b


def xla_cfg(tcfg):
    jcfg = tst.jax_cfg(tcfg)
    return dataclasses.replace(jcfg, renderer=dataclasses.replace(
        jcfg.renderer, impl="xla"))


def test_object_models_read_the_same_textures(models):
    jm, tm = models
    assert tm.textures.shape == (2, 48, 64, 3)
    np.testing.assert_array_equal(tm.textures, jm.textures)
    np.testing.assert_array_equal(tm.uvs, jm.uvs)
    np.testing.assert_array_equal(tm.verts, jm.verts)
    assert tm.uvs.min() >= 0 and tm.uvs.max() <= 1


def _pose_perturbed(batch, seed=1):
    """The ground-truth poses turned a little (a loss of the colour then
    has a gradient that is not zero)."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    dR = torch.as_tensor(Rotation.from_rotvec(
        rng.normal(0, 0.05, (len(batch["gt_rot"]), 3))).as_matrix(),
        dtype=torch.float32)
    rot = dR @ batch["gt_rot"]
    trans = batch["gt_trans"] + torch.as_tensor(
        rng.normal(0, 0.005, (len(rot), 3)), dtype=torch.float32)
    return rot, trans


def test_render_student_pose_textured_matches_jax(models):
    _, tm = models
    tcfg = tc.stage2_pose_tiny()
    tb = textured_batch(tm, tcfg)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    rot, trans = _pose_perturbed(tb)
    w = torch.as_tensor(np.random.default_rng(2).random(
        (2, 64, 64, 3)), dtype=torch.float32)

    rot_t = rot.clone().requires_grad_(True)
    trans_t = trans.clone().requires_grad_(True)
    ren = tse.render_student_pose(tcfg, tb, rot_t, trans_t, impl="plain")
    (ren["color"] * w).sum().backward()

    jcfg = xla_cfg(tcfg)

    def jloss(r, t):
        out = jse.render_student_pose(jcfg, jb, r, t)
        return (out["color"] * jnp.asarray(w.numpy())).sum(), out
    (_, jout), (gr, gt) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(rot.numpy()), jnp.asarray(trans.numpy()))
    assert float(ren["mask"].sum()) > 200        # the mesh is in view
    assert float(ren["color"].detach().std()) > 0.05     # the atlas shows
    for k in ("color", "prob", "mask", "depth"):
        np.testing.assert_allclose(ren[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=0,
                                   atol=FWD_TOL, err_msg=k)
    for got, ref, name in ((rot_t.grad, gr, "rot"), (trans_t.grad, gt,
                                                     "trans")):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 1.0, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["textured", "lambertian", "phong", "sh"])
def test_standalone_renders_match_jax(models, mode):
    """render_textured with a shared atlas, and render_shaded on the UV
    atlas in each lighting mode, against the JAX functions (xla)."""
    _, tm = models
    v, f, uv, n = tm.verts[0], tm.faces[0], tm.uvs[0], tm.normals[0]
    tex = tm.textures[0]
    K = np.array([[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]], np.float32)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec([[0.3, -0.2, 0.1], [-0.1, 0.4, 0.0]]
                             ).as_matrix().astype(np.float32)
    t = np.array([[0.0, 0.01, 0.45], [0.01, -0.01, 0.5]], np.float32)
    kw = dict(height=64, width=64, tile_px=16, faces_per_tile=128)
    if mode == "textured":
        got = TR.render_textured(v, f, uv, tex, K, R, t, impl="plain",
                                 device="cpu", **kw)
        ref = JR.render_textured(v, f, uv, tex, K, R, t, impl="xla", **kw)
        keys = ("color", "prob", "mask", "depth")
    else:
        extra = dict(mode=mode, uv=uv, texture=tex)
        if mode == "sh":
            extra["sh_coeffs"] = np.random.default_rng(0).normal(
                0.5, 0.2, (2, 9)).astype(np.float32)
        got = TR.render_shaded(v, f, n, K, R, t, impl="plain", device="cpu",
                               **extra, **kw)
        ref = JR.render_shaded(v, f, n, K, R, t, impl="xla", **extra, **kw)
        keys = ("color", "prob", "mask", "depth", "normal")
    assert float(got["mask"].sum()) > 500
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=FWD_TOL, err_msg=k)


# --------------------------------------------------------- the pose step
def ycbv_ss_tiny():
    """stage2_pose_tiny with self6dpp_ycbv_ss's loss family and solver
    (RW_BCE with edge weights, LPIPS 0.15, MS-SSIM 1, LAB 0.2, pseudo PM
    10, Ranger with clip 35; its learning rate at the tiny config's 1e-3
    without warm-up, so that one step moves the weights), the EMA over 1
    step."""
    t = tc.stage2_pose_tiny()
    y = tc.self6dpp_ycbv_ss()
    return dataclasses.replace(
        t, exp_name="ycbv_ss_tiny", self_sup=y.self_sup,
        solver=dataclasses.replace(y.solver, base_lr=1e-3, warmup_iters=0,
                                   ims_per_batch=2, reference_bs=2,
                                   ema_warmup_iters=1))


def _step_run(tm):
    tcfg = ycbv_ss_tiny()
    jcfg = xla_cfg(tcfg)
    tb = textured_batch(tm, tcfg)
    with torch.no_grad():
        gt = tse.render_student_pose(tcfg, tb, tb["gt_rot"], tb["gt_trans"],
                                     impl="plain")
    # the image: the textured mesh at its ground-truth pose over the noise
    tb["roi_img"] = 0.5 * tb["roi_img"] + 0.5 * gt["color"]
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    z_rel = float(np.median(tb["gt_trans"][:, 2].numpy()
                            / tb["resize_ratio"].numpy()))
    jmodel = jge.build_gdrn(jcfg)
    shapes = jax.eval_shape(
        lambda k, *a: jmodel.init(k, *a, train=False), jax.random.PRNGKey(0),
        *jge.model_inputs(jb))
    variables = tst.aim(port_to_flax(tge.build_gdrn(tcfg, device="cpu",
                                                    seed=0), shapes), z_rel)
    teacher = {"params": tst.noisy(variables["params"]),
               "batch_stats": variables["batch_stats"]}
    lp = jax.jit(LPIPS().init)(jax.random.PRNGKey(1), jb["roi_img"],
                               jb["roi_img"])["params"]
    from self6dpp_tpu_torch.convert import lpips_flax_to_state_dict
    from self6dpp_tpu_torch.models import lpips as TL
    tlpips = TL.LPIPS()
    tlpips.load_state_dict(lpips_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, lp), tlpips))
    s = dict(tcfg=tcfg, jcfg=jcfg, tb=tb, jb=jb, jmodel=jmodel,
             variables=variables, teacher=teacher, lp=lp,
             tlpips=tlpips.eval().requires_grad_(False))

    jstate = tst.jax_state(s)
    jstep = jax.jit(jse.make_self_train_step(jcfg, jmodel, LPIPS()))
    jms = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, lp, jb, jax.random.PRNGKey(0))
        jms.append({k: float(v) for k, v in jm.items()})
    tstate, tms = tst.port_run(s, tcfg, STEPS)
    return dict(jstate=jstate, jms=jms, tstate=tstate, tms=tms,
                init=gdrn_flax_to_state_dict(variables, tstate.model))


@pytest.fixture(scope="module")
def step_run(models):
    return tst.cpu_run(lambda: _step_run(models[1]))


def test_ycbv_ss_step_losses_match_jax(step_run):
    for jm, tm in zip(step_run["jms"], step_run["tms"]):
        assert set(jm) == set(tm)
        assert {"loss_color_ab_obj", "loss_percep_obj", "loss_ms_ssim",
                "loss_mask_self"} <= set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=GRAD_TOL,
                                       err_msg=k)
            assert tm[k] > 0, k


def test_ycbv_ss_step_params_match_jax(step_run):
    j, ts = step_run["jstate"], step_run["tstate"]
    ref = gdrn_flax_to_state_dict({"params": j.params,
                                   "batch_stats": j.batch_stats}, ts.model)
    got = tst._params(ts.model)
    init = step_run["init"]
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=GRAD_TOL,
                                   atol=tst.ATOL, err_msg=k)
    moved = max(((got[k] - init[k]).abs()
                 / (tst.ATOL + GRAD_TOL * init[k].abs())).max().item()
                for k in got)
    assert moved > 100, moved
