"""The port's reprojection refiner against the JAX package's, in float32 on
the CPU: every repj_weak_loss term and its gradient with respect to the
student's rotations and translations, the best-view choice, and 5 Adam
steps of refine_pose_reprojection. The JAX side renders on its XLA path
(its repj renders never reach the Pallas kernel: rasterize_batch without
an impl); the port on its plain fine stage."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from self6dpp_tpu.models import repj_refiner as jrr
from self6dpp_tpu_torch.data.meshes import make_cube, make_icosphere
from self6dpp_tpu_torch.models import repj_refiner as trr
from self6dpp_tpu_torch.ops.rasterizer import rasterize_batch

RTOL, ATOL = 1e-4, 1e-6


def views(b=3):
    """tests/test_repj_refiner.py's scene: b views of one icosphere (a
    static scene T_i), K at focal 280 in a 480x640 frame, PM points and
    extents; the student's poses T_i with view 1 turned by 40 degrees and
    moved 5 cm, view 2 by 8 degrees; seeded mask probabilities whose best
    view is 1 (vis = full there)."""
    verts, faces = make_icosphere(0.08, 1)
    colors = ((verts - verts.min(0)) / np.ptp(verts, 0)).astype(np.float32)
    gR = Rotation.random(b, random_state=1).as_matrix().astype(np.float32)
    gt = np.stack([np.array([0.02, -0.01, 1.0 + 0.1 * i], np.float32)
                   for i in range(b)])
    K = np.broadcast_to(np.array([[280.0, 0, 320], [0, 280.0, 240], [0, 0, 1]],
                                 np.float32), (b, 3, 3)).copy()
    rep = lambda a: np.ascontiguousarray(np.broadcast_to(a, (b,) + a.shape))
    kw = dict(verts=rep(verts), faces=rep(faces), colors=rep(colors), K=K,
              points=rep(verts[:32]), extents=rep(np.ptp(verts, 0)),
              gt_rot=gR, gt_trans=gt)
    rot = gR.copy()
    rot[1] = Rotation.from_euler("y", 40, degrees=True).as_matrix() @ gR[1]
    rot[2] = Rotation.from_euler("x", 8, degrees=True).as_matrix() @ gR[2]
    trans = gt.copy()
    trans[1, 0] += 0.05
    rng = np.random.default_rng(0)
    full = rng.uniform(0.3, 1.0, (b, 16, 16)).astype(np.float32)
    vis = (full * rng.uniform(0.5, 1.0, full.shape)).astype(np.float32)
    vis[1] = full[1]
    return rot.astype(np.float32), trans, vis, full, kw


@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_repj_weak_loss_and_grad_match_jax(sym):
    rot, trans, vis, full, kw = views()
    if sym:
        b = len(rot)
        flip = Rotation.from_euler("z", 180, degrees=True).as_matrix()
        kw["sym_rots"] = np.stack([np.eye(3), flip]).astype(np.float32)[None] \
            .repeat(b, 0)
        kw["sym_valid"] = np.ones((b, 2), bool)

    def jfn(r, t):
        ld = jrr.repj_weak_loss(r, t, jnp.asarray(vis), jnp.asarray(full),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        return sum(jax.tree.leaves(ld)), ld
    (jtot, jld), (jgr, jgt) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(rot), jnp.asarray(trans))
    tr = torch.from_numpy(rot).requires_grad_(True)
    tt = torch.from_numpy(trans).requires_grad_(True)
    tld = trr.repj_weak_loss(tr, tt, torch.from_numpy(vis),
                             torch.from_numpy(full),
                             **{k: torch.from_numpy(v) for k, v in kw.items()},
                             raster_kw={"impl": "plain"})
    assert set(tld) == set(jld)
    for k in jld:
        np.testing.assert_allclose(tld[k].item(), float(jld[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert {"loss_PM_R_repj", "loss_PM_T_repj", "loss_repj_3d2d_iou",
            "loss_repj_miou_1", "loss_repj_msssim_4"} <= set(tld)
    sum(tld[k] for k in sorted(tld)).backward()
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), rtol=RTOL,
                               atol=1e-5)
    # the render terms reach the pose: the gradient without them differs
    only = {k: v for k, v in jld.items() if "miou" in k or "msssim" in k}
    assert all(float(v) > 0 for v in only.values()), only
    assert np.abs(np.asarray(jgt)).max() > 1e-3


def test_best_view_is_the_first_maximum():
    """Two views tie for the best agreement: both packages anchor on the
    first (argmax's first maximum)."""
    rot, trans, vis, full, kw = views()
    vis[2] = full[2]                       # views 1 and 2 agree perfectly
    best, anchor, _ = trr.repj_inputs(
        *map(torch.from_numpy, (rot, trans, vis, full, kw["gt_rot"],
                                kw["gt_trans"], kw["verts"], kw["faces"],
                                kw["colors"], kw["K"])))
    assert best.tolist() == [1]
    np.testing.assert_array_equal(anchor[0].numpy(), np.repeat(rot[1:2], 3, 0))
    # JAX: the anchor's PM term is 0 for view 1 and not for view 2
    ld = jrr.repj_weak_loss(jnp.asarray(rot), jnp.asarray(trans),
                            jnp.asarray(vis), jnp.asarray(full),
                            **{k: jnp.asarray(v) for k, v in kw.items()},
                            w_miou=0.0, w_msssim=0.0, w_iou2d3d=0.0)
    tl = trr.repj_weak_loss(*map(torch.from_numpy, (rot, trans, vis, full)),
                            **{k: torch.from_numpy(v) for k, v in kw.items()},
                            w_miou=0.0, w_msssim=0.0, w_iou2d3d=0.0,
                            raster_kw={"impl": "plain"})
    for k in ("loss_PM_R_repj", "loss_PM_T_repj"):
        np.testing.assert_allclose(tl[k].item(), float(ld[k]), rtol=RTOL)


def test_refine_pose_reprojection_matches_jax():
    """5 Adam steps against a box, a mask and an image rendered at the GT
    pose (every energy term on), from a pose turned by about 6 degrees and
    6 cm off in x, 15 cm in z: the refined pose at 1e-4, well moved. The
    PM tie to the initial pose is |0| at the first step, where
    jnp.abs's derivative is +1 and torch's 0: the port's energy takes
    JAX's, or the second step is already 4e-5 m apart."""
    verts, faces = make_cube(size=0.2)
    colors = ((verts - verts.min(0)) / np.ptp(verts, 0)).astype(np.float32)
    K = np.array([[[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]]], np.float32)
    R_gt = Rotation.from_euler("xyz", [30, 20, 10], degrees=True).as_matrix()
    R_gt = R_gt.astype(np.float32)[None]
    t_gt = np.array([[0.0, 0.0, 1.0]], np.float32)
    tgt = rasterize_batch(verts, faces, colors, K, R_gt, t_gt, height=64,
                          width=64, tile_px=16, faces_per_tile=64,
                          impl="plain", device="cpu")
    ys, xs = np.nonzero(tgt.mask[0].numpy())
    box = np.array([[xs.min(), ys.min(), xs.max(), ys.max()]], np.float32)
    R_init = (Rotation.from_euler("xyz", [5, -4, 3], degrees=True).as_matrix()
              @ R_gt[0]).astype(np.float32)[None]
    t_init = t_gt + np.array([[0.06, 0.0, 0.15]], np.float32)
    args = (R_init, t_init, verts, faces, colors, K, box)
    kw = dict(height=64, width=64, n_steps=5, lr=5e-3, w_pm=0.1, w_ssim=0.5)
    mask, img = tgt.mask.numpy(), tgt.attr.numpy()
    jr, jt = jax.jit(lambda *a: jrr.refine_pose_reprojection(
        *a, target_mask=jnp.asarray(mask), target_img=jnp.asarray(img),
        **kw))(*map(jnp.asarray, args))
    tr, tt = trr.refine_pose_reprojection(
        *map(torch.from_numpy, args), target_mask=torch.from_numpy(mask),
        target_img=torch.from_numpy(img), raster_kw={"impl": "plain"}, **kw)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL, atol=1e-5)
    assert np.abs(tt.numpy() - t_init).sum() > 5e-3     # it moved
    assert np.abs(tr.numpy() - R_init).max() > 5e-3
