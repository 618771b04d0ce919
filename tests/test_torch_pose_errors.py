"""The port's pose errors (torch) against the JAX package's on the CPU:
every error within 1e-5 relative, VSD on depths rendered by the port's
rasterizer, the recall, BOP19 and AUC tables equal."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp
from self6dpp_tpu.ops import pose_errors as JPE
from self6dpp_tpu_torch.data.meshes import make_icosphere
from self6dpp_tpu_torch.ops import pose_errors as TPE
from self6dpp_tpu_torch.ops.rasterizer import rasterize_batch

B, N, S = 6, 64, 4


@pytest.fixture(scope="module")
def poses():
    rng = np.random.default_rng(0)
    f32 = lambda x: np.asarray(x, np.float32)
    R_gt = f32(Rotation.random(B, random_state=1).as_matrix())
    dR = Rotation.from_euler("xyz", rng.normal(0, 10, (B, 3)), degrees=True)
    R_est = f32(dR.as_matrix() @ R_gt)
    t_gt = f32(np.array([0.0, 0.0, 0.8]) + rng.normal(0, 0.05, (B, 3)))
    t_est = f32(t_gt + rng.normal(0, [0.01, 0.01, 0.03], (B, 3)))
    pts = f32(rng.uniform(-0.05, 0.05, (B, N, 3)))
    K = f32(np.broadcast_to([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                            (B, 3, 3)))
    sym = f32(np.broadcast_to(np.eye(3), (B, S, 3, 3)).copy())
    sym[:, 1] = np.diag([-1.0, -1.0, 1.0])
    sym[:, 2] = Rotation.from_euler("z", 90, degrees=True).as_matrix()
    valid = np.array([True, True, False, False])[None].repeat(B, 0)
    valid[::2, 2] = True
    return dict(R_est=R_est, t_est=t_est, R_gt=R_gt, t_gt=t_gt, pts=pts,
                K=K, sym=sym, valid=valid)


def both(name, *args):
    j = np.asarray(getattr(JPE, name)(*(jnp.asarray(a) for a in args)))
    t = getattr(TPE, name)(*(torch.as_tensor(a) for a in args)).numpy()
    return j, t


@pytest.mark.parametrize("name,keys", [
    ("add_error", ("R_est", "t_est", "R_gt", "t_gt", "pts")),
    ("adi_error", ("R_est", "t_est", "R_gt", "t_gt", "pts")),
    ("re_error", ("R_est", "R_gt")),
    ("te_error", ("t_est", "t_gt")),
    ("proj_error", ("R_est", "t_est", "R_gt", "t_gt", "K", "pts")),
    ("mssd_error", ("R_est", "t_est", "R_gt", "t_gt", "pts", "sym", "valid")),
    ("mspd_error", ("R_est", "t_est", "R_gt", "t_gt", "K", "pts", "sym",
                    "valid"))])
def test_errors_match_jax(poses, name, keys):
    j, t = both(name, *(poses[k] for k in keys))
    assert t.shape == j.shape == (B,) and t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)


def test_add_or_adi_and_exact_poses_match_jax(poses):
    p = poses
    is_sym = np.array([True, False] * (B // 2))
    j, t = both("add_or_adi_error", p["R_est"], p["t_est"], p["R_gt"],
                p["t_gt"], p["pts"], is_sym)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)
    # at the ground truth the pairwise |a|^2 + |b|^2 - 2 a.b form leaves
    # float32 rounding (clamped at 0, then the square root): both packages
    # read the same small distances, far below the 2 % of diameter tables
    j, t = both("adi_error", p["R_gt"], p["t_gt"], p["R_gt"], p["t_gt"],
                p["pts"])
    np.testing.assert_allclose(t, j, rtol=0, atol=5e-5)
    assert (t < 2e-4).all()


def test_vsd_matches_jax_on_rendered_depths(poses):
    p = poses
    verts, faces = make_icosphere(0.05, 2)
    kw = dict(height=120, width=160, tile_px=16, faces_per_tile=128,
              with_prob=False, impl="plain", device="cpu")
    K = p["K"].copy()
    K[:, :2, 2] = [80.0, 60.0]
    K[:, 0, 0] = K[:, 1, 1] = 200.0
    d_est = rasterize_batch(verts, faces, verts, K, p["R_est"], p["t_est"],
                            **kw).depth.numpy()
    d_gt = rasterize_batch(verts, faces, verts, K, p["R_gt"], p["t_gt"],
                           **kw).depth.numpy()
    assert (d_gt > 0).sum() > 1000
    # observed depth: the GT scene, nearer by 3 cm on the left half (an
    # occluder) and missing on some rows
    d_obs = d_gt.copy()
    d_obs[:, :, :80] -= 0.03 * (d_obs[:, :, :80] > 0)
    d_obs[:, ::7] = 0
    for obs in (d_obs, np.zeros_like(d_obs)):
        for kw in ({"taus": JPE.BOP19_TH, "K": K, "diameter": 0.1},
                   {"taus": (0.01, 0.02), "delta": 0.02}):
            j = np.asarray(JPE.vsd_error(
                jnp.asarray(d_est), jnp.asarray(d_gt), jnp.asarray(obs),
                **{k: jnp.asarray(v) if k == "K" else v
                   for k, v in kw.items()}))
            t = TPE.vsd_error(
                torch.as_tensor(d_est), torch.as_tensor(d_gt),
                torch.as_tensor(obs),
                **{k: torch.as_tensor(v) if k == "K" else v
                   for k, v in kw.items()}).numpy()
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)
    j, t = both("depth_to_dist", d_gt, K)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    # an empty union scores 1
    z = np.zeros((1, 8, 8), np.float32)
    assert TPE.vsd_error(*(torch.as_tensor(z),) * 3).item() == 1.0


def test_tables_match_jax():
    rng = np.random.default_rng(3)
    add = rng.uniform(0, 0.03, 50)
    re, te = rng.uniform(0, 12, 50), rng.uniform(0, 0.12, 50)
    proj = rng.uniform(0, 12, 50)
    assert TPE.recall_table(add, re, te, proj, 0.1) == \
        JPE.recall_table(add, re, te, proj, 0.1)
    assert TPE.recall_table(add[:0], re[:0], te[:0], proj[:0], 0.1) == \
        JPE.recall_table(add[:0], re[:0], te[:0], proj[:0], 0.1)
    assert TPE.auc_add(add) == JPE.auc_add(add)
    vsd, mssd, mspd = rng.random((50, 10)), rng.uniform(0, 0.06, 50), \
        rng.uniform(0, 60, 50)
    assert TPE.bop19_average_recalls(vsd, mssd, mspd, 0.1, 640) == \
        JPE.bop19_average_recalls(vsd, mssd, mspd, 0.1, 640)
    assert TPE.BOP19_TH == JPE.BOP19_TH
    assert TPE.BOP19_MSPD_TH == JPE.BOP19_MSPD_TH
