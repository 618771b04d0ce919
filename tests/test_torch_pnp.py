"""The port's test-time PnP (engine/evaluator.py::pnp_from_xyz_mask over
ops/pnp.py) against the JAX package's, which calls OpenCV
(solvePnPRansac with EPnP, solvePnP with SOLVEPNP_ITERATIVE), on xyz maps
and masks made from a seeded pose:
  * noise-free correspondences: rotation and translation within 1e-5
    relative, RANSAC and iterative;
  * Gaussian pixel noise: iterative within 1e-6 (both converge to the one
    minimum of the reprojection error); RANSAC's final EPnP on the port's
    inliers within 1e-5 of OpenCV's EPnP on them, the inlier set within
    0.5 % of solvePnPRansac's (the minimal sets are drawn from another
    generator, so points near the 3 px threshold may fall either way) and,
    where the sets are equal, the pose within 1e-5;
  * 30 % gross outliers (20-60 px) with inliers exact or under 1 px: the
    same inlier set as solvePnPRansac's and the pose within 1e-5;
  * object points on a plane: iterative at OpenCV's pose carried to
    convergence, within 1e-9;
  * a crop of a few pixels at an object's rim (a near-planar patch):
    iterative, the same minimum as OpenCV's, mirrored poses far from the
    truth included;
  * too few mask pixels: None from both;
  * Rodrigues both ways against cv2.Rodrigues, and the Jacobi SVD that
    gives EPnP's control points their signs against cv2.SVDecomp.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from self6dpp_tpu.engine import evaluator as jev  # noqa: E402
from self6dpp_tpu_torch.engine import evaluator as tev  # noqa: E402
from self6dpp_tpu_torch.ops import pnp as P  # noqa: E402

K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
              [0.0, 0.0, 1.0]])
OUT = 64                       # the xyz map's side
ROI_WH = 192.0                 # the ROI's side in the frame
EXTENTS = np.array([0.10, 0.08, 0.12])


def scene(seed, noise_px=0.0, outliers=0.0, inlier_px=0.0):
    """(coor, mask_prob, R, t, roi_center, outlier mask per mask pixel): an
    object posed by a seeded rotation at ~0.7 m, its xyz map made by
    casting each masked pixel's ray (through the pixel centre, moved by
    N(0, noise_px) px, or by 20-60 px for an outlier, or by U(-inlier_px,
    inlier_px) for an inlier) to a seeded depth and taking the point into
    the object frame, normalised by the extents."""
    rng = np.random.default_rng(seed)
    R = P.rodrigues(rng.normal(0, 1, 3))
    t = np.array([0.03, -0.02, 0.7]) + rng.normal(0, 0.02, 3)
    center = P.project(np.zeros((1, 3)), R, t, K)[0]
    ys, xs = np.mgrid[0:OUT, 0:OUT]
    mask = ((ys - OUT / 2 + 0.5) ** 2 + (xs - OUT / 2 + 0.5) ** 2
            < (OUT * 0.42) ** 2)
    s = ROI_WH / OUT
    u = center[0] - ROI_WH / 2 + (xs + 0.5) * s
    v = center[1] - ROI_WH / 2 + (ys + 0.5) * s
    n = mask.sum()
    off = rng.normal(0, noise_px, (n, 2))
    off += rng.uniform(-inlier_px, inlier_px, (n, 2))
    out = rng.random(n) < outliers
    off[out] = (rng.choice([-1, 1], (out.sum(), 2))
                * rng.uniform(20, 60, (out.sum(), 2)))
    uv = np.stack([u[mask], v[mask]], 1) + off
    z = t[2] + rng.uniform(-0.04, 0.04, n)
    pc = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0] * z,
                   (uv[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
    obj = (pc - t) @ R
    coor = np.full((OUT, OUT, 3), 0.5, np.float32)
    coor[mask] = obj / EXTENTS + 0.5
    prob = np.where(mask, 0.9, 0.1).astype(np.float32)
    return coor, prob, R, t, center, out


def both(coor, prob, center, ransac, **kw):
    args = (coor, prob, EXTENTS, center, ROI_WH, K)
    return (jev.pnp_from_xyz_mask(*args, ransac=ransac, **kw),
            tev.pnp_from_xyz_mask(*args, ransac=ransac, **kw))


def correspondences(coor, prob, center):
    """The points pnp_from_xyz_mask builds (its own formulas)."""
    ys, xs = np.nonzero(prob > 0.5)
    obj = ((coor[ys, xs] - 0.5) * EXTENTS).astype(np.float64)
    s = ROI_WH / OUT
    img = np.stack([center[0] - ROI_WH / 2 + (xs + 0.5) * s,
                    center[1] - ROI_WH / 2 + (ys + 0.5) * s], 1)
    return obj, img


def assert_pose_close(got, ref, tol):
    (R, t), (Rr, tr) = got, ref
    assert R.dtype == np.float32 and t.shape == (3,)
    np.testing.assert_allclose(R, Rr, rtol=0, atol=tol)
    assert np.linalg.norm(t - tr) <= tol * np.linalg.norm(tr)


def rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def cv_ransac_inliers(obj, img):
    ok, _, _, inl = cv2.solvePnPRansac(
        obj, img, K, None, reprojectionError=3.0, iterationsCount=100,
        flags=cv2.SOLVEPNP_EPNP)
    assert ok
    cv_in = np.zeros(len(obj), bool)
    cv_in[inl.ravel()] = True
    return cv_in


def sse(obj, img, R, t):
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    return ((P.project(obj, R, t, K) - img) ** 2).sum()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ransac", [True, False])
def test_noise_free(seed, ransac):
    coor, prob, R, t, center, _ = scene(seed)
    ref, got = both(coor, prob, center, ransac)
    assert_pose_close(got, ref, 1e-5)
    assert_pose_close(got, (R, t), 1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gaussian_noise(seed):
    coor, prob, R, t, center, _ = scene(seed, noise_px=0.5)
    ref, got = both(coor, prob, center, ransac=False)
    assert_pose_close(got, ref, 1e-6)
    ref, got = both(coor, prob, center, ransac=True)
    obj, img = correspondences(coor, prob, center)
    inl = P.pnp_ransac(obj, img, K, np.random.default_rng(0))[2]
    f32 = lambda a: a.astype(np.float32).astype(np.float64)
    ok, rv, tv = cv2.solvePnP(f32(obj)[inl], f32(img)[inl], K, None,
                              flags=cv2.SOLVEPNP_EPNP)
    assert ok
    assert_pose_close(got, (cv2.Rodrigues(rv)[0], tv.ravel()), 1e-5)
    cv_in = cv_ransac_inliers(obj, img)
    assert (cv_in ^ inl).sum() <= 0.005 * len(obj)
    if (cv_in == inl).all():
        assert_pose_close(got, ref, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("inlier_px", [0.0, 0.8])
def test_outliers(seed, inlier_px):
    coor, prob, R, t, center, out = scene(seed, outliers=0.3,
                                          inlier_px=inlier_px)
    obj, img = correspondences(coor, prob, center)
    cv_in = cv_ransac_inliers(obj, img)
    res = P.pnp_ransac(obj, img, K, np.random.default_rng(seed))
    np.testing.assert_array_equal(res[2], cv_in)
    np.testing.assert_array_equal(res[2], ~out)
    ref, got = both(coor, prob, center, ransac=True)
    assert_pose_close(got, ref, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_planar_points_iterative(seed):
    """Object points on a plane (a flat face seen alone): OpenCV starts
    its iterative solve from a homography, the port from a plain DLT one;
    the minimum is flatter than off the plane and OpenCV's stopping rule
    (a step below FLT_EPSILON) ends up to ~1e-5 short of it, so the port
    is held to OpenCV's pose carried to convergence (refine_lm), and its
    error may not exceed OpenCV's."""
    rng = np.random.default_rng(seed)
    R = P.rodrigues(rng.normal(0, 0.5, 3))
    t = np.array([0.02, -0.01, 0.6])
    obj = np.concatenate([rng.uniform(-0.05, 0.05, (200, 2)),
                          np.zeros((200, 1))], 1)
    img = P.project(obj, R, t, K) + rng.normal(0, 0.3, (200, 2))
    ok, rv, tv = cv2.solvePnP(obj, img, K, None,
                              flags=cv2.SOLVEPNP_ITERATIVE)
    assert ok
    Rc, tc = cv2.Rodrigues(rv)[0], tv.ravel()
    Rp, tp = P.pnp_iterative(obj, img, K)
    Rr, tr = P.refine_lm(obj, img, K, Rc, tc)
    np.testing.assert_allclose(Rp, Rr, rtol=0, atol=1e-9)
    assert np.linalg.norm(tp - tr) <= 1e-9 * np.linalg.norm(tr)
    sse = lambda R, t: ((P.project(obj, R, t, K) - img) ** 2).sum()
    assert sse(Rp, tp) <= sse(Rc, tc)
    np.testing.assert_allclose(Rp, Rc, rtol=0, atol=1e-5)


def rim_crop(seed, side=7.5):
    """(coor, mask_prob, roi_center, R, t): a crop `side` frame pixels
    wide at the rim of an ellipsoid with half-axes EXTENTS / 2, posed by a
    seeded rotation at ~0.9 m, its xyz map made by casting each pixel's
    ray, moved up to half an output pixel, onto the ellipsoid. The patch
    it sees is nearly planar: the iterative solve can settle on a pose
    far from the truth that fits the labels within a fraction of a pixel
    (the chip run's few-pixel crops of objects cut by the frame's edge)."""
    rng = np.random.default_rng(seed)
    R = P.rodrigues(rng.normal(0, 1, 3))
    t = np.array([0.05, -0.03, 0.9]) + rng.normal(0, 0.02, 3)
    ang = rng.uniform(0, 2 * np.pi)
    center = (P.project(np.zeros((1, 3)), R, t, K)[0]
              + 24.0 * np.array([np.cos(ang), np.sin(ang)]))
    ys, xs = np.mgrid[0:OUT, 0:OUT]
    s = side / OUT
    jit = rng.uniform(-0.5, 0.5, (2, OUT, OUT))
    u = center[0] - side / 2 + (xs + 0.5 + jit[0]) * s
    v = center[1] - side / 2 + (ys + 0.5 + jit[1]) * s
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                  np.ones_like(u)], -1)
    half = EXTENTS / 2
    dd, o0 = d @ R / half, (-t @ R) / half
    a, b, c = (dd * dd).sum(-1), 2 * (dd @ o0), o0 @ o0 - 1
    disc = b * b - 4 * a * c
    mask = disc > 0
    z = (-b - np.sqrt(np.where(mask, disc, 0))) / (2 * a)
    obj = (z[..., None] * d - t) @ R
    coor = np.where(mask[..., None], obj / EXTENTS + 0.5, 0.5)
    prob = np.where(mask, 0.9, 0.1).astype(np.float32)
    return coor.astype(np.float32), prob, center, R, t


@pytest.mark.parametrize("seed", range(16))
def test_small_crop_iterative(seed):
    """A 7.5-px crop at an object's rim, iterative: the port ends at the
    minimum OpenCV ends at (its pose carried to convergence by refine_lm,
    within 1e-6), five of these sixteen over 45 degrees from the truth
    in both. OpenCV stops up to ~1e-5 short of it, as on planar points. The
    two Levenberg-Marquardt paths differ (OpenCV steps the rotation
    vector, the port the rotation): where they part into two minima
    (seed 11), the port's fits the labels better (ROADMAP §C)."""
    side = 7.5
    coor, prob, center, R, t = rim_crop(seed, side)
    args = (coor, prob, EXTENTS, center, side, K)
    ref = jev.pnp_from_xyz_mask(*args, ransac=False)
    got = tev.pnp_from_xyz_mask(*args, ransac=False)
    ys, xs = np.nonzero(prob > 0.5)
    obj = ((coor[ys, xs] - 0.5) * EXTENTS).astype(np.float64)
    s = side / OUT
    img = np.stack([center[0] - side / 2 + (xs + 0.5) * s,
                    center[1] - side / 2 + (ys + 0.5) * s], 1)
    Rr, tr = P.refine_lm(obj, img, K, ref[0].astype(np.float64),
                         ref[1].astype(np.float64))
    if seed == 11:
        assert sse(obj, img, *got) < 0.1 * sse(obj, img, Rr, tr)
        return
    assert (rot_deg(got[0], R) > 45) == (seed in (0, 2, 4, 7, 12))
    np.testing.assert_allclose(got[0], Rr, rtol=0, atol=1e-6)
    assert np.linalg.norm(got[1] - tr) <= 1e-6 * np.linalg.norm(tr)
    assert sse(obj, img, *got) <= sse(obj, img, *ref) * (1 + 1e-6)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_jacobi_svd_matches_cv2(seed):
    """Singular values and vectors, signs included, as cv2.SVDecomp gives
    them for the 3 x 3 scatter matrices EPnP decomposes and for other
    shapes."""
    rng = np.random.default_rng(seed)
    for shape in ((3, 3), (6, 3), (12, 12)):
        for _ in range(25):
            A = rng.normal(size=shape) * rng.uniform(0.01, 3, shape[1])
            if shape[0] == shape[1]:
                A = A.T @ A
            w, U = P.jacobi_svd(A)
            wc, Uc, _ = cv2.SVDecomp(A)
            np.testing.assert_allclose(U, Uc, rtol=0, atol=1e-12)
            np.testing.assert_allclose(w, wc.ravel(), rtol=1e-12,
                                       atol=1e-12 * wc.max())


def test_too_few_pixels():
    coor, prob, _, _, center, _ = scene(0)
    few = np.full_like(prob, 0.1)
    few[30, 30:35] = 0.9                       # 5 pixels < min_pts 8
    for ransac in (True, False):
        ref, got = both(coor, few, center, ransac)
        assert ref is None and got is None
    ref, got = both(coor, prob, center, True, mask_thresh=0.95)
    assert ref is None and got is None


@pytest.mark.parametrize("rvec", [
    [0.3, -0.2, 0.1], [0.0, 0.0, 0.0], [1e-7, 0.0, 0.0],
    [np.pi - 1e-9, 0.0, 0.0], [0.0, -3.1415, 0.02], [2.0, 1.0, -1.5]])
def test_rodrigues_matches_cv2(rvec):
    rvec = np.asarray(rvec, np.float64)
    R = P.rodrigues(rvec)
    np.testing.assert_allclose(R, cv2.Rodrigues(rvec)[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(P.rodrigues_inv(R),
                               cv2.Rodrigues(R)[0].ravel(), rtol=0, atol=1e-9)
