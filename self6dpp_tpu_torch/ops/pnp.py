"""Perspective-n-point on the host in float64 numpy, without OpenCV: the
solvers the test-time PnP of engine/evaluator.py::pnp_from_xyz_mask calls
(the JAX package's calls cv2.solvePnPRansac with SOLVEPNP_EPNP and
cv2.solvePnP with SOLVEPNP_ITERATIVE).

  rodrigues / rodrigues_inv  rotation vector <-> matrix, OpenCV's formulas
  jacobi_svd      OpenCV's one-sided Jacobi SVD (JacobiSVDImpl_, which
                  OpenCV runs for matrices under 25 rows even when built
                  with LAPACK), for its singular vectors' signs
  epnp            EPnP (Lepetit, Moreno-Noguer and Fua, IJCV 2009) as
                  OpenCV's epnp.cpp computes it: four control points from
                  the centroid and the PCA axes (their signs OpenCV's, by
                  jacobi_svd), the 12 x 12 MᵀM null space,
                  the three beta approximations each refined by 5
                  Gauss-Newton steps, the one of least mean reprojection
                  error kept
  pnp_ransac      EPnP inside RANSAC with solvePnPRansac's constants: 5-point
                  minimal sets, a 3 px reprojection threshold, 100
                  iterations at most, the count shrunk at confidence 0.99 as
                  OpenCV's RANSACUpdateNumIters shrinks it, the points
                  rounded to float32 as OpenCV rounds them; then EPnP on the
                  best model's inliers
  pnp_iterative   SOLVEPNP_ITERATIVE: a DLT initialisation (a homography for
                  planar object points), then Levenberg-Marquardt on the
                  reprojection error until it stops moving

The RANSAC draws come from a numpy Generator: they cannot be OpenCV's, so
the result, not the sample sequence, is what matches. Every function takes
pixel coordinates and a 3 x 3 intrinsic matrix without distortion, and
returns the rotation matrix and translation of the object in the camera
frame (x_cam = R x_obj + t).
"""

from __future__ import annotations

import numpy as np

RANSAC_REPROJ_PX = 3.0
RANSAC_ITERS = 100
RANSAC_CONFIDENCE = 0.99
RANSAC_MODEL_POINTS = 5
LM_MAX_ITERS = 200
_DBL_MIN = np.finfo(np.float64).tiny


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation vector (3,) -> matrix (3, 3), as cv2.Rodrigues."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    k = r / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * kx


def rodrigues_inv(R: np.ndarray) -> np.ndarray:
    """Matrix (3, 3) -> rotation vector (3,), as cv2.Rodrigues: the matrix
    is first replaced by its nearest rotation (U Vᵀ of its SVD)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return r * (theta / (2.0 * s))
    if c > 0:
        return np.zeros(3)
    # theta near pi: the axis from the diagonal, signs from the off-diagonal
    t = (np.diag(R) + 1.0) * 0.5
    r = np.sqrt(np.maximum(t, 0.0))
    r[1] *= -1.0 if R[0, 1] < 0 else 1.0
    r[2] *= -1.0 if R[0, 2] < 0 else 1.0
    if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
            and (R[1, 2] > 0) != (r[1] * r[2] > 0)):
        r[2] = -r[2]
    return r * (theta / np.linalg.norm(r))


def project(obj: np.ndarray, R: np.ndarray, t: np.ndarray,
            K: np.ndarray) -> np.ndarray:
    """(N, 3) object points -> (N, 2) pixels."""
    pc = obj @ R.T + t
    return np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                     K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], 1)


# ---- EPnP --------------------------------------------------------------

def jacobi_svd(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(w (n,), U (m, n)) of an m x n matrix, m >= n, by OpenCV's
    one-sided Jacobi rotations of Aᵀ's rows, sorted by descending w. The
    singular vectors' signs are what this algorithm leaves, which is what
    EPnP's control points inherit: on noisy points a flipped PCA axis moves
    the EPnP pose by up to a degree. A zero singular value's vector is not
    completed (OpenCV draws it at random)."""
    At = np.array(A, np.float64).T.copy()
    n, m = At.shape
    W = (At * At).sum(1)
    eps = 10.0 * np.finfo(np.float64).eps
    for _ in range(max(m, 30)):
        changed = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                a, b = W[i], W[j]
                p = float(At[i] @ At[j])
                if abs(p) <= eps * np.sqrt(a * b):
                    continue
                p *= 2.0
                beta = a - b
                gamma = np.hypot(p, beta)
                if beta < 0:
                    s = np.sqrt((gamma - beta) * 0.5 / gamma)
                    c = p / (gamma * s * 2.0)
                else:
                    c = np.sqrt((gamma + beta) / (gamma * 2.0))
                    s = p / (gamma * c * 2.0)
                At[i], At[j] = c * At[i] + s * At[j], -s * At[i] + c * At[j]
                W[i], W[j] = At[i] @ At[i], At[j] @ At[j]
                changed = True
        if not changed:
            break
    W = np.sqrt((At * At).sum(1))
    for i in range(n - 1):               # OpenCV's selection sort
        j = i + int(np.argmax(W[i:]))
        if W[j] > W[i]:
            W[[i, j]], At[[i, j]] = W[[j, i]], At[[j, i]]
    return W, (At / np.where(W > 0, W, 1.0)[:, None]).T


# the control-point pairs of the six distance constraints, in epnp.cpp's
# order, and the (i, j) of the ten beta products B_ij of L_6x10's columns
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_B10 = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3),
        (2, 3), (3, 3))


def _lstsq(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.lstsq(A, b, rcond=None)[0]


def _betas_approx(L: np.ndarray, rho: np.ndarray, which: int) -> np.ndarray:
    """epnp.cpp's find_betas_approx_{1,2,3}: the linearised beta products
    solved in the least-squares sense, then the betas read off them."""
    b = np.zeros(4)
    if which == 1:                       # B11 B12 B13 B14
        x = _lstsq(L[:, [0, 1, 3, 6]], rho)
        b[0] = np.sqrt(abs(x[0]))
        b[1:] = (-x[1:] if x[0] < 0 else x[1:]) / b[0]
        return b
    cols = [0, 1, 2] if which == 2 else [0, 1, 2, 3, 4]
    x = _lstsq(L[:, cols], rho)          # B11 B12 B22 [B13 B23]
    if x[0] < 0:
        b[0], b[1] = np.sqrt(-x[0]), (np.sqrt(-x[2]) if x[2] < 0 else 0.0)
    else:
        b[0], b[1] = np.sqrt(x[0]), (np.sqrt(x[2]) if x[2] > 0 else 0.0)
    if x[1] < 0:
        b[0] = -b[0]
    if which == 3:
        b[2] = x[3] / b[0]
    return b


def _gauss_newton(L: np.ndarray, rho: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Five Gauss-Newton steps on the six distance constraints."""
    b = b.copy()
    for _ in range(5):
        prods = np.array([b[i] * b[j] for i, j in _B10])
        A = np.zeros((6, 4))
        for col, (i, j) in enumerate(_B10):
            A[:, i] += L[:, col] * b[j]
            A[:, j] += L[:, col] * b[i]
        b += _lstsq(A, rho - L @ prods)
    return b


def epnp(obj: np.ndarray, img: np.ndarray, K: np.ndarray
         ) -> tuple[np.ndarray, np.ndarray]:
    """EPnP of n >= 4 correspondences: (R (3, 3), t (3,))."""
    pw = np.asarray(obj, np.float64)
    us = np.asarray(img, np.float64)
    n = len(pw)
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    c0 = pw.sum(0) / n
    D, U = jacobi_svd((pw - c0).T @ (pw - c0))
    cws = np.stack([c0] + [c0 + np.sqrt(D[i] / n) * U[:, i]
                           for i in range(3)])
    CC = (cws[1:] - c0).T
    a = (pw - c0) @ np.linalg.pinv(CC).T
    alphas = np.concatenate([1.0 - a.sum(1, keepdims=True), a], 1)
    M = np.zeros((2 * n, 12))
    M[0::2, 0::3] = alphas * fu
    M[0::2, 2::3] = alphas * (uc - us[:, :1])
    M[1::2, 1::3] = alphas * fv
    M[1::2, 2::3] = alphas * (vc - us[:, 1:])
    Um, _, _ = np.linalg.svd(M.T @ M)
    v = np.stack([Um[:, 11 - k] for k in range(4)])          # (4, 12)
    dv = np.stack([[v[k].reshape(4, 3)[p] - v[k].reshape(4, 3)[q]
                    for p, q in _PAIRS] for k in range(4)])  # (4, 6, 3)
    L = np.stack([(1.0 if i == j else 2.0) * (dv[i] * dv[j]).sum(1)
                  for i, j in _B10], 1)                      # (6, 10)
    rho = np.array([((cws[p] - cws[q]) ** 2).sum() for p, q in _PAIRS])
    best = None
    for which in (1, 2, 3):
        b = _gauss_newton(L, rho, _betas_approx(L, rho, which))
        R, t = _pose_from_betas(b, v, alphas, pw)
        err = np.linalg.norm(project(pw, R, t, K) - us, axis=1).mean()
        if best is None or err < best[0]:
            best = (err, R, t)
    return best[1], best[2]


def _pose_from_betas(b, v, alphas, pw):
    """The camera-frame control points sum(b_k v_k), their points (flipped
    to positive depth), and the absolute orientation onto the object
    points (epnp.cpp's compute_R_and_t)."""
    ccs = (b[:, None] * v).sum(0).reshape(4, 3)
    pcs = alphas @ ccs
    if pcs[0, 2] < 0:
        ccs, pcs = -ccs, -pcs
    pc0, pw0 = pcs.mean(0), pw.mean(0)
    U, _, Vt = np.linalg.svd((pcs - pc0).T @ (pw - pw0))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    return R, pc0 - R @ pw0


# ---- RANSAC ------------------------------------------------------------

def ransac_iters(confidence: float, outlier_share: float, model_points: int,
                 max_iters: int) -> int:
    """OpenCV's RANSACUpdateNumIters."""
    p = min(max(confidence, 0.0), 1.0)
    ep = min(max(outlier_share, 0.0), 1.0)
    num = max(1.0 - p, _DBL_MIN)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < _DBL_MIN:
        return 0
    num, denom = np.log(num), np.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(round(num / denom))


def pnp_ransac(obj: np.ndarray, img: np.ndarray, K: np.ndarray,
               rng: np.random.Generator):
    """EPnP inside RANSAC, then EPnP on the inliers:
    (R, t, inlier mask (N,) bool), or None when no minimal model gathers
    more than 4 inliers. n = 5 is solved directly; n < 5 gives None."""
    obj = np.asarray(obj, np.float32).astype(np.float64)
    img = np.asarray(img, np.float32).astype(np.float64)
    n, m = len(obj), RANSAC_MODEL_POINTS
    if n < m:
        return None
    if n == m:
        R, t = epnp(obj, img, K)
        return R, t, np.ones(n, bool)
    thr = np.float32(RANSAC_REPROJ_PX * RANSAC_REPROJ_PX)
    best, best_count, niters, it = None, 0, RANSAC_ITERS, 0
    while it < niters:
        it += 1
        idx = rng.choice(n, m, replace=False)
        R, t = epnp(obj[idx], img[idx], K)
        if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
            continue
        err = ((project(obj, R, t, K) - img) ** 2).sum(1).astype(np.float32)
        good = err <= thr
        count = int(good.sum())
        if count > max(best_count, m - 1):
            best, best_count = good, count
            niters = ransac_iters(RANSAC_CONFIDENCE, (n - count) / n, m,
                                  niters)
    if best is None:
        return None
    R, t = epnp(obj[best], img[best], K)
    return R, t, best


# ---- SOLVEPNP_ITERATIVE --------------------------------------------------

def _dlt_init(obj: np.ndarray, mn: np.ndarray):
    """OpenCV's initial pose of cvFindExtrinsicCameraParams2 from the
    object points and the normalised image points: a homography for
    planar points (their covariance's last singular value below 1e-3 of
    the second), else the 12-parameter DLT projected onto a rotation."""
    Mc = obj.mean(0)
    _, W, Vt = np.linalg.svd((obj - Mc).T @ (obj - Mc))
    if W[2] / W[1] < 1e-3:
        Rt = Vt.copy()
        if Rt[0, 2] ** 2 + Rt[1, 2] ** 2 < 1e-10:
            Rt = np.eye(3)
        if np.linalg.det(Rt) < 0:
            Rt = -Rt
        T = -Rt @ Mc
        xy = obj @ Rt[:2].T + T[:2]
        A = np.zeros((2 * len(obj), 9))
        A[0::2, 0:2], A[0::2, 2] = xy, 1.0
        A[0::2, 6:8], A[0::2, 8] = -mn[:, :1] * xy, -mn[:, 0]
        A[1::2, 3:5], A[1::2, 5] = xy, 1.0
        A[1::2, 6:8], A[1::2, 8] = -mn[:, 1:] * xy, -mn[:, 1]
        H = np.linalg.svd(A)[2][-1].reshape(3, 3)
        if H[2, 2] != 0:
            H = H / H[2, 2]
        h1n, h2n = np.linalg.norm(H[:, 0]), np.linalg.norm(H[:, 1])
        eps = np.finfo(np.float64).eps
        h1, h2 = H[:, 0] / max(h1n, eps), H[:, 1] / max(h2n, eps)
        t = H[:, 2] * 2.0 / max(h1n + h2n, eps)
        Rh = rodrigues(rodrigues_inv(np.stack([h1, h2, np.cross(h1, h2)], 1)))
        return Rh @ Rt, Rh @ T + t
    n = len(obj)
    L = np.zeros((2 * n, 12))
    Mh = np.concatenate([obj, np.ones((n, 1))], 1)
    L[0::2, 0:4], L[0::2, 8:12] = Mh, -mn[:, :1] * Mh
    L[1::2, 4:8], L[1::2, 8:12] = Mh, -mn[:, 1:] * Mh
    RRt = np.linalg.svd(L.T @ L)[2][11].reshape(3, 4)
    if np.linalg.det(RRt[:, :3]) < 0:
        RRt = -RRt
    sc = np.linalg.norm(RRt[:, :3])
    U, _, Vt = np.linalg.svd(RRt[:, :3])
    R = U @ Vt
    return R, RRt[:, 3] * (np.linalg.norm(R) / sc)


def _skew(a: np.ndarray) -> np.ndarray:
    """(N, 3) -> (N, 3, 3) cross-product matrices."""
    z = np.zeros(len(a))
    return np.stack([np.stack([z, -a[:, 2], a[:, 1]], 1),
                     np.stack([a[:, 2], z, -a[:, 0]], 1),
                     np.stack([-a[:, 1], a[:, 0], z], 1)], 1)


def refine_lm(obj: np.ndarray, img: np.ndarray, K: np.ndarray,
              R: np.ndarray, t: np.ndarray):
    """Levenberg-Marquardt on the summed squared reprojection error over
    (R, t), R updated as exp([w]x) R, until a step no longer lowers the
    error or moves the pose by more than 1e-15 relative, LM_MAX_ITERS
    steps at most: (R, t)."""
    fx, fy = K[0, 0], K[1, 1]

    def residual(R, t):
        return (project(obj, R, t, K) - img).ravel()

    res = residual(R, t)
    cost = res @ res
    lam = 1e-3
    for _ in range(LM_MAX_ITERS):
        RX = obj @ R.T
        pc = RX + t
        iz = 1.0 / pc[:, 2]
        dp = np.zeros((len(obj), 2, 3))
        dp[:, 0, 0], dp[:, 0, 2] = fx * iz, -fx * pc[:, 0] * iz * iz
        dp[:, 1, 1], dp[:, 1, 2] = fy * iz, -fy * pc[:, 1] * iz * iz
        J = np.concatenate([dp @ -_skew(RX), dp], 2).reshape(-1, 6)
        A, g = J.T @ J, J.T @ res
        while True:
            step = np.linalg.solve(A + lam * np.diag(np.diag(A)), -g)
            R1, t1 = rodrigues(step[:3]) @ R, t + step[3:]
            res1 = residual(R1, t1)
            cost1 = res1 @ res1
            if np.isfinite(cost1) and cost1 <= cost:
                break
            lam *= 10.0
            if lam > 1e16:
                return R, t
        small = (np.linalg.norm(step[3:]) <= 1e-15 * (1.0 + np.linalg.norm(t))
                 and np.linalg.norm(step[:3]) <= 1e-15)
        R, t, res, lam = R1, t1, res1, max(lam / 10.0, 1e-15)
        if small or cost1 == cost:
            break
        cost = cost1
    return R, t


def pnp_iterative(obj: np.ndarray, img: np.ndarray, K: np.ndarray):
    """SOLVEPNP_ITERATIVE of n >= 4 correspondences: (R, t), or None when
    the pose is not finite."""
    obj = np.asarray(obj, np.float64)
    img = np.asarray(img, np.float64)
    if len(obj) < 4:
        return None
    mn = np.stack([(img[:, 0] - K[0, 2]) / K[0, 0],
                   (img[:, 1] - K[1, 2]) / K[1, 1]], 1)
    R, t = _dlt_init(obj, mn)
    if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
        return None
    R, t = refine_lm(obj, img, np.asarray(K, np.float64), R, t)
    if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
        return None
    return R, t
