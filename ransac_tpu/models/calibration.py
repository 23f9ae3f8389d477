"""Camera calibration: Zhang's method on checkerboard homographies.

JAX replacement for ``cv2.calibrateCamera`` /
``findChessboardCorners`` / ``getOptimalNewCameraMatrix`` / ``undistort``
(``/root/reference/testpro.py:251-287, 952-956``).  Zhang's method is a
homography stack + closed-form intrinsics + LM — it reuses this framework's
DLT-homography and LM kernels directly, so calibration runs batched on
device like everything else.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ransac_tpu.ops import homography as hops
from ransac_tpu.ops import projection as proj
from ransac_tpu.ops.lm import levenberg_marquardt
from ransac_tpu.ops.rotation import exp_so3, log_so3, project_to_so3


class CalibrationResult(NamedTuple):
    K: jnp.ndarray            # [3,3]
    dist: jnp.ndarray         # [5] (k1,k2,p1,p2,k3)
    rvecs: jnp.ndarray        # [V,3]
    tvecs: jnp.ndarray        # [V,3]
    rms: jnp.ndarray          # scalar reprojection RMS (px)


def checkerboard_object_points(cols: int, rows: int,
                               square: float = 1.0) -> np.ndarray:
    """Planar (z=0) grid like cv2's objp (testpro.py:256-258)."""
    g = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2).astype(np.float64)
    return np.concatenate([g * square, np.zeros((g.shape[0], 1))], axis=1)


def _vij(H, i, j):
    return jnp.stack([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j],
    ])


def intrinsics_from_homographies(Hs: jnp.ndarray) -> jnp.ndarray:
    """Closed-form Zhang: stack the v_ij constraints from >=3 view
    homographies, solve for the image of the absolute conic, recover K."""
    rows = []
    for k in range(Hs.shape[0]):
        H = Hs[k]
        rows.append(_vij(H, 0, 1))
        rows.append(_vij(H, 0, 0) - _vij(H, 1, 1))
    V = jnp.stack(rows)
    _, _, Vt = jnp.linalg.svd(V, full_matrices=True)
    b = Vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = jnp.sqrt(jnp.abs(lam / B11))
    beta = jnp.sqrt(jnp.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    return jnp.array([[alpha, gamma, u0], [0.0, beta, v0], [0.0, 0.0, 1.0]],
                     dtype=Hs.dtype)


def extrinsics_from_homography(K: jnp.ndarray, H: jnp.ndarray):
    """Per-view (R, t) from H = K [r1 r2 t] (plane z=0)."""
    A = jnp.linalg.solve(K, H)
    lam = 1.0 / jnp.maximum(jnp.linalg.norm(A[:, 0]), 1e-12)
    # Sign: t_z > 0 (board in front of camera).
    lam = lam * jnp.where(A[2, 2] < 0, -1.0, 1.0)
    r1 = A[:, 0] * lam
    r2 = A[:, 1] * lam
    r3 = jnp.cross(r1, r2)
    R = project_to_so3(jnp.stack([r1, r2, r3], axis=1))
    t = A[:, 2] * lam
    return R, t


def calibrate_camera(
    object_points: jnp.ndarray,  # [P,3] planar board points (z=0)
    image_points: jnp.ndarray,   # [V,P,2] detected corners per view
    refine_iters: int = 40,
) -> CalibrationResult:
    """Full Zhang pipeline: per-view DLT homography -> closed-form K ->
    per-view extrinsics -> joint LM over (K, dist, poses) on reprojection
    error — cv2.calibrateCamera equivalent."""
    V = image_points.shape[0]
    board2d = object_points[:, :2]

    Hs = jax.vmap(lambda pts: hops.dlt_homography(board2d, pts))(image_points)
    K0 = intrinsics_from_homographies(Hs)
    Rs, ts = jax.vmap(lambda H: extrinsics_from_homography(K0, H))(Hs)
    rvecs0 = jax.vmap(log_so3)(Rs)

    # Joint LM parameter vector: [fx, fy, cx, cy, k1, k2, p1, p2, k3,
    # rvecs (3V), tvecs (3V)].
    x0 = jnp.concatenate([
        jnp.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
        jnp.zeros(5, K0.dtype),
        rvecs0.reshape(-1), ts.reshape(-1),
    ])

    def unpack(x):
        fx, fy, cx, cy = x[0], x[1], x[2], x[3]
        K = jnp.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                      dtype=x.dtype)
        dist = x[4:9]
        rv = x[9:9 + 3 * V].reshape(V, 3)
        tv = x[9 + 3 * V:].reshape(V, 3)
        return K, dist, rv, tv

    def residuals(x):
        K, dist, rv, tv = unpack(x)
        R = jax.vmap(exp_so3)(rv)
        pix, _ = jax.vmap(
            lambda R1, t1: proj.project_points(object_points, R1, t1, K, dist)
        )(R, tv)
        return (pix - image_points).reshape(-1)

    res = levenberg_marquardt(residuals, x0, max_iters=refine_iters)
    K, dist, rv, tv = unpack(res.x)
    # RMS over points (each point contributes a 2-vector residual).
    n_pts = image_points.size / 2
    rms = jnp.sqrt(jnp.sum(residuals(res.x) ** 2) / n_pts)
    return CalibrationResult(K=K, dist=dist, rvecs=rv, tvecs=tv, rms=rms)


def optimal_new_camera_matrix(
    K: jnp.ndarray, dist: jnp.ndarray, image_size: tuple, alpha: float = 1.0,
    grid_n: int = 9,
):
    """``cv2.getOptimalNewCameraMatrix`` equivalent.

    Samples a grid of border-region points, undistorts them, and derives
    the outer (all source pixels kept, alpha=1) and inner (no invalid
    pixels, alpha=0) rectangles; the returned K maps the alpha-interpolated
    rectangle onto the full image.  Returns (newK, roi=(x, y, w, h)).
    """
    W, H = image_size
    us = jnp.linspace(0.0, W - 1.0, grid_n)
    vs = jnp.linspace(0.0, H - 1.0, grid_n)
    UU, VV = jnp.meshgrid(us, vs)
    pix = jnp.stack([UU.reshape(-1), VV.reshape(-1)], -1)
    und = undistort_points(pix, K, dist).reshape(grid_n, grid_n, 2)

    outer_x0 = und[..., 0].min()
    outer_x1 = und[..., 0].max()
    outer_y0 = und[..., 1].min()
    outer_y1 = und[..., 1].max()
    # Inner: tightest bounds over each border row/column.
    inner_x0 = und[:, 0, 0].max()
    inner_x1 = und[:, -1, 0].min()
    inner_y0 = und[0, :, 1].max()
    inner_y1 = und[-1, :, 1].min()

    a = jnp.clip(jnp.asarray(alpha, und.dtype), 0.0, 1.0)
    x0 = inner_x0 * (1 - a) + outer_x0 * a
    x1 = inner_x1 * (1 - a) + outer_x1 * a
    y0 = inner_y0 * (1 - a) + outer_y0 * a
    y1 = inner_y1 * (1 - a) + outer_y1 * a

    sx = W / jnp.maximum(x1 - x0, 1e-9)
    sy = H / jnp.maximum(y1 - y0, 1e-9)
    newK = jnp.array([
        [K[0, 0] * sx, 0.0, (K[0, 2] - x0) * sx],
        [0.0, K[1, 1] * sy, (K[1, 2] - y0) * sy],
        [0.0, 0.0, 1.0],
    ], dtype=K.dtype)
    # Valid-pixel ROI of the inner rectangle inside the new image.
    rx0 = (inner_x0 - x0) * sx
    ry0 = (inner_y0 - y0) * sy
    rx1 = (inner_x1 - x0) * sx
    ry1 = (inner_y1 - y0) * sy
    roi = (float(jnp.clip(rx0, 0, W - 1)), float(jnp.clip(ry0, 0, H - 1)),
           float(jnp.clip(rx1 - rx0, 0, W)), float(jnp.clip(ry1 - ry0, 0, H)))
    return newK, roi


def undistort_points(pixels: jnp.ndarray, K: jnp.ndarray,
                     dist: jnp.ndarray) -> jnp.ndarray:
    """cv2.undistortPoints equivalent (returns pixel coords under K)."""
    xn = proj.normalize_pixels(pixels, K)
    xu, yu = proj.undistort_normalized(xn[..., 0], xn[..., 1], dist)
    u = K[0, 0] * xu + K[0, 2]
    v = K[1, 1] * yu + K[1, 2]
    return jnp.stack([u, v], axis=-1)


def undistort_image_map(width: int, height: int, K: jnp.ndarray,
                        dist: jnp.ndarray, new_K: jnp.ndarray | None = None):
    """Sampling map for image undistortion (cv2.initUndistortRectifyMap):
    for each output pixel (under ``new_K``, default K), the distorted
    source pixel to sample."""
    if new_K is None:
        new_K = K
    u, v = jnp.meshgrid(jnp.arange(width, dtype=jnp.float32),
                        jnp.arange(height, dtype=jnp.float32))
    xn = (u - new_K[0, 2]) / new_K[0, 0]
    yn = (v - new_K[1, 2]) / new_K[1, 1]
    xd, yd = proj.distort(xn, yn, dist)
    return K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]


def undistort_image(img: jnp.ndarray, K: jnp.ndarray, dist: jnp.ndarray,
                    new_K: jnp.ndarray | None = None) -> jnp.ndarray:
    """cv2.undistort equivalent: bilinear remap of a [H,W] (or [H,W,C])
    image through the undistortion map."""
    img = jnp.asarray(img)
    H, W = img.shape[:2]
    mx, my = undistort_image_map(W, H, K, dist, new_K)
    x0 = jnp.clip(jnp.floor(mx).astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(jnp.floor(my).astype(jnp.int32), 0, H - 2)
    fx = jnp.clip(mx - x0, 0.0, 1.0)
    fy = jnp.clip(my - y0, 0.0, 1.0)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    out = (img[y0, x0] * (1 - fy) * (1 - fx)
           + img[y0 + 1, x0] * fy * (1 - fx)
           + img[y0, x0 + 1] * (1 - fy) * fx
           + img[y0 + 1, x0 + 1] * fy * fx)
    inside = ((mx >= 0) & (mx <= W - 1) & (my >= 0) & (my <= H - 1))
    if img.ndim == 3:
        inside = inside[..., None]
    return jnp.where(inside, out, 0.0)
