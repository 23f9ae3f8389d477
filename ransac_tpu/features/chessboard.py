"""Checkerboard corner detection + grid ordering.

JAX replacement for ``cv2.findChessboardCorners`` +
``cv2.cornerSubPix`` (``/root/reference/testpro.py:270-276``), completing
the from-images calibration path (models.calibration implements Zhang).

Detection: checkerboard inner corners are saddle points — strong negative
determinant of the smoothed Hessian.  The response map, window NMS and
top-K selection are the same fixed-shape machinery as the Harris detector.
Ordering: the four outermost detections (extremal along the diagonal
directions) anchor a homography from the unit grid; all 4 rotations are
scored and the best assignment (nearest predicted node, uniqueness
enforced) is refined with a full-grid DLT fit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ransac_tpu.features.detect import _conv2, _gauss_kernel
from ransac_tpu.ops import homography as hops


def saddle_response(img: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """-det(Hessian) of the smoothed image: positive at X-junctions."""
    img = img.astype(jnp.float32)
    g = _gauss_kernel(sigma, radius=max(2, int(2 * sigma)))
    sm = _conv2(img, g)
    dxx = _conv2(sm, jnp.array([[1.0, -2.0, 1.0]]))
    dyy = _conv2(sm, jnp.array([[1.0], [-2.0], [1.0]]))
    dxy = _conv2(sm, jnp.array([[0.25, 0, -0.25], [0, 0, 0],
                                [-0.25, 0, 0.25]]))
    return -(dxx * dyy - dxy * dxy)


def detect_saddles(img: jnp.ndarray, max_corners: int, nms_radius: int = 5,
                   border: int = 4):
    """Top-K saddle points with NMS + quadratic subpixel refinement."""
    resp = saddle_response(img)
    H, W = resp.shape
    win = 2 * nms_radius + 1
    local_max = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (win, win), (1, 1), "SAME")
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    inside = ((yy >= border) & (yy < H - border)
              & (xx >= border) & (xx < W - border))
    score = jnp.where((resp >= local_max) & inside & (resp > 0),
                      resp, -jnp.inf)
    top_scores, top_idx = jax.lax.top_k(score.reshape(-1), max_corners)
    ys = (top_idx // W).astype(jnp.float32)
    xs = (top_idx % W).astype(jnp.float32)
    valid = jnp.isfinite(top_scores)

    def subpix(y, x):
        yi = y.astype(jnp.int32)
        xi = x.astype(jnp.int32)
        c = resp[yi, xi]
        dx = (resp[yi, xi + 1] - resp[yi, xi - 1]) / 2.0
        dy = (resp[yi + 1, xi] - resp[yi - 1, xi]) / 2.0
        dxx = resp[yi, xi + 1] + resp[yi, xi - 1] - 2 * c
        dyy = resp[yi + 1, xi] + resp[yi - 1, xi] - 2 * c
        ox = jnp.where(jnp.abs(dxx) > 1e-12, -dx / dxx, 0.0)
        oy = jnp.where(jnp.abs(dyy) > 1e-12, -dy / dyy, 0.0)
        return x + jnp.clip(ox, -1.0, 1.0), y + jnp.clip(oy, -1.0, 1.0)

    xs, ys = jax.vmap(subpix)(ys, xs)
    return (np.asarray(jnp.stack([xs, ys], -1)), np.asarray(top_scores),
            np.asarray(valid))


def order_grid(points: np.ndarray, cols: int, rows: int,
               tol_frac: float = 0.35):
    """Order detected corners into row-major (cols x rows) grid order via
    anchor-homography fitting.  Returns [rows*cols, 2] or None."""
    pts = np.asarray(points, np.float64)
    n_need = cols * rows
    if len(pts) < n_need:
        return None

    # Anchor candidates: extremal points along the two diagonals.
    s = pts[:, 0] + pts[:, 1]
    d = pts[:, 0] - pts[:, 1]
    anchors = np.array([
        pts[np.argmin(s)], pts[np.argmax(d)],
        pts[np.argmax(s)], pts[np.argmin(d)],
    ])  # TL, TR, BR, BL in image terms

    unit_corners = np.array([
        [0.0, 0.0], [cols - 1.0, 0.0],
        [cols - 1.0, rows - 1.0], [0.0, rows - 1.0]])

    best = None
    for rot in range(4):
        corner_set = np.roll(anchors, -rot, axis=0)
        H = np.asarray(hops.dlt_homography(
            jnp.asarray(unit_corners), jnp.asarray(corner_set)))
        grid = np.stack(np.meshgrid(np.arange(cols), np.arange(rows)),
                        -1).reshape(-1, 2).astype(np.float64)
        pred = np.asarray(hops.apply_h(jnp.asarray(H), jnp.asarray(grid)))
        # Assign each grid node to the nearest detection (must be unique).
        d2 = ((pred[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        assign = np.argmin(d2, axis=1)
        dmin = np.sqrt(d2[np.arange(len(grid)), assign])
        # Spacing-relative tolerance.
        spacing = np.median(np.sqrt(
            ((pred[1:cols] - pred[:cols - 1]) ** 2).sum(-1)))
        ok = (len(set(assign.tolist())) == len(grid)
              and (dmin < tol_frac * spacing).all())
        err = dmin.mean()
        if ok and (best is None or err < best[0]):
            best = (err, assign)
    if best is None:
        return None
    _, assign = best
    ordered = pts[assign]

    # Refine with a full-grid homography and re-assign once.
    grid = np.stack(np.meshgrid(np.arange(cols), np.arange(rows)),
                    -1).reshape(-1, 2).astype(np.float64)
    H = np.asarray(hops.dlt_homography(
        jnp.asarray(grid), jnp.asarray(ordered)))
    pred = np.asarray(hops.apply_h(jnp.asarray(H), jnp.asarray(grid)))
    d2 = ((pred[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    assign = np.argmin(d2, axis=1)
    if len(set(assign.tolist())) != len(grid):
        return None
    return pts[assign]


def find_chessboard_corners(img, cols: int, rows: int,
                            nms_radius: int = 5):
    """cv2.findChessboardCorners equivalent: (found, corners [rows*cols, 2]
    row-major).  ``cols``/``rows`` are INNER corner counts."""
    imgj = jnp.asarray(img, jnp.float32)
    if imgj.ndim == 3:
        imgj = imgj.mean(-1)
    n_need = cols * rows
    pts, scores, valid = detect_saddles(
        imgj, max_corners=2 * n_need, nms_radius=nms_radius)
    pts, scores = pts[valid], scores[valid]
    if len(pts) < n_need:
        return False, None
    # Checkerboard saddles dominate the response map: keep peaks within a
    # factor of the weakest expected corner, dropping background clutter.
    order = np.argsort(scores)[::-1]
    kth = scores[order[n_need - 1]]
    keep = scores >= 0.5 * kth
    pts = pts[keep]
    ordered = order_grid(pts, cols, rows)
    if ordered is None:
        return False, None
    return True, ordered
