"""Batched corner detection (Harris) — the two-view front end.

The reference has no feature detector (its correspondences are hand
annotations in a CSV; its only corner code is the checkerboard finder
``cv2.findChessboardCorners``, ``/root/reference/testpro.py:270``).  The
two-view/SfM configs (BASELINE.json configs[2,3]) need one, so this module
provides a static-shape Harris pipeline: gradients and structure tensors as
separable banded matmuls, fixed-size top-K corner selection instead
of data-dependent thresholding, and window-max NMS via reduce_window — all
static shapes, batchable over keyframes (the ``data`` mesh axis).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Keypoints(NamedTuple):
    xy: jnp.ndarray       # [K,2] (x, y) pixel coords, subpixel refined
    score: jnp.ndarray    # [K] Harris response
    valid: jnp.ndarray    # [K] bool (top-K slots beyond real corners = False)


def _conv2(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.conv_general_dilated(
        img[None, None, :, :], kernel[None, None, :, :],
        window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0]


def _band(n: int, taps: jnp.ndarray) -> jnp.ndarray:
    """[n,n] banded convolution matrix: (B @ v)[i] = sum_d taps[d+r] v[i+d]
    with zero padding — one small-radius 1-D correlation as a dense matmul.
    """
    r = taps.shape[0] // 2
    B = jnp.zeros((n, n), taps.dtype)
    for d in range(-r, r + 1):
        B = B + taps[d + r] * jnp.eye(n, n, k=d, dtype=taps.dtype)
    return B


def _sep_conv2(img: jnp.ndarray, row_taps: jnp.ndarray,
               col_taps: jnp.ndarray) -> jnp.ndarray:
    """Separable 'same' correlation as two banded matmuls.

    Single-channel ``lax.conv`` lowered poorly on the accelerator this
    was first built for; each 1-D pass is a dense banded [N,N] matmul
    instead.  Whether a plain convolution is faster on the GPU is not
    measured yet.  ``row_taps`` runs down columns (axis 0), ``col_taps``
    along rows (axis 1).
    """
    h, w = img.shape
    out = _band(h, row_taps) @ img
    return out @ _band(w, col_taps).T


_SOBEL_1D_DERIV = jnp.array([-1.0, 0.0, 1.0]) / 2.0   # d/dx
_SOBEL_1D_SMOOTH = jnp.array([1.0, 2.0, 1.0]) / 4.0   # smoothing
# Full 3x3 Sobel (outer products): X = smooth_rows * deriv_cols.
_SOBEL_X = _SOBEL_1D_SMOOTH[:, None] * _SOBEL_1D_DERIV[None, :]
_SOBEL_Y = _SOBEL_X.T


def _gauss_taps(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    g = jnp.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def _gauss_kernel(sigma: float, radius: int) -> jnp.ndarray:
    g = _gauss_taps(sigma, radius)
    return g[:, None] * g[None, :]


def harris_response(img: jnp.ndarray, k: float = 0.04,
                    sigma: float = 1.5) -> jnp.ndarray:
    """Harris corner response map for a [H,W] float image in [0,1].

    Correlation semantics match the lax.conv reference implementation
    (all kernels here are symmetric or antisymmetric-separable, so
    correlation == convolution up to the tap signs used).
    """
    img = img.astype(jnp.float32)
    # Sobel: rows smoothed, columns differentiated (and vice versa).
    # XLA's conv is a correlation (no kernel flip), so the taps are used
    # as-is.
    gx = _sep_conv2(img, _SOBEL_1D_SMOOTH, _SOBEL_1D_DERIV)
    gy = _sep_conv2(img, _SOBEL_1D_DERIV, _SOBEL_1D_SMOOTH)
    g = _gauss_taps(sigma, radius=max(2, int(2 * sigma)))
    sxx = _sep_conv2(gx * gx, g, g)
    syy = _sep_conv2(gy * gy, g, g)
    sxy = _sep_conv2(gx * gy, g, g)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


@partial(jax.jit, static_argnames=("max_keypoints", "nms_radius", "border",
                                   "approx_topk"))
def detect_harris(img: jnp.ndarray, max_keypoints: int = 512,
                  nms_radius: int = 4, k: float = 0.04,
                  border: int = 8, approx_topk: bool = True) -> Keypoints:
    """Top-K Harris corners with window NMS and quadratic subpixel
    refinement.  Fixed output shape [max_keypoints] with a valid mask —
    no data-dependent corner counts under jit.

    ``approx_topk`` selects the corners with ``jax.lax.approx_max_k``
    (hardware-accelerated only on some backends; elsewhere XLA runs an
    exact top-k, so the results match ``approx_topk=False``).  Recall
    target 0.95 over the TAIL
    of the score distribution only: the strongest corners are always
    kept, a few of the weakest slots may differ from exact — acceptable
    for a detection front end; pass ``approx_topk=False`` for exact
    selection."""
    resp = harris_response(img, k)
    H, W = resp.shape
    # NMS: keep strict window maxima (the direct 2-D reduce_window; XLA
    # decomposes it itself).
    win = 2 * nms_radius + 1
    local_max = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (win, win), (1, 1), "SAME")
    is_peak = (resp >= local_max)
    # Border + positivity mask.
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    in_border = ((yy >= border) & (yy < H - border)
                 & (xx >= border) & (xx < W - border))
    score = jnp.where(is_peak & in_border & (resp > 0), resp, -jnp.inf)

    flat = score.reshape(-1)
    if approx_topk:
        top_scores, top_idx = jax.lax.approx_max_k(flat, max_keypoints)
    else:
        top_scores, top_idx = jax.lax.top_k(flat, max_keypoints)
    ys = (top_idx // W).astype(jnp.float32)
    xs = (top_idx % W).astype(jnp.float32)
    valid = jnp.isfinite(top_scores)

    # Quadratic subpixel refinement on the response surface.  The five
    # neighborhood taps come from ONE row gather per keypoint out of a
    # [H*W, 5] plane table (shifted-image planes are cheap full-array
    # vector ops); per-tap scalar gathers measured ~0.6 ms per image.
    left = jnp.roll(resp, 1, axis=1)
    right = jnp.roll(resp, -1, axis=1)
    up = jnp.roll(resp, 1, axis=0)
    down = jnp.roll(resp, -1, axis=0)
    planes = jnp.stack([resp, left, right, up, down], axis=-1)
    vals = jnp.take(planes.reshape(-1, 5), top_idx, axis=0)  # [K, 5]
    c, lf, rt, upv, dn = (vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3],
                          vals[:, 4])
    dx = (rt - lf) / 2.0
    dy = (dn - upv) / 2.0
    dxx = rt + lf - 2 * c
    dyy = dn + upv - 2 * c
    ox = jnp.where(jnp.abs(dxx) > 1e-9, -dx / dxx, 0.0)
    oy = jnp.where(jnp.abs(dyy) > 1e-9, -dy / dyy, 0.0)
    xs_r = xs + jnp.clip(ox, -0.5, 0.5)
    ys_r = ys + jnp.clip(oy, -0.5, 0.5)
    xy = jnp.stack([jnp.where(valid, xs_r, 0.0),
                    jnp.where(valid, ys_r, 0.0)], axis=-1)
    return Keypoints(xy=xy, score=jnp.where(valid, top_scores, 0.0),
                     valid=valid)
