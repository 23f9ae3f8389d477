"""Homography estimation: normalized DLT (4-point minimal and N-point LSQ).

JAX replacement for the solver inside ``cv2.findHomography(...,
cv2.RANSAC, thresh)`` (``/root/reference/main_v1.py:312``).  OpenCV runs a
sequential hypothesize-and-verify loop in C++; here the minimal solver is a
pure function over a [4,2]x[4,2] sample that vmaps over a hypothesis tensor
of thousands of samples in one XLA launch (SURVEY.md §2.5 "hypothesis
parallelism").

Semantics matched to OpenCV for parity (tests/test_homography.py checks
against cv2): forward transfer error ||dst - H src|| as the residual, final
least-squares refit on the inlier set.
"""

from __future__ import annotations

import jax.numpy as jnp

from ransac_tpu.ops.linalg import inv3x3, nullspace_last_fast
from ransac_tpu.ops.precision import mm


def normalization_transform(pts: jnp.ndarray, mask: jnp.ndarray | None = None):
    """Hartley normalization: similarity T s.t. T@pts has zero mean and
    mean distance sqrt(2).  pts [...,N,2]; mask [...,N] optional weights."""
    if mask is None:
        w = jnp.ones(pts.shape[:-1], pts.dtype)
    else:
        w = mask.astype(pts.dtype)
    wsum = jnp.maximum(w.sum(-1, keepdims=True), 1e-12)
    mean = (pts * w[..., None]).sum(-2, keepdims=True) / wsum[..., None]
    d = jnp.linalg.norm(pts - mean, axis=-1)
    mean_d = (d * w).sum(-1, keepdims=True) / wsum[..., 0][..., None]
    scale = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-12)
    s = scale[..., 0]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    zeros = jnp.zeros_like(s)
    ones = jnp.ones_like(s)
    T = jnp.stack([
        jnp.stack([s, zeros, -s * mx], -1),
        jnp.stack([zeros, s, -s * my], -1),
        jnp.stack([zeros, zeros, ones], -1),
    ], axis=-2)
    return T


def apply_h(H: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply homography [...,3,3] to [...,N,2] -> [...,N,2] (guarded w)."""
    x, y = pts[..., 0], pts[..., 1]
    w = H[..., 2, 0, None] * x + H[..., 2, 1, None] * y + H[..., 2, 2, None]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    u = (H[..., 0, 0, None] * x + H[..., 0, 1, None] * y + H[..., 0, 2, None]) / w
    v = (H[..., 1, 0, None] * x + H[..., 1, 1, None] * y + H[..., 1, 2, None]) / w
    return jnp.stack([u, v], axis=-1)


def dlt_homography(
    src: jnp.ndarray, dst: jnp.ndarray, weights: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Normalized DLT: H minimizing algebraic error of dst ~ H src.

    src/dst [...,N,2] with N>=4 (N=4 gives the exact minimal solution);
    ``weights`` [...,N] soft-selects rows (inlier refit without dynamic
    shapes).  Returns H [...,3,3] scaled to H[2,2]=1 where possible.
    """
    Ts = normalization_transform(src, weights)
    Td = normalization_transform(dst, weights)
    ones = jnp.ones_like(src[..., :1])
    sh = mm(jnp.concatenate([src, ones], -1), jnp.swapaxes(Ts, -1, -2))
    dh = mm(jnp.concatenate([dst, ones], -1), jnp.swapaxes(Td, -1, -2))
    x, y = sh[..., 0], sh[..., 1]
    u, v = dh[..., 0], dh[..., 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    row1 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    row2 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = jnp.concatenate([row1, row2], axis=-2)
    if weights is not None:
        w2 = jnp.concatenate([weights, weights], axis=-1)
        A = A * w2[..., None]
    h = nullspace_last_fast(A)
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    # Denormalize: H = Td^-1 Hn Ts.
    H = mm(inv3x3(Td), mm(Hn, Ts))  # 3x3: closed-form, stays vectorized under vmap
    s = H[..., 2:3, 2:3]
    s = jnp.where(jnp.abs(s) < 1e-12, 1.0, s)
    return H / s


def dlt_homography_minimal(src: jnp.ndarray, dst: jnp.ndarray):
    """Exact 4-point homography via normalized 8x8 solve (h22=1).

    The hot-path minimal solver: ``solve_unrolled`` keeps the whole
    hypothesis batch elementwise, with no batched SVD (the SVD path
    remains in ``dlt_homography`` for overdetermined refits where volume
    is low).
    h22=0 configurations (centroid mapped to infinity) surface as bad
    pivots -> ok=False, exactly the hypotheses RANSAC should discard.

    src/dst [...,4,2].  Returns (H [...,3,3], ok [...]).
    """
    from ransac_tpu.ops.linalg import solve_unrolled

    Ts = normalization_transform(src)
    Td = normalization_transform(dst)
    ones = jnp.ones_like(src[..., :1])
    sh = mm(jnp.concatenate([src, ones], -1), jnp.swapaxes(Ts, -1, -2))
    dh = mm(jnp.concatenate([dst, ones], -1), jnp.swapaxes(Td, -1, -2))
    x, y = sh[..., 0], sh[..., 1]
    u, v = dh[..., 0], dh[..., 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r2 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    A = jnp.concatenate([r1, r2], axis=-2)                 # [...,8,8]
    b = jnp.concatenate([u, v], axis=-1)                   # [...,8]
    h8, ok = solve_unrolled(A, b)
    Hn = jnp.concatenate([h8, jnp.ones_like(h8[..., :1])], -1)
    Hn = Hn.reshape(*Hn.shape[:-1], 3, 3)
    # Denormalize with the closed-form similarity inverse:
    # Td = [[s,0,-s mx],[0,s,-s my],[0,0,1]] -> Td^-1 = [[1/s,0,mx],...].
    s = Td[..., 0, 0]
    mx = -Td[..., 0, 2] / s
    my = -Td[..., 1, 2] / s
    inv_s = 1.0 / s
    zeros = jnp.zeros_like(s)
    ones_ = jnp.ones_like(s)
    Td_inv = jnp.stack([
        jnp.stack([inv_s, zeros, mx], -1),
        jnp.stack([zeros, inv_s, my], -1),
        jnp.stack([zeros, zeros, ones_], -1),
    ], axis=-2)
    H = mm(mm(Td_inv, Hn), Ts)
    h22 = H[..., 2:3, 2:3]
    scale = jnp.where(jnp.abs(h22) < 1e-12, 1.0, h22)
    H = H / scale
    ok = ok & jnp.all(jnp.isfinite(H), axis=(-1, -2))
    return H, ok


def transfer_errors(H: jnp.ndarray, src: jnp.ndarray, dst: jnp.ndarray):
    """Forward transfer distance per point — OpenCV's RANSAC residual for
    findHomography."""
    pred = apply_h(H, src)
    return jnp.linalg.norm(pred - dst, axis=-1)


def symmetric_transfer_errors(H, src, dst):
    fwd = transfer_errors(H, src, dst)
    bwd = transfer_errors(inv3x3(H), dst, src)
    return fwd + bwd


def sample_is_degenerate(pts: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """True if any 3 of the 4 sample points [...,4,2] are (near-)collinear —
    OpenCV's checkSubset degeneracy rejection."""
    idx3 = jnp.array(
        [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], dtype=jnp.int32)
    tri = pts[..., idx3, :]  # [...,4,3,2]
    a = tri[..., 1, :] - tri[..., 0, :]
    b = tri[..., 2, :] - tri[..., 0, :]
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    # Scale-aware threshold.
    scale = jnp.maximum(
        jnp.linalg.norm(a, axis=-1) * jnp.linalg.norm(b, axis=-1), 1e-12)
    return jnp.any(jnp.abs(cross) / scale < eps, axis=-1)
