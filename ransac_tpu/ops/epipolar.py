"""Two-view epipolar geometry: 8-point F/E, pose decomposition,
triangulation.

The reference has no two-view stage (single-image localization only); this
module provides the BASELINE.json configs[2] capability ("two-view pipeline:
8-point essential-matrix RANSAC, triangulation") on the same batched,
vmappable pattern as the homography/PnP solvers.
"""

from __future__ import annotations

import jax.numpy as jnp

from ransac_tpu.ops.homography import normalization_transform
from ransac_tpu.ops.linalg import nullspace_last_fast, svd3x3
from ransac_tpu.ops.precision import einsum, mm
from ransac_tpu.ops.rotation import project_to_so3


def eight_point(
    x1: jnp.ndarray, x2: jnp.ndarray, weights: jnp.ndarray | None = None,
    essential: bool = True, rank2: bool = True,
) -> jnp.ndarray:
    """Normalized 8-point algorithm on [...,N>=8,2] correspondences.

    Returns F (or E) [...,3,3] with rank-2 constraint enforced; for E the
    two nonzero singular values are averaged (the closest true essential
    matrix in Frobenius norm).  ``rank2=False`` returns the unconstrained
    linear solution — what RANSAC kernels score for a minimal sample;
    projecting a minimal exactly-fit F to rank 2 / essential can distort
    it badly and collapse its consensus set.
    """
    T1 = normalization_transform(x1, weights)
    T2 = normalization_transform(x2, weights)
    ones = jnp.ones_like(x1[..., :1])
    p1 = mm(jnp.concatenate([x1, ones], -1), jnp.swapaxes(T1, -1, -2))
    p2 = mm(jnp.concatenate([x2, ones], -1), jnp.swapaxes(T2, -1, -2))
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    one = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], -1)
    if weights is not None:
        A = A * weights[..., None]
    f = nullspace_last_fast(A)
    F = f.reshape(*f.shape[:-1], 3, 3)
    # Denormalize FIRST: the Hartley transforms are not orthogonal, so
    # singular-value constraints enforced in the normalized frame do not
    # survive denormalization (enforcing sigma1=sigma2 there visibly
    # distorts an exact essential matrix and costs inliers).
    F = mm(mm(jnp.swapaxes(T2, -1, -2), F), T1)
    if rank2:
        U, S, Vt = svd3x3(F)
        if essential:
            s = (S[..., 0] + S[..., 1]) / 2.0
            S2 = jnp.stack([s, s, jnp.zeros_like(s)], -1)
        else:
            S2 = S.at[..., 2].set(0.0)
        F = mm(U * S2[..., None, :], Vt)
    norm = jnp.linalg.norm(F.reshape(*F.shape[:-2], 9), axis=-1)
    return F / jnp.maximum(norm, 1e-12)[..., None, None]


def sampson_distance(F: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray):
    """First-order geometric (Sampson) distance per correspondence."""
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], -1)
    p2 = jnp.concatenate([x2, ones], -1)
    Fx1 = einsum("...ij,...nj->...ni", F, p1)
    Ftx2 = einsum("...ji,...nj->...ni", F, p2)
    x2Fx1 = jnp.sum(p2 * Fx1, -1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 \
        + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return (x2Fx1 * x2Fx1) / jnp.maximum(denom, 1e-12)


def decompose_essential(E: jnp.ndarray):
    """E -> four candidate (R, t) with ||t||=1: (R1,t), (R1,-t), (R2,t),
    (R2,-t).  Returns (R [...,4,3,3], t [...,4,3])."""
    U, _, Vt = svd3x3(E)
    # Ensure proper rotations.
    detU = jnp.linalg.det(U)
    detV = jnp.linalg.det(Vt)
    U = U * jnp.stack(
        [jnp.ones_like(detU), jnp.ones_like(detU), detU], -1)[..., None, :]
    Vt = Vt * jnp.stack(
        [jnp.ones_like(detV), jnp.ones_like(detV), detV], -1)[..., :, None]
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                  dtype=E.dtype)
    R1 = mm(mm(U, W), Vt)
    R2 = mm(mm(U, W.T), Vt)
    t = U[..., :, 2]
    R = jnp.stack([R1, R1, R2, R2], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return R, ts


def triangulate_dlt(
    x1: jnp.ndarray, x2: jnp.ndarray,
    R1: jnp.ndarray, t1: jnp.ndarray, R2: jnp.ndarray, t2: jnp.ndarray,
) -> jnp.ndarray:
    """DLT triangulation of [...,N,2] normalized correspondences seen from
    poses (R1,t1)/(R2,t2).  Returns world points [...,N,3]."""
    P1 = jnp.concatenate([R1, t1[..., :, None]], -1)  # [...,3,4]
    P2 = jnp.concatenate([R2, t2[..., :, None]], -1)

    def rows(P, x):
        # x [...,N,2]; P [...,3,4] -> two rows per point [...,N,2,4]
        r1 = x[..., 0, None] * P[..., None, 2, :] - P[..., None, 0, :]
        r2 = x[..., 1, None] * P[..., None, 2, :] - P[..., None, 1, :]
        return jnp.stack([r1, r2], axis=-2)

    A = jnp.concatenate([rows(P1, x1), rows(P2, x2)], axis=-2)  # [...,N,4,4]
    X = nullspace_last_fast(A)
    w = X[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


def cheirality_counts(
    x1: jnp.ndarray, x2: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray,
    weights: jnp.ndarray | None = None,
):
    """Count points with positive depth in both views for a relative pose
    (view1 at identity).  Used to pick the true (R, t) among the four
    essential decompositions."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    zero = jnp.zeros_like(t)
    X = triangulate_dlt(x1, x2, eye, zero, R, t)
    z1 = X[..., 2]
    Xc2 = einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z2 = Xc2[..., 2]
    ok = (z1 > 0) & (z2 > 0)
    if weights is not None:
        ok = ok & (weights > 0)
    return ok.sum(-1), X


def recover_pose(E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray,
                 weights: jnp.ndarray | None = None):
    """cv2.recoverPose equivalent: choose the decomposition maximizing
    cheirality.  Returns (R, t, points3d, n_cheiral)."""
    Rs, ts = decompose_essential(E)
    counts, Xs = _cheirality_all(x1, x2, Rs, ts, weights)
    best = jnp.argmax(counts, axis=-1)
    R = jnp.take_along_axis(Rs, best[..., None, None, None].repeat(3, -2).repeat(3, -1), -3).squeeze(-3)
    t = jnp.take_along_axis(ts, best[..., None, None].repeat(3, -1), -2).squeeze(-2)
    X = jnp.take_along_axis(
        Xs, best[..., None, None, None].repeat(Xs.shape[-2], -2).repeat(3, -1),
        -3).squeeze(-3)
    n = jnp.take_along_axis(counts, best[..., None], -1).squeeze(-1)
    return R, t, X, n


def _cheirality_all(x1, x2, Rs, ts, weights):
    counts = []
    Xs = []
    for k in range(4):
        c, X = cheirality_counts(x1, x2, Rs[..., k, :, :], ts[..., k, :],
                                 weights)
        counts.append(c)
        Xs.append(X)
    return jnp.stack(counts, -1), jnp.stack(Xs, -3)


def refine_relative_pose(R: jnp.ndarray, t: jnp.ndarray,
                         x1: jnp.ndarray, x2: jnp.ndarray,
                         weights: jnp.ndarray | None = None,
                         max_iters: int = 20):
    """LM-refine a relative pose on Sampson residuals of E = [t]x R.

    The 8-point + inlier-refit estimate minimizes an algebraic error; this
    polishes the 5-DoF geometric optimum (rvec + unnormalized t, norm
    gauge absorbed by Marquardt damping) — the step OpenCV users get from
    findEssentialMat + recoverPose + bundle steps.  Returns (R, t_unit, E).
    """
    from ransac_tpu.ops.lm import levenberg_marquardt
    from ransac_tpu.ops.rotation import exp_so3, log_so3

    w = jnp.ones(x1.shape[:-1], x1.dtype) if weights is None else weights

    def build_E(params):
        Rm = exp_so3(params[:3])
        tv = params[3:]
        tn = tv / jnp.maximum(jnp.linalg.norm(tv), 1e-12)
        tx = jnp.array([[0.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]]) * tn[0] + \
            jnp.array([[0, 0, 1.0], [0, 0, 0], [-1.0, 0, 0]]) * tn[1] + \
            jnp.array([[0, -1.0, 0], [1.0, 0, 0], [0, 0, 0]]) * tn[2]
        return mm(tx, Rm)

    def resid(params):
        E = build_E(params)
        d2 = sampson_distance(E, x1, x2)
        return jnp.sqrt(jnp.maximum(d2, 1e-20)) * w

    x0 = jnp.concatenate([log_so3(R), t])
    res = levenberg_marquardt(resid, x0, max_iters=max_iters)
    Rr = exp_so3(res.x[:3])
    tr = res.x[3:] / jnp.maximum(jnp.linalg.norm(res.x[3:]), 1e-12)
    return Rr, tr, build_E(res.x)
