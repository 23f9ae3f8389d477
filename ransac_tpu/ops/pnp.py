"""Perspective-n-Point solvers: P3P (Grunert), EPnP, DLT-PnP.

JAX replacement for the minimal solvers inside
``cv2.solvePnPRansac`` (``/root/reference/main_v1.py:497-502``,
``testpro-K.py:72-75``).  OpenCV iterates P3P/EPnP sequentially in C++; here
each solver is a pure function over one minimal sample that vmaps over a
hypothesis tensor — thousands of P3P solves per XLA launch.

Constraint that shapes the design: XLA has no batched general
nonsymmetric eigensolver on every backend, so the P3P quartic does not use
a companion matrix (the CPU route).  Instead the quartic is built by explicit resultant elimination
and solved closed-form (Ferrari, ``ops.linalg.solve_quartic_real``),
branch-free and vmappable.

Conventions: world-to-camera (R, t), x_cam = R @ X + t.
"""

from __future__ import annotations

import jax.numpy as jnp

from ransac_tpu.ops.linalg import (inv3x3, nullspace_last_fast,
                                    solve_quartic_real, solve_unrolled)
from ransac_tpu.ops.precision import einsum, mm
from ransac_tpu.ops.rotation import project_to_so3


def bearing_vectors(pixels_norm: jnp.ndarray) -> jnp.ndarray:
    """Normalized image coords [...,N,2] -> unit bearing vectors [...,N,3]."""
    ones = jnp.ones_like(pixels_norm[..., :1])
    v = jnp.concatenate([pixels_norm, ones], axis=-1)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def absolute_orientation(
    Xw: jnp.ndarray, Xc: jnp.ndarray, weights: jnp.ndarray | None = None
):
    """Weighted Kabsch: rigid (R, t) minimizing ||(R Xw + t) - Xc||.

    Xw/Xc [...,N,3].  Returns (R [...,3,3], t [...,3]).
    """
    if weights is None:
        w = jnp.ones(Xw.shape[:-1], Xw.dtype)
    else:
        w = weights.astype(Xw.dtype)
    wsum = jnp.maximum(w.sum(-1, keepdims=True), 1e-12)
    cw = (Xw * w[..., None]).sum(-2) / wsum
    cc = (Xc * w[..., None]).sum(-2) / wsum
    Aw = Xw - cw[..., None, :]
    Ac = Xc - cc[..., None, :]
    H = einsum("...ni,...nj->...ij", Ac * w[..., None], Aw)
    R = project_to_so3(H)
    t = cc - einsum("...ij,...j->...i", R, cw)
    return R, t


def triad_orientation(Xw: jnp.ndarray, Xc: jnp.ndarray):
    """Exact 3-point absolute orientation via triangle frames.

    For congruent point triples (the P3P back-substitution case) this is
    closed-form and eigensolver-free: build an orthonormal triad from the
    triangle in each coordinate system and compose.  Batched elementwise
    math — the hot-path replacement for SVD-based Kabsch, which can run
    as a per-matrix loop.

    Xw/Xc [...,3,3] (rows = points).  Returns (R, t): Xc ~ R @ Xw + t.
    """

    def triad(P):
        u = P[..., 1, :] - P[..., 0, :]
        v = P[..., 2, :] - P[..., 0, :]
        e1 = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
        v_perp = v - jnp.sum(v * e1, -1, keepdims=True) * e1
        e2 = v_perp / jnp.maximum(
            jnp.linalg.norm(v_perp, axis=-1, keepdims=True), 1e-12)
        e3 = jnp.cross(e1, e2)
        return jnp.stack([e1, e2, e3], axis=-1)  # columns

    Bw = triad(Xw)
    Bc = triad(Xc)
    R = mm(Bc, jnp.swapaxes(Bw, -1, -2))
    cw = Xw.mean(-2)
    cc = Xc.mean(-2)
    t = cc - einsum("...ij,...j->...i", R, cw)
    return R, t


def p3p_grunert(Xw: jnp.ndarray, pixels_norm: jnp.ndarray):
    """Grunert's P3P on one minimal sample.

    Xw [...,3,3] world points, pixels_norm [...,3,2] normalized image
    coords.  Returns (R [...,4,3,3], t [...,4,3], valid [...,4]) — up to 4
    solutions, invalid slots masked (branch-free: callers gate on ``valid``).

    Derivation: with depths s1, s2=u*s1, s3=v*s1 along the unit bearings,
    the three law-of-cosines constraints reduce (resultant elimination of u)
    to one quartic in v; each real positive root yields one pose via
    3-point absolute orientation.
    """
    f = bearing_vectors(pixels_norm)  # [...,3,3]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = Xw[..., 0, :], Xw[..., 1, :], Xw[..., 2, :]

    cos_a = jnp.sum(f2 * f3, -1)  # angle opposite side a = |P2-P3|
    cos_b = jnp.sum(f1 * f3, -1)
    cos_g = jnp.sum(f1 * f2, -1)
    a2 = jnp.sum((P2 - P3) ** 2, -1)
    b2 = jnp.sum((P1 - P3) ** 2, -1)
    c2 = jnp.sum((P1 - P2) ** 2, -1)
    b2 = jnp.where(b2 < 1e-12, 1e-12, b2)
    ra = a2 / b2
    rc = c2 / b2

    # Qa(v) = ra (1 + v^2 - 2 v cos_b); Qc(v) = rc (1 + v^2 - 2 v cos_b).
    qa2, qa1, qa0 = ra, -2.0 * ra * cos_b, ra
    qc2, qc1, qc0 = rc, -2.0 * rc * cos_b, rc
    # N(v) = v^2 - Qa - 1 + Qc ;  P(v) = 1 - Qc ;  D(v) = 2 cos_a v - 2 cos_g.
    n2, n1, n0 = 1.0 - qa2 + qc2, -qa1 + qc1, -qa0 - 1.0 + qc0
    p2, p1, p0 = -qc2, -qc1, 1.0 - qc0
    d1, d0 = 2.0 * cos_a, -2.0 * cos_g

    # Quartic N^2 - 2 cos_g N D + P D^2 = 0.
    c4 = n2 * n2 + p2 * d1 * d1
    c3 = 2 * n2 * n1 - 2 * cos_g * (n2 * d1) + 2 * p2 * d1 * d0 + p1 * d1 * d1
    c2_ = (2 * n2 * n0 + n1 * n1 - 2 * cos_g * (n2 * d0 + n1 * d1)
           + p2 * d0 * d0 + 2 * p1 * d1 * d0 + p0 * d1 * d1)
    c1 = (2 * n1 * n0 - 2 * cos_g * (n1 * d0 + n0 * d1)
          + p1 * d0 * d0 + 2 * p0 * d1 * d0)
    c0 = n0 * n0 - 2 * cos_g * (n0 * d0) + p0 * d0 * d0

    v_roots, v_ok = solve_quartic_real(c4, c3, c2_, c1, c0)  # [...,4]

    # Back-substitute each root.
    def per_root(v):
        D = d1[..., None] * v + d0[..., None]
        N = (n2[..., None] * v + n1[..., None]) * v + n0[..., None]
        u = N / jnp.where(jnp.abs(D) < 1e-9, 1e-9, D)
        s1_sq = b2[..., None] / jnp.maximum(
            1.0 + v * v - 2.0 * v * cos_b[..., None], 1e-12)
        s1 = jnp.sqrt(s1_sq)
        s2 = u * s1
        s3 = v * s1
        ok = (v > 1e-6) & (u > 1e-6) & (jnp.abs(D) > 1e-9)
        return s1, s2, s3, ok

    s1, s2, s3, s_ok = per_root(v_roots)
    valid = v_ok & s_ok

    # Newton polish of the depths on the exact law-of-cosines system —
    # recovers the precision the f32 quartic loses on clustered roots.
    # The 3x3 solve is closed-form (adjugate): batched jnp.linalg.solve
    # can lower to a per-matrix loop, which would throttle the whole
    # hypothesis batch.
    ca, cb, cg = cos_a[..., None], cos_b[..., None], cos_g[..., None]
    a2e, b2e, c2e = a2[..., None], b2[..., None], c2[..., None]
    for _ in range(3):
        r1 = -(s2 * s2 + s3 * s3 - 2.0 * s2 * s3 * ca - a2e)
        r2 = -(s1 * s1 + s3 * s3 - 2.0 * s1 * s3 * cb - b2e)
        r3 = -(s1 * s1 + s2 * s2 - 2.0 * s1 * s2 * cg - c2e)
        # J = [[0, j12, j13], [j21, 0, j23], [j31, j32, 0]].
        j12 = 2 * s2 - 2 * s3 * ca
        j13 = 2 * s3 - 2 * s2 * ca
        j21 = 2 * s1 - 2 * s3 * cb
        j23 = 2 * s3 - 2 * s1 * cb
        j31 = 2 * s1 - 2 * s2 * cg
        j32 = 2 * s2 - 2 * s1 * cg
        det = j13 * j21 * j32 + j12 * j23 * j31
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
        # Cramer's rule with the zero-diagonal structure.
        ds1 = (r1 * (-j23 * j32) - j12 * (r2 * 0.0 - j23 * r3)
               + j13 * (r2 * j32 - 0.0)) * inv_det
        ds2 = (0.0 - r1 * (j21 * 0.0 - j23 * j31)
               + j13 * (j21 * r3 - r2 * j31)) * inv_det
        ds3 = (0.0 - j12 * (j21 * r3 - r2 * j31)
               + r1 * (j21 * j32 - 0.0)) * inv_det
        lim = 0.1 * jnp.abs(s1) + 1e-6
        s1 = s1 + jnp.clip(ds1, -lim, lim)
        s2 = s2 + jnp.clip(ds2, -lim, lim)
        s3 = s3 + jnp.clip(ds3, -lim, lim)
    valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # Camera-frame points for all 4 roots: [...,4,3,3].
    Xc = jnp.stack([
        s1[..., None] * f1[..., None, :],
        s2[..., None] * f2[..., None, :],
        s3[..., None] * f3[..., None, :],
    ], axis=-2)
    Xw4 = jnp.broadcast_to(Xw[..., None, :, :], Xc.shape)
    R, t = triad_orientation(Xw4, Xc)
    return R, t, valid


def epnp(Xw: jnp.ndarray, pixels_norm: jnp.ndarray,
         weights: jnp.ndarray | None = None):
    """EPnP (Lepetit et al.) for N>=4 points, normalized image coords.

    Solves the beta-case-1 and beta-case-2 candidates and returns both so
    the caller picks by reprojection error.  Returns (R [...,2,3,3],
    t [...,2,3], valid [...,2]).
    """
    if weights is None:
        w = jnp.ones(Xw.shape[:-1], Xw.dtype)
    else:
        w = weights.astype(Xw.dtype)
    wsum = jnp.maximum(w.sum(-1), 1e-12)

    # Control points: centroid + principal axes.
    c0 = (Xw * w[..., None]).sum(-2) / wsum[..., None]
    Xc0 = (Xw - c0[..., None, :]) * w[..., None]
    cov = einsum("...ni,...nj->...ij", Xc0, Xc0) / wsum[..., None, None]
    eval_, evec = jnp.linalg.eigh(cov)  # ascending
    scale = jnp.sqrt(jnp.maximum(eval_, 1e-10))
    ctrl = jnp.concatenate([
        c0[..., None, :],
        c0[..., None, :] + scale[..., :, None] * jnp.swapaxes(evec, -1, -2),
    ], axis=-2)  # [...,4,3]

    # Barycentric coordinates: solve [ctrl^T; 1] alpha = [X; 1].
    ones_row = jnp.ones((*ctrl.shape[:-2], 1, 4), ctrl.dtype)
    CT = jnp.concatenate([jnp.swapaxes(ctrl, -1, -2), ones_row], axis=-2)
    Xh = jnp.concatenate([Xw, jnp.ones_like(Xw[..., :1])], -1)  # [...,N,4]
    alphas, _ = solve_unrolled(
        jnp.broadcast_to(CT[..., None, :, :], (*Xw.shape[:-1], 4, 4)),
        Xh)  # [...,N,4]

    # M matrix (2N x 12) in normalized coords (fx=fy=1, cx=cy=0).
    u = pixels_norm[..., 0]
    v = pixels_norm[..., 1]
    zeros = jnp.zeros_like(alphas)
    rx = jnp.concatenate([alphas, zeros, -u[..., None] * alphas], -1)
    ry = jnp.concatenate([zeros, alphas, -v[..., None] * alphas], -1)
    # Interleave into [..., 2N, 12] with control-point-major layout
    # [a0 x, a1 x, a2 x, a3 x | a0 y, ... ] -> reorder to per-ctrl (x,y,z):
    # columns j*3+k = ctrl j, coord k.  Build directly:
    def rows(coef_u):
        # coef_u: u or v; returns [...,N,12]
        cols = []
        for j in range(4):
            cols.append(alphas[..., j])      # x_j coefficient
            cols.append(jnp.zeros_like(u))   # y_j
            cols.append(-coef_u * alphas[..., j])  # z_j
        return jnp.stack(cols, -1)

    def rows_v(coef_v):
        cols = []
        for j in range(4):
            cols.append(jnp.zeros_like(v))
            cols.append(alphas[..., j])
            cols.append(-coef_v * alphas[..., j])
        return jnp.stack(cols, -1)

    Mx = rows(u) * w[..., None]
    My = rows_v(v) * w[..., None]
    M = jnp.concatenate([Mx, My], axis=-2)  # [...,2N,12]

    MtM = einsum("...ni,...nj->...ij", M, M)
    eigval, eigvec = jnp.linalg.eigh(MtM)
    V = eigvec[..., :, 0]  # kernel vector (smallest eigenvalue), [...,12]
    V2 = eigvec[..., :, 1]

    cc_w = ctrl  # world control points [...,4,3]
    dw = cc_w[..., None, :, :] - cc_w[..., :, None, :]
    dist_w = jnp.sqrt(jnp.maximum((dw * dw).sum(-1), 1e-12))  # [...,4,4]
    iu = jnp.triu_indices(4, k=1)

    def case1(Vk):
        cc = Vk.reshape(*Vk.shape[:-1], 4, 3)
        dc = cc[..., None, :, :] - cc[..., :, None, :]
        dist_c = jnp.sqrt(jnp.maximum((dc * dc).sum(-1), 1e-20))
        beta = (dist_w[..., iu[0], iu[1]] * dist_c[..., iu[0], iu[1]]).sum(-1) / \
            jnp.maximum((dist_c[..., iu[0], iu[1]] ** 2).sum(-1), 1e-20)
        cc_cam = beta[..., None, None] * cc
        # Sign: depths must be positive for the majority of points.
        Xcam = einsum("...nj,...jk->...nk", alphas, cc_cam)
        sign = jnp.where((Xcam[..., 2] * w).sum(-1) < 0, -1.0, 1.0)
        return Xcam * sign[..., None, None]

    Xcam1 = case1(V)
    # Case-2 seed: combine kernel vectors v1 + lam v2 with lam from distance
    # constraints (linear least squares in (b11, b12, b22) then sqrt).
    def case2(Vk1, Vk2):
        cc1 = Vk1.reshape(*Vk1.shape[:-1], 4, 3)
        cc2 = Vk2.reshape(*Vk2.shape[:-1], 4, 3)
        d1 = (cc1[..., None, :, :] - cc1[..., :, None, :])[..., iu[0], iu[1], :]
        d2 = (cc2[..., None, :, :] - cc2[..., :, None, :])[..., iu[0], iu[1], :]
        # ||b1 d1 + b2 d2||^2 = dist_w^2 -> [d1.d1, 2 d1.d2, d2.d2] @
        # [b1^2, b1 b2, b2^2] = dw2
        A = jnp.stack([
            (d1 * d1).sum(-1), 2.0 * (d1 * d2).sum(-1), (d2 * d2).sum(-1)
        ], -1)  # [...,6,3]
        rhs = (dist_w[..., iu[0], iu[1]] ** 2)[..., None]
        AtA = einsum("...ni,...nj->...ij", A, A)
        Atb = einsum("...ni,...nk->...ik", A, rhs)[..., 0]
        sol = einsum("...ij,...j->...i", inv3x3(AtA, eps=1e-9), Atb)
        b1 = jnp.sqrt(jnp.maximum(sol[..., 0], 1e-20))
        b2 = sol[..., 1] / jnp.maximum(b1, 1e-10)
        cc_cam = b1[..., None, None] * cc1 + b2[..., None, None] * cc2
        Xcam = einsum("...nj,...jk->...nk", alphas, cc_cam)
        sign = jnp.where((Xcam[..., 2] * w).sum(-1) < 0, -1.0, 1.0)
        return Xcam * sign[..., None, None]

    Xcam2 = case2(V, V2)

    R1, t1 = absolute_orientation(Xw, Xcam1, w)
    R2, t2 = absolute_orientation(Xw, Xcam2, w)
    R = jnp.stack([R1, R2], axis=-3)
    t = jnp.stack([t1, t2], axis=-2)
    valid = jnp.ones(R.shape[:-2], bool)
    return R, t, valid


def dlt_pnp(Xw: jnp.ndarray, pixels_norm: jnp.ndarray,
            weights: jnp.ndarray | None = None):
    """Linear PnP from N>=6 points via DLT on P = [R|t] (normalized coords),
    then SO(3) projection.  Workhorse refit solver for PnP-RANSAC."""
    if weights is None:
        w = jnp.ones(Xw.shape[:-1], Xw.dtype)
    else:
        w = weights.astype(Xw.dtype)
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    u, v = pixels_norm[..., 0], pixels_norm[..., 1]
    one = jnp.ones_like(X)
    zero = jnp.zeros_like(X)
    r1 = jnp.stack([X, Y, Z, one, zero, zero, zero, zero,
                    -u * X, -u * Y, -u * Z, -u], -1)
    r2 = jnp.stack([zero, zero, zero, zero, X, Y, Z, one,
                    -v * X, -v * Y, -v * Z, -v], -1)
    A = jnp.concatenate([r1 * w[..., None], r2 * w[..., None]], axis=-2)
    p = nullspace_last_fast(A)
    P = p.reshape(*p.shape[:-1], 3, 4)
    M = P[..., :3]
    # Scale and sign: force det(R) > 0 and positive mean depth.
    detM = jnp.linalg.det(M)
    sign = jnp.where(detM < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    M = P[..., :3]
    s = jnp.abs(jnp.linalg.det(M)) ** (1.0 / 3.0)
    s = jnp.maximum(s, 1e-12)
    R = project_to_so3(M / s[..., None, None])
    t = P[..., 3] / s[..., None]
    return R, t
