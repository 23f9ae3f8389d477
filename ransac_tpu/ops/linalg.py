"""Small closed-form linear-algebra kernels for minimal solvers.

XLA has no batched general nonsymmetric eigensolver on every backend, so
the quartic at the core of P3P (Grunert) does not go through a companion
matrix as CPU implementations do.  Instead: closed-form real-arithmetic
cubic (trigonometric/Cardano) and
quartic (Ferrari) solvers, fully branch-free via ``jnp.where`` and therefore
vmappable across hypothesis tensors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ransac_tpu.ops.precision import einsum



def solve_cubic_real(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d = 0 (a assumed nonzero).

    Returns (roots [...,3], valid [...,3]): in the one-real-root case the
    extra slots repeat the real root with valid=False semantics preserved
    (all three returned roots are always real numbers; ``valid`` marks
    distinct genuine roots).
    """
    a = jnp.where(jnp.abs(a) < 1e-30, 1e-30, a)
    b_, c_, d_ = b / a, c / a, d / a
    # Depressed: t^3 + p t + q with x = t - b/3.
    shift = b_ / 3.0
    p = c_ - b_ * b_ / 3.0
    q = 2.0 * b_**3 / 27.0 - b_ * c_ / 3.0 + d_
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # Trig branch (disc <= 0): three real roots.
    p_neg = jnp.minimum(p, -1e-30)
    m = 2.0 * jnp.sqrt(-p_neg / 3.0)
    arg = jnp.clip(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    two_pi_3 = 2.0943951023931953
    t_trig = jnp.stack(
        [m * jnp.cos(theta),
         m * jnp.cos(theta - two_pi_3),
         m * jnp.cos(theta - 2.0 * two_pi_3)], axis=-1)

    # Cardano branch (disc > 0): one real root.
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    t_card = u + v
    t_card3 = jnp.stack([t_card, t_card, t_card], axis=-1)

    use_trig = (disc <= 0.0)[..., None]
    t = jnp.where(use_trig, t_trig, t_card3)
    roots = t - shift[..., None]
    valid = jnp.concatenate(
        [jnp.ones_like(roots[..., :1], bool),
         jnp.broadcast_to(use_trig, roots[..., :1].shape).repeat(2, -1)],
        axis=-1)
    return roots, valid


def solve_quartic_real(a, b, c, d, e):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e = 0 via Ferrari.

    Returns (roots [...,4], valid [...,4]); invalid slots hold finite
    placeholder values.  Branch-free: downstream code must gate on
    ``valid`` (hypothesis masks), never on root values.
    """
    a = jnp.where(jnp.abs(a) < 1e-30, 1e-30, a)
    b_, c_, d_, e_ = b / a, c / a, d / a, e / a
    # Depressed quartic y^4 + p y^2 + q y + r, x = y - b/4.
    shift = b_ / 4.0
    b2 = b_ * b_
    p = c_ - 3.0 * b2 / 8.0
    q = d_ - b_ * c_ / 2.0 + b2 * b_ / 8.0
    r = e_ - b_ * d_ / 4.0 + b2 * c_ / 16.0 - 3.0 * b2 * b2 / 256.0

    # Ferrari: (y^2 + p/2 + m)^2 = 2m (y - q/(4m))^2 when m solves the
    # resolvent cubic  m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0.
    # For q != 0 the resolvent is negative at m=0 with positive leading
    # coefficient, so its largest real root is strictly positive.
    m_roots, m_valid = solve_cubic_real(
        jnp.ones_like(p), p, p * p / 4.0 - r, -q * q / 8.0)
    m_cand = jnp.where(m_valid, m_roots, -jnp.inf)
    m = jnp.maximum(jnp.max(m_cand, axis=-1), 1e-12)

    s = jnp.sqrt(2.0 * m)
    q_term = q / (2.0 * s)
    base = p / 2.0 + m

    # sign=+1: y^2 - s y + (base + q_term) = 0 -> y = +s/2 +/- sqrt(disc)
    # sign=-1: y^2 + s y + (base - q_term) = 0 -> y = -s/2 +/- sqrt(disc)
    def quad(sign):
        cc = base + sign * q_term
        disc = s * s / 4.0 - cc
        ok = disc >= 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        return (sign * s / 2.0 + sq, ok), (sign * s / 2.0 - sq, ok)

    (y1, ok1), (y2, ok2) = quad(1.0)
    (y3, ok3), (y4, ok4) = quad(-1.0)
    ys = jnp.stack([y1, y2, y3, y4], axis=-1)
    ok = jnp.stack([ok1, ok2, ok3, ok4], axis=-1)
    roots = ys - shift[..., None]
    roots = jnp.where(ok, roots, 0.0)

    # Two Newton polish steps on the original quartic (improves f32 roots).
    def poly(x):
        return (x**4 + b_[..., None] * x**3 + c_[..., None] * x**2
                + d_[..., None] * x + e_[..., None])

    def dpoly(x):
        return 4.0 * x**3 + 3.0 * b_[..., None] * x**2 \
            + 2.0 * c_[..., None] * x + d_[..., None]

    for _ in range(2):
        f = poly(roots)
        df = dpoly(roots)
        roots = roots - f / jnp.where(jnp.abs(df) < 1e-20, 1e-20, df)
    roots = jnp.where(ok, roots, 0.0)
    return roots, ok


def solve_unrolled(A: jnp.ndarray, b: jnp.ndarray):
    """Batched small dense solve by fully-unrolled Gaussian elimination with
    partial pivoting, in place of LAPACK-style batched LU (a per-matrix
    loop on some backends).  Here every scalar of the n x n system is a
    [batch] vector and each elimination step is a handful of elementwise
    ops, so XLA fuses the whole batch's solve.

    A [..., n, n], b [..., n] with small static n (<= ~12).
    Returns (x [..., n], ok [...]) where ok flags well-conditioned pivots.
    """
    n = A.shape[-1]
    M = jnp.concatenate([A, b[..., None]], axis=-1)  # [..., n, n+1]
    ok = jnp.ones(A.shape[:-2], bool)
    for k in range(n):
        col = jnp.abs(M[..., k:, k])                      # [..., n-k]
        piv_rel = jnp.argmax(col, axis=-1)                # [...]
        piv_val = jnp.take_along_axis(col, piv_rel[..., None], -1)[..., 0]
        ok = ok & (piv_val > 1e-12)
        # Swap row k with pivot row (one_hot-blend, no dynamic indexing).
        rows = M[..., k:, :]                              # [..., n-k, n+1]
        sel = jax.nn.one_hot(piv_rel, n - k, dtype=M.dtype)  # [..., n-k]
        pivot_row = einsum("...r,...rc->...c", sel, rows)
        row_k = rows[..., 0, :]
        rows = rows - sel[..., None] * (pivot_row - row_k)[..., None, :]
        rows = rows.at[..., 0, :].set(pivot_row)
        # Eliminate below.
        pk = rows[..., 0, k]
        inv_pk = 1.0 / jnp.where(jnp.abs(pk) < 1e-12, 1e-12, pk)
        factors = rows[..., 1:, k] * inv_pk[..., None]
        rows = rows.at[..., 1:, :].add(
            -factors[..., None] * rows[..., 0:1, :])
        M = M.at[..., k:, :].set(rows)
    # Back substitution.
    x = jnp.zeros_like(b)
    for k in range(n - 1, -1, -1):
        rhs = M[..., k, n]
        dot = einsum("...j,...j->...", M[..., k, k + 1:n], x[..., k + 1:]) \
            if k + 1 < n else jnp.zeros_like(rhs)
        diag = M[..., k, k]
        inv_d = 1.0 / jnp.where(jnp.abs(diag) < 1e-12, 1e-12, diag)
        x = x.at[..., k].set((rhs - dot) * inv_d)
    return x, ok


def nullspace_last(A: jnp.ndarray) -> jnp.ndarray:
    """Right-singular vector of the smallest singular value of A [...,m,n]
    — the DLT workhorse (homography, PnP DLT, 8-point)."""
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return Vt[..., -1, :]


def nullspace_last_fast(A: jnp.ndarray, iters: int = 4) -> jnp.ndarray:
    """Smallest right-singular vector of A [...,m,n] WITHOUT LAPACK.

    Inverse iteration on the shifted normal matrix M = A^T A + eps*tr(M)*I
    through :func:`solve_unrolled`, so the whole batch stays elementwise
    — batched small SVD is a per-matrix loop on some backends, which made
    ``nullspace_last`` dominate vmapped refit chains.  Each iteration multiplies the target
    eigencomponent by ~(lambda_2+eps)/(lambda_1+eps), so for DLT systems
    (normalized coords: lambda_2 = O(1), lambda_1 = residual^2) a handful
    of iterations reaches f32 roundoff.  Two deterministic starts guard
    against an unlucky start orthogonal to the nullspace; the lower
    Rayleigh quotient wins.
    """
    n = A.shape[-1]
    M = einsum("...mi,...mj->...ij", A, A)
    tr = jnp.trace(M, axis1=-2, axis2=-1)[..., None, None]
    eye = jnp.eye(n, dtype=A.dtype)
    Ms = M + (1e-6 * tr / n + 1e-30) * eye
    batch = M.shape[:-2]

    def run(x0):
        x = jnp.broadcast_to(x0, (*batch, n))
        for _ in range(iters):
            x, _ = solve_unrolled(Ms, x)
            nrm = jnp.linalg.norm(x, axis=-1, keepdims=True)
            x = x / jnp.maximum(nrm, 1e-30)
        return x

    x1 = run(eye[-1])
    x2 = run(jnp.full((n,), 1.0 / jnp.sqrt(jnp.asarray(float(n))),
                      dtype=A.dtype))

    def rq(x):
        return einsum("...i,...ij,...j->...", x, M, x)

    pick = (rq(x1) <= rq(x2))[..., None]
    return jnp.where(pick, x1, x2)


def solve_spd_gj(A: jnp.ndarray, b: jnp.ndarray,
                 eps: float = 1e-12) -> jnp.ndarray:
    """Single medium-size SPD solve by pivot-free Gauss-Jordan.

    For the damped SPD camera system no pivoting is needed, so a
    ``fori_loop`` of N rank-1 row eliminations over the [N, N+1]
    augmented matrix (each trip one outer-product update) replaces
    ``jnp.linalg.solve``'s LU, which was a large share of a Schur-reduced
    BA step where this was first built.  Not yet compared on the GPU.

    A [N,N] SPD (damped), b [N].  Returns x [N].
    """
    n = A.shape[-1]
    M = jnp.concatenate([A, b[:, None]], axis=1)       # [N, N+1]
    rows = jnp.arange(n)

    def body(k, M):
        row = jax.lax.dynamic_slice_in_dim(M, k, 1, axis=0)[0]  # [N+1]
        piv = jax.lax.dynamic_slice_in_dim(row, k, 1)[0]
        row = row / jnp.where(jnp.abs(piv) < eps, eps, piv)
        col = jax.lax.dynamic_slice_in_dim(M, k, 1, axis=1)[:, 0]
        col = jnp.where(rows == k, 0.0, col)           # pivot row: no self-update
        M = M - col[:, None] * row[None, :]
        return jax.lax.dynamic_update_slice_in_dim(M, row[None], k, axis=0)

    M = jax.lax.fori_loop(0, n, body, M)
    return M[:, n]


def inv3x3(A: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / det).

    ``jnp.linalg.inv`` on a [P,3,3] batch can lower to a per-matrix
    LAPACK-style loop (same pathology as the batched SVD) — in bundle
    adjustment the point-block inverses of the Schur reduction sit
    on every LM iteration, so they must stay vectorized.  ``eps`` is added
    to the diagonal first (damping/regularization).
    """
    if eps:
        A = A + eps * jnp.eye(3, dtype=A.dtype)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack([
        jnp.stack([c00, c01, c02], -1),
        jnp.stack([c10, c11, c12], -1),
        jnp.stack([c20, c21, c22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def eigh3x3(A: jnp.ndarray):
    """Closed-form eigendecomposition of a symmetric 3x3 batch.

    Returns (eigvals ascending [...,3], V [...,3,3] orthonormal columns).
    Batched ``jnp.linalg.eigh``/``svd`` can lower to per-matrix loops;
    this is the vectorized replacement used by the 3x3 SVD below.

    Eigenvalues: trigonometric (Smith) formula.  Eigenvectors: the most
    isolated eigenvalue's vector via the largest row-cross-product of
    (A - lam I) (rank 2 there, robust even when the other two eigenvalues
    coincide); the remaining pair from the exact 2x2 Jacobi rotation in
    its orthogonal complement — no branch is ill-conditioned for
    essential-matrix spectra (sigma1 = sigma2).
    """
    # Scale-normalize: p^3 in the trig formula underflows f32 for
    # small-magnitude inputs (|A| ~ 1e-6 -> p^3 ~ 1e-36).
    scale = jnp.maximum(
        jnp.max(jnp.abs(A), axis=(-2, -1), keepdims=True), 1e-30)
    A = A / scale
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    # det(B)/2 with B = (A - qI)/p
    detb = (b00 * (a11 - q) * (a22 - q) + 2.0 * a01 * a12 * a02
            - b00 * a12 * a12 - b11 * a02 * a02 - b22 * a01 * a01)
    r = jnp.clip(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    l2 = q + 2.0 * p * jnp.cos(phi)              # largest
    l0 = q + 2.0 * p * jnp.cos(phi + two_pi_3)   # smallest
    l1 = 3.0 * q - l0 - l2

    eye = jnp.eye(3, dtype=A.dtype)

    def cross(u, v):
        return jnp.stack([
            u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
            u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
            u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)

    def unit(v):
        return v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)

    # Most isolated eigenvalue (farthest from the other two).
    iso_is_low = (l1 - l0) > (l2 - l1)
    lam_iso = jnp.where(iso_is_low, l0, l2)
    B = A - lam_iso[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01 = jnp.sum(c01 * c01, -1)
    n02 = jnp.sum(c02 * c02, -1)
    n12 = jnp.sum(c12 * c12, -1)
    best = jnp.stack([n01, n02, n12], -1).argmax(-1)
    pick = jax.nn.one_hot(best, 3, dtype=A.dtype)
    v_iso = unit(pick[..., 0:1] * c01 + pick[..., 1:2] * c02
                 + pick[..., 2:3] * c12)
    # Guard: if A is (near-)spherical all crosses vanish; fall back to e0.
    cross_mag = jnp.maximum(jnp.maximum(n01, n02), n12)
    spherical = cross_mag < 1e-24
    v_iso = jnp.where(spherical[..., None],
                      jnp.broadcast_to(eye[0], v_iso.shape), v_iso)

    # Orthonormal basis (w1, w2) of the complement of v_iso.
    axis = jax.nn.one_hot(jnp.argmin(jnp.abs(v_iso), axis=-1), 3,
                          dtype=A.dtype)
    w1 = unit(cross(v_iso, axis))
    w2 = cross(v_iso, w1)
    # Restricted 2x2 symmetric eigenproblem.
    Aw1 = einsum("...ij,...j->...i", A, w1)
    Aw2 = einsum("...ij,...j->...i", A, w2)
    ra = jnp.sum(w1 * Aw1, -1)
    rb = jnp.sum(w1 * Aw2, -1)
    rc = jnp.sum(w2 * Aw2, -1)
    theta = 0.5 * jnp.arctan2(2.0 * rb, ra - rc)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    vp = ct[..., None] * w1 + st[..., None] * w2
    vq = -st[..., None] * w1 + ct[..., None] * w2
    lp = (ct * ct * ra + 2.0 * ct * st * rb + st * st * rc)
    lq = (st * st * ra - 2.0 * ct * st * rb + ct * ct * rc)
    swap = lp > lq
    m_lo = jnp.where(swap, lq, lp)
    m_hi = jnp.where(swap, lp, lq)
    v_lo = jnp.where(swap[..., None], vq, vp)
    v_hi = jnp.where(swap[..., None], vp, vq)

    low = iso_is_low[..., None]
    e0 = jnp.where(iso_is_low, lam_iso, m_lo)
    e1 = jnp.where(iso_is_low, m_lo, m_hi)
    e2 = jnp.where(iso_is_low, m_hi, lam_iso)
    V0 = jnp.where(low, v_iso, v_lo)
    V1 = jnp.where(low, v_lo, v_hi)
    V2 = jnp.where(low, v_hi, v_iso)
    vals = jnp.stack([e0, e1, e2], -1) * scale[..., 0]
    V = jnp.stack([V0, V1, V2], -1)   # columns
    return vals, V


def svd3x3(F: jnp.ndarray):
    """Closed-form batched 3x3 SVD: F = U diag(S) Vt, S descending.

    Via :func:`eigh3x3` of F^T F; the left vectors come from F v / sigma
    with the third column completed by a cross product (so det(U) = +1 —
    downstream det-correction formulas are sign-insensitive to this, see
    ``rotation.project_to_so3`` / ``epipolar.decompose_essential``).
    Exact for rank-2 reconstructions (the sigma_3 component is never used
    with a nonzero weight by callers).
    """
    lam, V = eigh3x3(einsum("...ji,...jk->...ik", F, F))
    # Descending order.
    lam_d = lam[..., ::-1]
    V = V[..., ::-1]
    S = jnp.sqrt(jnp.maximum(lam_d, 0.0))
    u0 = einsum("...ij,...j->...i", F, V[..., 0]) / jnp.maximum(
        S[..., 0], 1e-30)[..., None]
    u1 = einsum("...ij,...j->...i", F, V[..., 1]) / jnp.maximum(
        S[..., 1], 1e-30)[..., None]
    # f32 safety: re-orthonormalize u1 against u0.
    u0 = u0 / jnp.maximum(jnp.linalg.norm(u0, axis=-1, keepdims=True), 1e-30)
    u1 = u1 - jnp.sum(u0 * u1, -1, keepdims=True) * u0
    u1 = u1 / jnp.maximum(jnp.linalg.norm(u1, axis=-1, keepdims=True), 1e-30)
    u2 = jnp.stack([
        u0[..., 1] * u1[..., 2] - u0[..., 2] * u1[..., 1],
        u0[..., 2] * u1[..., 0] - u0[..., 0] * u1[..., 2],
        u0[..., 0] * u1[..., 1] - u0[..., 1] * u1[..., 0]], -1)
    # Align u2 with F v2 when sigma_3 is non-negligible (a true SVD may
    # need det(U) = -1); for (near-)rank-2 inputs keep the det(+1) cross.
    fv2 = einsum("...ij,...j->...i", F, V[..., 2])
    flip = ((jnp.sum(u2 * fv2, -1) < 0.0)
            & (S[..., 2] > 1e-6 * jnp.maximum(S[..., 0], 1e-30)))
    u2 = jnp.where(flip[..., None], -u2, u2)
    U = jnp.stack([u0, u1, u2], -1)
    Vt = jnp.swapaxes(V, -1, -2)
    return U, S, Vt
