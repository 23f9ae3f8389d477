"""Generic Levenberg-Marquardt inside jit.

JAX replacement for ``cv2.solvePnPRefineLM``
(``/root/reference/main_v1.py:508``), OpenCV's internal homography LM
refinement, and ``scipy.optimize.least_squares`` on the 3-scale ray fit
(``test_pro.py:882-886``).  One damped Gauss-Newton core, Jacobians by
forward-mode AD, the damping schedule as a ``lax.while_loop`` carry — the
same core scales from 3-parameter ray fits to 6-DoF pose refinement and is
reused (block-structured) by bundle adjustment.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ransac_tpu.ops.precision import mm



class LMResult(NamedTuple):
    x: jnp.ndarray
    cost: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray


def levenberg_marquardt(
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    max_iters: int = 30,
    damping_init: float = 1e-3,
    damping_up: float = 10.0,
    damping_down: float = 0.1,
    rtol: float = 1e-10,
    damping_max: float = 1e8,
) -> LMResult:
    """Minimize 0.5 ||r(x)||^2 for a small dense parameter vector x.

    Shape-static: runs a ``lax.while_loop`` with a convergence flag in the
    carry; residual_fn must be jit-traceable with fixed output shape.
    Masked residuals (multiply by 0/1 weights inside residual_fn) give
    inlier-only refinement without dynamic shapes.
    """
    x0 = jnp.asarray(x0)
    n = x0.shape[-1]
    eye = jnp.eye(n, dtype=x0.dtype)

    def cost_of(x):
        r = residual_fn(x)
        return 0.5 * jnp.sum(r * r)

    def body(carry):
        x, lam, cost, it, done = carry
        r = residual_fn(x)
        J = jax.jacfwd(residual_fn)(x)
        g = mm(J.T, r)
        H = mm(J.T, J)
        # Marquardt scaling: lam * diag(H) keeps steps well-conditioned
        # across wildly different parameter scales (rotation vs meters).
        D = jnp.diag(jnp.maximum(jnp.diag(H), 1e-12))
        if n <= 16:
            # Unrolled elementwise solve: under vmap (e.g. 458
            # per-candidate refinements) jnp.linalg.solve can lower to a
            # per-matrix LAPACK-style loop.
            from ransac_tpu.ops.linalg import solve_unrolled

            dx, _ = solve_unrolled(H + lam * D, -g)
        else:
            # Damped J^T J is SPD: pivot-free Gauss-Jordan fori_loop
            # (see ops.linalg.solve_spd_gj; e.g. the pose-graph's
            # [6V, 6V] system).
            from ransac_tpu.ops.linalg import solve_spd_gj

            dx = solve_spd_gj(H + lam * D, -g)
        x_new = x + dx
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        x = jnp.where(accept, x_new, x)
        lam = jnp.where(accept, jnp.maximum(lam * damping_down, 1e-12),
                        jnp.minimum(lam * damping_up, damping_max))
        improved = jnp.abs(cost - cost_new) <= rtol * jnp.maximum(cost, 1e-30)
        done = done | (accept & improved) | (lam >= damping_max)
        cost = jnp.where(accept, cost_new, cost)
        return x, lam, cost, it + 1, done

    def cond(carry):
        _, _, _, it, done = carry
        return (it < max_iters) & jnp.logical_not(done)

    init = (x0, jnp.asarray(damping_init, x0.dtype), cost_of(x0),
            jnp.asarray(0), jnp.asarray(False))
    x, lam, cost, it, done = jax.lax.while_loop(cond, body, init)
    return LMResult(x=x, cost=cost, iterations=it, converged=done)


def refine_pose(
    rvec0: jnp.ndarray,
    tvec0: jnp.ndarray,
    Xw: jnp.ndarray,
    pixels: jnp.ndarray,
    K: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    max_iters: int = 30,
):
    """6-DoF pose LM on reprojection error — ``cv2.solvePnPRefineLM``
    equivalent; vmappable over batches of poses."""
    from ransac_tpu.ops.projection import project_points
    from ransac_tpu.ops.rotation import exp_so3

    if weights is None:
        w = jnp.ones(Xw.shape[:-1], Xw.dtype)
    else:
        w = weights.astype(Xw.dtype)

    def residuals(params):
        R = exp_so3(params[:3])
        pix, _ = project_points(Xw, R, params[3:6], K)
        return ((pix - pixels) * w[..., None]).reshape(-1)

    x0 = jnp.concatenate([rvec0, tvec0])
    res = levenberg_marquardt(residuals, x0, max_iters=max_iters)
    return res.x[:3], res.x[3:6], res


def refine_homography(
    H0: jnp.ndarray,
    src: jnp.ndarray,
    dst: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    max_iters: int = 20,
):
    """8-parameter homography LM on forward transfer error (h33 fixed at 1)
    — matches OpenCV findHomography's final refinement stage."""
    from ransac_tpu.ops.homography import apply_h

    if weights is None:
        w = jnp.ones(src.shape[:-1], src.dtype)
    else:
        w = weights.astype(src.dtype)
    h33 = jnp.where(jnp.abs(H0[2, 2]) < 1e-12, 1.0, H0[2, 2])
    h0 = (H0 / h33).reshape(9)[:8]

    def residuals(h8):
        H = jnp.concatenate([h8, jnp.ones((1,), h8.dtype)]).reshape(3, 3)
        pred = apply_h(H, src)
        return ((pred - dst) * w[..., None]).reshape(-1)

    res = levenberg_marquardt(residuals, h0, max_iters=max_iters)
    H = jnp.concatenate([res.x, jnp.ones((1,), res.x.dtype)]).reshape(3, 3)
    return H, res


def fit_ray_scales(
    control_dirs_ideal: jnp.ndarray,
    control_rays: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    max_iters: int = 30,
):
    """3-parameter per-axis ray-scale fit — the JAX equivalent of
    ``scipy.optimize.least_squares(residual_scales_control_points, ...)``
    (test_pro.py:645-680, 882-887): find s minimizing
    || normalize(s * ray_i) - ideal_dir_i ||."""
    if weights is None:
        w = jnp.ones(control_rays.shape[:-1], control_rays.dtype)
    else:
        w = weights.astype(control_rays.dtype)

    def residuals(s):
        corr = control_rays * s[None, :]
        corr = corr / jnp.maximum(
            jnp.linalg.norm(corr, axis=-1, keepdims=True), 1e-12)
        return ((corr - control_dirs_ideal) * w[..., None]).reshape(-1)

    res = levenberg_marquardt(
        residuals, jnp.ones((3,), control_rays.dtype), max_iters=max_iters)
    return res.x, res
