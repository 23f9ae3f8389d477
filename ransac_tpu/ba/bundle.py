"""Levenberg-Marquardt bundle adjustment with Schur complement.

The reference's only refinement is single-pose ``cv2.solvePnPRefineLM``
(``/root/reference/main_v1.py:508``); this module generalizes it to joint
multi-camera/multi-point LM (BASELINE.json configs[3]): reprojection
residuals over an observation tensor, per-block normal equations built
with one-hot matmul contractions (no sparse matrices, no scatters — see
``_solve_schur``), the camera system reduced via the Schur complement and
solved by pivot-free Gauss-Jordan, and a damping schedule carried through
``lax.while_loop``.

All shapes are static: cameras [C,6], points [P,3], observations padded to
a fixed O with a weight mask.  The same per-observation block quantities
(U, V, W, g) are what the distributed variant psum-reduces across
observation shards (parallel.dist_ba).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ransac_tpu.ops import projection as proj
from ransac_tpu.ops.precision import einsum, mm
from ransac_tpu.ops.rotation import exp_so3
from ransac_tpu.utils.config import BundleAdjustConfig
from ransac_tpu.ops import linalg
from ransac_tpu.ops.linalg import inv3x3


class BAProblem(NamedTuple):
    cameras: jnp.ndarray    # [C,6] (rvec, tvec)
    points: jnp.ndarray     # [P,3]
    K: jnp.ndarray          # [3,3] shared intrinsics
    obs_cam: jnp.ndarray    # [O] int32
    obs_pt: jnp.ndarray     # [O] int32
    obs_uv: jnp.ndarray     # [O,2]
    obs_w: jnp.ndarray      # [O] weights (0 = padding)


class BAResult(NamedTuple):
    cameras: jnp.ndarray
    points: jnp.ndarray
    cost: jnp.ndarray        # final 0.5*sum(w*r^2)
    initial_cost: jnp.ndarray
    iterations: jnp.ndarray


def _residuals_one(cam6, X, uv, K):
    R = exp_so3(cam6[:3])
    pix, z = proj.project_points(X[None, :], R, cam6[3:6], K)
    return (pix[0] - uv), z[0]


def residuals(p: BAProblem, cameras, points):
    cam = cameras[p.obs_cam]
    X = points[p.obs_pt]
    r, z = jax.vmap(_residuals_one, in_axes=(0, 0, 0, None))(
        cam, X, p.obs_uv, p.K)
    return r * p.obs_w[:, None], z


def cost_fn(p: BAProblem, cameras, points, huber_scale: float = 0.0):
    r, _ = residuals(p, cameras, points)
    r2 = jnp.sum(r * r, axis=-1)
    if huber_scale > 0.0:
        s2 = huber_scale * huber_scale
        rho = jnp.where(r2 <= s2, r2, 2.0 * huber_scale * jnp.sqrt(r2) - s2)
        return 0.5 * jnp.sum(rho)
    return 0.5 * jnp.sum(r2)


def _blocks(p: BAProblem, cameras, points, huber_scale: float):
    """Per-observation Jacobian blocks and residuals (robust-weighted)."""

    def one(cam6, X, uv, w):
        def f(c6, x3):
            r, _ = _residuals_one(c6, x3, uv, p.K)
            return r

        r = f(cam6, X)
        Jc = jax.jacfwd(f, argnums=0)(cam6, X)   # [2,6]
        Jp = jax.jacfwd(f, argnums=1)(cam6, X)   # [2,3]
        if huber_scale > 0.0:
            rn = jnp.linalg.norm(r) + 1e-12
            w_rob = jnp.sqrt(jnp.where(rn <= huber_scale, 1.0,
                                       huber_scale / rn))
        else:
            w_rob = 1.0
        ww = w * w_rob
        return r * ww, Jc * ww, Jp * ww

    cam = cameras[p.obs_cam]
    X = points[p.obs_pt]
    return jax.vmap(one)(cam, X, p.obs_uv, p.obs_w)


def _solve_schur(p: BAProblem, r, Jc, Jp, lam, n_cam, n_pt, fix_first: bool):
    """One damped GN step via dense Schur reduction of the camera system.

    Data movement chosen for the accelerator this was first built for,
    where scatter-adds and batched LU ran serially:

    - ALL per-block accumulations are one-hot MATMULS, not
      ``segment_sum``: [C,O]/[P,O] one-hot contractions instead of the
      four U/V/gc/gp scatter-adds.  A [P,D]-slot gather variant (one obs
      slot per (point, cam)) measured slower there.
    - The reduced camera system solves by pivot-free Gauss-Jordan
      (damped SPD) instead of ``jnp.linalg.solve``'s LU.

    Whether scatter-adds and LU win on the GPU is not measured yet
    (ROADMAP speed queue item 4).
    """
    O = r.shape[0]
    onehot_c = jax.nn.one_hot(p.obs_cam, n_cam, dtype=r.dtype)  # [O,C]
    onehot_p = jax.nn.one_hot(p.obs_pt, n_pt, dtype=r.dtype)    # [O,P]

    # Block accumulations (one-hot matmul reductions).
    U = einsum("oc,oij->cij", onehot_c,
                   einsum("oai,oaj->oij", Jc, Jc))          # [C,6,6]
    V = einsum("op,oij->pij", onehot_p,
                   einsum("oai,oaj->oij", Jp, Jp))          # [P,3,3]
    gc = -einsum("oc,oi->ci", onehot_c,
                     einsum("oai,oa->oi", Jc, r))           # [C,6]
    gp = -einsum("op,oi->pi", onehot_p,
                     einsum("oai,oa->oi", Jp, r))           # [P,3]

    # Damping (Marquardt diagonal scaling): A + lam * diag_embed(diag(A)).
    dU = jnp.maximum(jnp.diagonal(U, axis1=-2, axis2=-1), 1e-6)
    Ud = U + lam * dU[..., None] * jnp.eye(6, dtype=r.dtype)
    dV = jnp.maximum(jnp.diagonal(V, axis1=-2, axis2=-1), 1e-6)
    Vd = V + lam * dV[..., None] * jnp.eye(3, dtype=r.dtype)
    Vinv = inv3x3(Vd, eps=1e-9)

    W = einsum("oai,oaj->oij", Jc, Jp)                      # [O,6,3]
    Y = mm(W, Vinv[p.obs_pt])                                      # [O,6,3]

    # Dense cross term: B_y[c,p] = sum_{o: cam=c, pt=p} Y_o, etc.
    By = einsum("oc,op,oij->cpij", onehot_c, onehot_p, Y)
    Bw = einsum("oc,op,oij->cpij", onehot_c, onehot_p, W)
    S_cross = einsum("cpij,dpkj->cidk", By, Bw)             # [C,6,C,6]
    S = -S_cross
    S = S.at[jnp.arange(n_cam), :, jnp.arange(n_cam), :].add(Ud)

    rhs_cross = einsum("cpij,pj->ci", By, gp)
    b = gc - rhs_cross                                          # [C,6]

    if fix_first:
        # Gauge fix: clamp camera 0 by zeroing its rows/cols and setting
        # identity on its diagonal block.
        mask = jnp.ones((n_cam,), r.dtype).at[0].set(0.0)
        S = S * mask[:, None, None, None] * mask[None, None, :, None]
        S = S.at[0, :, 0, :].set(jnp.eye(6, dtype=r.dtype))
        b = b * mask[:, None]

    Sd = S.reshape(n_cam * 6, n_cam * 6)
    Sd = Sd + 1e-8 * jnp.eye(n_cam * 6)
    dc = linalg.solve_spd_gj(Sd, b.reshape(-1)).reshape(n_cam, 6)

    # Back-substitute points: dp = Vinv (gp - W^T dc) aggregated per point.
    Wt_dc = einsum("op,oj->pj", onehot_p,
                       einsum("oij,oi->oj", W, dc[p.obs_cam]))  # [P,3]
    dp = einsum("pij,pj->pi", Vinv, gp - Wt_dc)
    return dc, dp


@partial(jax.jit, static_argnames=("cfg", "fix_first_camera"))
def bundle_adjust(p: BAProblem, cfg: BundleAdjustConfig = BundleAdjustConfig(),
                  fix_first_camera: bool = True) -> BAResult:
    """Joint LM over all cameras and points."""
    n_cam = p.cameras.shape[0]
    n_pt = p.points.shape[0]
    c0 = cost_fn(p, p.cameras, p.points, cfg.huber_scale)

    def body(state):
        cams, pts, lam, cost, it, done = state
        r, Jc, Jp = _blocks(p, cams, pts, cfg.huber_scale)
        dc, dp = _solve_schur(p, r, Jc, Jp, lam, n_cam, n_pt,
                              fix_first_camera)
        cams_new = cams + dc
        pts_new = pts + dp
        cost_new = cost_fn(p, cams_new, pts_new, cfg.huber_scale)
        accept = cost_new < cost
        cams = jnp.where(accept, cams_new, cams)
        pts = jnp.where(accept, pts_new, pts)
        lam = jnp.where(accept, jnp.maximum(lam * cfg.damping_down, 1e-10),
                        jnp.minimum(lam * cfg.damping_up, 1e8))
        rel = jnp.abs(cost - cost_new) <= cfg.rtol * jnp.maximum(cost, 1e-30)
        done = done | (accept & rel) | (lam >= 1e8)
        cost = jnp.where(accept, cost_new, cost)
        return cams, pts, lam, cost, it + 1, done

    def cond(state):
        *_, it, done = state
        return (it < cfg.max_iters) & jnp.logical_not(done)

    init = (p.cameras, p.points, jnp.asarray(cfg.damping_init, p.cameras.dtype),
            c0, jnp.asarray(0), jnp.asarray(False))
    cams, pts, lam, cost, it, done = jax.lax.while_loop(cond, body, init)
    return BAResult(cameras=cams, points=pts, cost=cost, initial_cost=c0,
                    iterations=it)
