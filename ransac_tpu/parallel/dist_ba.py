"""Distributed bundle adjustment over device collectives.

The multi-chip form of ``ba.bundle`` (BASELINE.json configs[4], SURVEY.md
§2.5): observations shard over the mesh ``data`` axis; each shard
accumulates its local normal-equation blocks (U, V, W-cross contractions,
gradients) with one-hot matmul contractions; the *reduced camera system* — the only
globally-coupled piece — is combined with ``psum`` over the axis and solved
redundantly on every shard (it is tiny: [6C, 6C]).  Point updates stay
shard-local aside from the psum'd V/g_p blocks.  The program names no
transport: XLA lowers the psums to the backend's collectives (NCCL
between GPUs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ransac_tpu.ba.bundle import BAProblem, _blocks, cost_fn
from ransac_tpu.ops.linalg import inv3x3, solve_spd_gj
from ransac_tpu.ops.precision import einsum, mm


def _local_blocks(pb: BAProblem, cams, pts, huber, n_cam, n_pt):
    # One-hot matmul reductions, not segment_sum (see
    # ba.bundle._solve_schur).
    r, Jc, Jp = _blocks(pb, cams, pts, huber)
    onehot_c = jax.nn.one_hot(pb.obs_cam, n_cam, dtype=r.dtype)
    onehot_p = jax.nn.one_hot(pb.obs_pt, n_pt, dtype=r.dtype)
    U = einsum("oc,oij->cij", onehot_c,
                   einsum("oai,oaj->oij", Jc, Jc))
    V = einsum("op,oij->pij", onehot_p,
                   einsum("oai,oaj->oij", Jp, Jp))
    gc = -einsum("oc,oi->ci", onehot_c,
                     einsum("oai,oa->oi", Jc, r))
    gp = -einsum("op,oi->pi", onehot_p,
                     einsum("oai,oa->oi", Jp, r))
    W = einsum("oai,oaj->oij", Jc, Jp)
    return r, W, U, V, gc, gp, onehot_c, onehot_p


@partial(jax.jit, static_argnames=("mesh", "n_iters", "huber_scale",
                                   "fix_first_camera"))
def distributed_bundle_adjust(
    p: BAProblem, mesh: Mesh, n_iters: int = 10,
    damping: float = 1e-3, huber_scale: float = 0.0,
    fix_first_camera: bool = True,
):
    """LM-BA with observations sharded over the 'data' axis.

    The observation count must divide the data-axis size (pad with
    zero-weight observations).  Returns (cameras, points, cost).
    """
    n_cam = p.cameras.shape[0]
    n_pt = p.points.shape[0]

    def shard_fn(cameras, points, obs_cam, obs_pt, obs_uv, obs_w):
        def one_iter(state, _):
            cams, pts, lam, cost = state
            pb = BAProblem(cams, pts, p.K, obs_cam, obs_pt, obs_uv, obs_w)
            r, W, U, V, gc, gp, onehot_c, onehot_p = _local_blocks(
                pb, cams, pts, huber_scale, n_cam, n_pt)

            # Global block reduction over observation shards (psum).
            U = jax.lax.psum(U, "data")
            V = jax.lax.psum(V, "data")
            gc = jax.lax.psum(gc, "data")
            gp = jax.lax.psum(gp, "data")

            dU = jnp.maximum(jnp.diagonal(U, axis1=-2, axis2=-1), 1e-6)
            Ud = U + lam * dU[..., None] * jnp.eye(6, dtype=r.dtype)
            dV = jnp.maximum(jnp.diagonal(V, axis1=-2, axis2=-1), 1e-6)
            Vd = V + lam * dV[..., None] * jnp.eye(3, dtype=r.dtype)
            Vinv = inv3x3(Vd, eps=1e-9)

            Y = mm(W, Vinv[obs_pt])
            By = einsum("oc,op,oij->cpij", onehot_c, onehot_p, Y)
            Bw = einsum("oc,op,oij->cpij", onehot_c, onehot_p, W)
            # Shard-local cross blocks; psum completes the global sums.
            By = jax.lax.psum(By, "data")
            Bw = jax.lax.psum(Bw, "data")
            S = -einsum("cpij,dpkj->cidk", By, Bw)
            S = S.at[jnp.arange(n_cam), :, jnp.arange(n_cam), :].add(Ud)
            b = gc - einsum("cpij,pj->ci", By, gp)

            if fix_first_camera:
                m0 = jnp.ones((n_cam,), r.dtype).at[0].set(0.0)
                S = S * m0[:, None, None, None] * m0[None, None, :, None]
                S = S.at[0, :, 0, :].set(jnp.eye(6, dtype=r.dtype))
                b = b * m0[:, None]

            Sd = S.reshape(n_cam * 6, n_cam * 6) + 1e-8 * jnp.eye(n_cam * 6)
            # Pivot-free Gauss-Jordan (damped SPD), as ba.bundle.
            dc = solve_spd_gj(Sd, b.reshape(-1)).reshape(n_cam, 6)

            Wt_dc = einsum(
                "op,oj->pj", onehot_p,
                einsum("oij,oi->oj", W, dc[obs_cam]))
            Wt_dc = jax.lax.psum(Wt_dc, "data")
            dp = einsum("pij,pj->pi", Vinv, gp - Wt_dc)

            cams_new = cams + dc
            pts_new = pts + dp
            pb_new = BAProblem(cams_new, pts_new, p.K, obs_cam, obs_pt,
                               obs_uv, obs_w)
            cost_new = jax.lax.psum(
                cost_fn(pb_new, cams_new, pts_new, huber_scale), "data")
            accept = cost_new < cost
            cams = jnp.where(accept, cams_new, cams)
            pts = jnp.where(accept, pts_new, pts)
            lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-10),
                            jnp.minimum(lam * 5.0, 1e8))
            cost = jnp.where(accept, cost_new, cost)
            return (cams, pts, lam, cost), cost

        pb0 = BAProblem(cameras, points, p.K, obs_cam, obs_pt, obs_uv, obs_w)
        c0 = jax.lax.psum(cost_fn(pb0, cameras, points, huber_scale), "data")
        (cams, pts, lam, cost), _ = jax.lax.scan(
            one_iter, (cameras, points,
                       jnp.asarray(damping, cameras.dtype), c0),
            None, length=n_iters)
        return cams, pts, cost

    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data"), P("data"), P("data")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(p.cameras, p.points, p.obs_cam, p.obs_pt, p.obs_uv, p.obs_w)


# ---------------------------------------------------------------------------
# Matrix-free CG Schur variant (SLAM/SfM scale)
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("mesh", "n_iters", "cg_iters",
                                   "huber_scale", "fix_first_camera"))
def distributed_bundle_adjust_cg(
    sp, mesh: Mesh, n_iters: int = 10, cg_iters: int = 24,
    damping: float = 1e-3, huber_scale: float = 0.0,
    fix_first_camera: bool = True,
):
    """Distributed ``ba.schur_cg.bundle_adjust_cg``: the POINT axis (rows
    of the [P, D] slot layout) shards over mesh ``data``; cameras and the
    reduced camera system are replicated.  The ONLY cross-shard traffic
    is the psum of camera-side reductions (U, g_c, rhs and the per-CG-
    iteration s_c) — tiny [C, 6]/[C, 36] tensors — which is
    exactly the ``cam_psum`` hook of ``_schur_cg_step``.  Replaces the
    dense-cross-tensor ``distributed_bundle_adjust`` at scales where
    [C, P, 6, 3] cannot exist (VERDICT r1 item 4).

    ``sp``: BASlotProblem whose P divides the data-axis size (pad with
    zero-weight points).  Returns (cameras, points, cost).
    """
    from ransac_tpu.ba.schur_cg import (BASlotProblem, _schur_cg_step,
                                        _slot_blocks, slot_cost)

    n_cam = sp.cameras.shape[0]

    def shard_fn(cameras, points, slot_cam, slot_uv, slot_w):
        psum = lambda x: jax.lax.psum(x, "data")

        def local(cams, pts):
            return BASlotProblem(cams, pts, sp.K, slot_cam, slot_uv,
                                 slot_w)

        def one_iter(state, _):
            cams, pts, lam, cost = state
            pb = local(cams, pts)
            r, Jc, Jp = _slot_blocks(pb, cams, pts, huber_scale)
            dc, dp = _schur_cg_step(pb, r, Jc, Jp, lam, n_cam,
                                    fix_first_camera, cg_iters,
                                    cam_psum=psum)
            cams_new = cams + dc
            pts_new = pts + dp
            cost_new = psum(slot_cost(local(cams_new, pts_new), cams_new,
                                      pts_new, huber_scale))
            accept = cost_new < cost
            cams = jnp.where(accept, cams_new, cams)
            pts = jnp.where(accept, pts_new, pts)
            lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-10),
                            jnp.minimum(lam * 5.0, 1e8))
            cost = jnp.where(accept, cost_new, cost)
            return (cams, pts, lam, cost), cost

        c0 = psum(slot_cost(local(cameras, points), cameras, points,
                            huber_scale))
        (cams, pts, lam, cost), _ = jax.lax.scan(
            one_iter,
            (cameras, points, jnp.asarray(damping, cameras.dtype), c0),
            None, length=n_iters)
        return cams, pts, cost

    # Slots-last layout (round 3, ba.schur_cg): the point axis is the
    # MINOR axis of the slot arrays, so the data shards split axis -1.
    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P("data"), P(None, "data"),
                  P(None, None, "data"), P(None, "data")),
        out_specs=(P(), P("data"), P()),
        check_vma=False,
    )(sp.cameras, sp.points, sp.slot_cam, sp.slot_uv, sp.slot_w)
