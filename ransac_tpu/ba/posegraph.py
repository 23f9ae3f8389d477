"""SE(3) pose-graph optimization (BASELINE.json "pose-graph optimization").

Gauss-Newton over relative-pose constraints: node poses T_i = (R_i, t_i)
world->camera as [V,6] (rvec, tvec); an edge (i, j) with measured relative
transform Z_ij contributes the residual

    r_ij = log_SE3( Z_ij^-1 * T_j * T_i^-1 )        (6-vector)

Uses the shared LM core with the gauge fixed by pinning node 0 (its update
columns are masked).  Dense normal equations are fine at keyframe-graph
scale; observation sharding + psum is the distributed form (SURVEY.md
§2.5 "keyframe-window partitioning").
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ransac_tpu.ops.precision import einsum, mm
from ransac_tpu.ops.rotation import exp_so3, log_so3


class PoseGraph(NamedTuple):
    poses: jnp.ndarray      # [V,6] (rvec, tvec), world->camera
    edge_i: jnp.ndarray     # [E]
    edge_j: jnp.ndarray     # [E]
    edge_z: jnp.ndarray     # [E,6] measured relative pose j<-i (rvec, tvec)
    edge_w: jnp.ndarray     # [E] weights


def compose(a6: jnp.ndarray, b6: jnp.ndarray) -> jnp.ndarray:
    """SE(3) composition c = a * b in (rvec, tvec) form: R_c = R_a R_b,
    t_c = R_a t_b + t_a."""
    Ra = exp_so3(a6[..., :3])
    Rb = exp_so3(b6[..., :3])
    Rc = mm(Ra, Rb)
    tc = einsum("...ij,...j->...i", Ra, b6[..., 3:6]) + a6[..., 3:6]
    return jnp.concatenate([log_so3(Rc), tc], axis=-1)


def invert(a6: jnp.ndarray) -> jnp.ndarray:
    Ra = exp_so3(a6[..., :3])
    Rinv = jnp.swapaxes(Ra, -1, -2)
    tinv = -einsum("...ij,...j->...i", Rinv, a6[..., 3:6])
    return jnp.concatenate([log_so3(Rinv), tinv], axis=-1)


def relative(a6: jnp.ndarray, b6: jnp.ndarray) -> jnp.ndarray:
    """T_b * T_a^-1 — the relative transform taking frame a to frame b."""
    return compose(b6, invert(a6))


def edge_residuals(g: PoseGraph, poses: jnp.ndarray) -> jnp.ndarray:
    pi = poses[g.edge_i]
    pj = poses[g.edge_j]
    pred = relative(pi, pj)
    err = compose(invert(g.edge_z), pred)
    return err * g.edge_w[:, None]


# ------------------------------------------------------------------ Sim(3)
class PoseGraphSim3(NamedTuple):
    """Sim(3) pose graph: nodes carry (rvec, tvec, log_s) [V,7]; an edge
    measures the relative SIMILARITY j <- i — including the RELATIVE
    SCALE, the quantity monocular SLAM drifts in (measured on the
    closed-circuit demo: ~10x accumulated step-scale drift that an SE(3)
    graph cannot express, let alone repair).  ORB-SLAM-style loop
    closing: optimize over Sim(3), then flatten each node back to SE(3)
    as (R, t / s)."""
    poses: jnp.ndarray      # [V,7] (rvec, tvec, log_s), world->camera
    edge_i: jnp.ndarray     # [E]
    edge_j: jnp.ndarray     # [E]
    edge_z: jnp.ndarray     # [E,7] measured relative similarity j<-i
    edge_w: jnp.ndarray     # [E]
    # Scale-residual weight per edge.  Monocular odometry does NOT
    # observe the relative scale between consecutive frames (that IS
    # the unobservable that drifts), so odometry edges must carry
    # edge_sw = 0 — constraining their scale row to 1 pins the whole
    # scale chain and the loop closures can no longer absorb the drift
    # (measured: oscillating node scales and a 10% ATE fix instead of
    # the full repair).  Loop closures measured with map anchors carry
    # edge_sw = 1.
    edge_sw: jnp.ndarray    # [E]


def compose_sim3(a7: jnp.ndarray, b7: jnp.ndarray) -> jnp.ndarray:
    """Similarity composition c = a * b: x -> s_a R_a (s_b R_b x + t_b)
    + t_a, i.e. R_c = R_a R_b, s_c = s_a s_b, t_c = s_a R_a t_b + t_a."""
    Ra = exp_so3(a7[..., :3])
    Rb = exp_so3(b7[..., :3])
    sa = jnp.exp(a7[..., 6:7])
    Rc = mm(Ra, Rb)
    tc = sa * einsum("...ij,...j->...i", Ra, b7[..., 3:6]) \
        + a7[..., 3:6]
    return jnp.concatenate(
        [log_so3(Rc), tc, a7[..., 6:7] + b7[..., 6:7]], axis=-1)


def invert_sim3(a7: jnp.ndarray) -> jnp.ndarray:
    Ra = exp_so3(a7[..., :3])
    Rinv = jnp.swapaxes(Ra, -1, -2)
    sinv = jnp.exp(-a7[..., 6:7])
    tinv = -sinv * einsum("...ij,...j->...i", Rinv, a7[..., 3:6])
    return jnp.concatenate([log_so3(Rinv), tinv, -a7[..., 6:7]], axis=-1)


def relative_sim3(a7: jnp.ndarray, b7: jnp.ndarray) -> jnp.ndarray:
    """S_b * S_a^-1 — the relative similarity taking frame a to b."""
    return compose_sim3(b7, invert_sim3(a7))


def edge_residuals_sim3(g: PoseGraphSim3, poses: jnp.ndarray
                        ) -> jnp.ndarray:
    pi = poses[g.edge_i]
    pj = poses[g.edge_j]
    err = compose_sim3(invert_sim3(g.edge_z), relative_sim3(pi, pj))
    err = err.at[:, 6].multiply(g.edge_sw)
    # Per-edge translation normalization: measured translation
    # magnitudes vary by orders of magnitude across a scale-drifted
    # monocular chain, and unnormalized absolute-translation residuals
    # let the inflated-scale region dominate the least squares.  This
    # approximates a relative-error information matrix; rotation and
    # log-scale residuals are already dimensionless.  The normalizer is
    # floored at HALF THE GRAPH'S MEDIAN |z_t|: a loop closure's
    # measured baseline is tiny by nature (a revisit), and dividing by
    # it weighted the closure's translation rows ~400x over everything
    # else — the round-5 circuit demo's optimizer sacrificed an
    # 0.1-degree-accurate closure rotation by 85 degrees AND drove node
    # scales to 0.003 to appease those rows.
    t_norm = jnp.linalg.norm(g.edge_z[:, 3:6], axis=-1)
    t_scale = jnp.maximum(t_norm,
                          jnp.maximum(0.5 * jnp.median(t_norm), 1e-2))
    err = err.at[:, 3:6].divide(t_scale[:, None])
    return err * g.edge_w[:, None]


@partial(jax.jit, static_argnames=("max_iters",))
def optimize_pose_graph_sim3(g: PoseGraphSim3, max_iters: int = 40,
                             damping_init: float = 1e-4,
                             scale_smooth: float = 1.0):
    """LM over Sim(3) node poses with node 0 pinned (the similarity
    gauge: rotation + translation + global scale).  Returns (poses [V,7],
    cost, iterations).

    ``scale_smooth``: soft floor on the scale-row weight of edges with
    ``edge_sw = 0`` — a SMOOTHNESS prior saying per-step monocular scale
    drift is small (odometry z carries log-rel-scale 0).  Without it the
    scale field between loop closures is constrained only through its
    coupling into translation residuals, and the optimizer absorbs
    translation noise into phantom scale bows (measured on the circuit
    demo: closures all at rel scale ~1.0 yet node scales spread
    0.25..1.85, making the corrected trajectory WORSE).  A smoothness
    prior — unlike an absolute log_s -> 0 prior — still admits large
    ACCUMULATED drift: the compounding 1.03^k unit test pays only
    (ln 1.03)^2 per step and is repaired identically.  Weight 1.0
    (round 5): at 0.3 a single noisy closure could still drive node
    scales to 0.03-0.06 (measured on the circuit demo) — physically
    absurd against a ~2.7x measured total drift."""
    V = g.poses.shape[0]
    g = g._replace(edge_sw=jnp.maximum(g.edge_sw, scale_smooth))

    def flat_residual(x):
        poses = x.reshape(V, 7)
        poses = poses.at[0].set(g.poses[0])
        return edge_residuals_sim3(g, poses).reshape(-1)

    from ransac_tpu.ops.lm import levenberg_marquardt

    res = levenberg_marquardt(
        flat_residual, g.poses.reshape(-1), max_iters=max_iters,
        damping_init=damping_init)
    poses = res.x.reshape(V, 7).at[0].set(g.poses[0])
    return poses, res.cost, res.iterations


def sim3_to_se3(poses7: jnp.ndarray) -> jnp.ndarray:
    """Flatten optimized Sim(3) nodes to SE(3) camera poses: the node's
    scale is the local map-scale error, so the corrected pose is
    (R, t / s) (ORB-SLAM loop-closing convention)."""
    s = jnp.exp(poses7[..., 6:7])
    return jnp.concatenate([poses7[..., :3], poses7[..., 3:6] / s],
                           axis=-1)


@partial(jax.jit, static_argnames=("max_iters",))
def optimize_pose_graph(g: PoseGraph, max_iters: int = 30,
                        damping_init: float = 1e-4):
    """LM over all node poses with node 0 pinned.  Returns (poses, cost,
    iterations)."""
    V = g.poses.shape[0]

    def flat_residual(x):
        poses = x.reshape(V, 6)
        # Pin node 0 to its initial value.
        poses = poses.at[0].set(g.poses[0])
        return edge_residuals(g, poses).reshape(-1)

    from ransac_tpu.ops.lm import levenberg_marquardt

    res = levenberg_marquardt(
        flat_residual, g.poses.reshape(-1), max_iters=max_iters,
        damping_init=damping_init)
    poses = res.x.reshape(V, 6).at[0].set(g.poses[0])
    return poses, res.cost, res.iterations
