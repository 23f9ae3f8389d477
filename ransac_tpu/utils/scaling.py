"""Scaling-efficiency measurement harness (BASELINE.md deliverable:
"frames/s at 1 chip, 1 host, N>=2 hosts; >=80% scaling efficiency").

Measures the distributed candidate-search throughput (candidate-frames/s)
across growing mesh sizes on whatever devices are attached.  On real
cards the collectives cross the interconnect and the numbers are true
scaling;
on a single host with virtual devices the harness still validates the
sharded program end-to-end (the numbers then measure overhead, not
speedup — flagged in the report).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ransac_tpu.parallel.mesh import make_mesh
from ransac_tpu.parallel.sharded_search import distributed_score_candidates
from ransac_tpu.utils.config import LocalizeConfig, RansacConfig


@dataclass
class ScalePoint:
    n_devices: int
    mesh_shape: dict
    candidates_per_s: float
    efficiency: float  # vs linear scaling from the 1-device point


def _synth(seed, n_pts, n_cand):
    rng = np.random.default_rng(seed)
    cam = np.array([-500.0, 0.0, 50.0])
    X = rng.uniform(-100, 100, size=(n_pts, 3)) + np.array([0, 0, 80.0])
    pix = rng.uniform(0, 2000, size=(n_pts, 2))
    cam_locs = cam + rng.normal(scale=120.0, size=(n_cand, 3))
    grids = np.ones(n_cand, np.int32)
    return (jnp.asarray(pix, jnp.float32), jnp.asarray(X, jnp.float32),
            jnp.ones(n_pts, jnp.float32), jnp.asarray(cam_locs, jnp.float32),
            jnp.asarray(grids))


def measure_scaling(
    device_counts=None, n_candidates: int = 64, n_points: int = 13,
    hypotheses: int = 4096, iters: int = 5, seed: int = 0,
) -> list[ScalePoint]:
    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]
    pix, X, mask, cam_locs, grids = _synth(seed, n_points, n_candidates)
    cfg = LocalizeConfig(ransac=RansacConfig(
        threshold=5.0, num_hypotheses=hypotheses, exhaustive=False))

    points: list[ScalePoint] = []
    base = None
    for nd in device_counts:
        mesh = make_mesh(nd)
        out = distributed_score_candidates(
            pix, X, mask, cam_locs, grids, cfg, jax.random.key(0), mesh)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for i in range(iters):
            out = distributed_score_candidates(
                pix, X, mask, cam_locs, grids, cfg, jax.random.key(i), mesh)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        cps = n_candidates / dt
        if base is None:
            base = cps
        eff = cps / (base * nd)
        points.append(ScalePoint(
            n_devices=nd, mesh_shape=dict(mesh.shape),
            candidates_per_s=cps, efficiency=eff))
    return points


def measure_frontend_scaling(
    device_counts=None, frames_per_device: int = 2, img_hw: int = 128,
    max_kp: int = 256, iters: int = 3, seed: int = 0,
) -> list[ScalePoint]:
    """Frames/s of the keyframe-sharded front end (detect + describe +
    consecutive-pair match over the mesh ``data`` axis) across mesh sizes
    — the BASELINE.md "frames/s at N hosts" metric's substrate
    (SURVEY.md §2.5 row 4).  Weak scaling: the frame count grows with the
    data axis, so perfect scaling is flat time / linear frames/s."""
    from ransac_tpu.parallel.sharded_frontend import distributed_frontend
    from ransac_tpu.utils.config import TwoViewConfig

    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]
    cfg = TwoViewConfig(max_keypoints=max_kp)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((img_hw + 64, img_hw + 64)).astype(np.float32)

    points: list[ScalePoint] = []
    base_fps = None
    for nd in device_counts:
        mesh = make_mesh(nd, data=nd, model=1)
        n_frames = frames_per_device * mesh.shape["data"]
        imgs = jnp.asarray(np.stack(
            [base[f:f + img_hw, f:f + img_hw] for f in range(n_frames)]))
        out = distributed_frontend(imgs, mesh, cfg)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = distributed_frontend(imgs, mesh, cfg)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        fps = n_frames / dt
        if base_fps is None:
            base_fps = fps
        points.append(ScalePoint(
            n_devices=nd, mesh_shape=dict(mesh.shape),
            candidates_per_s=fps,
            # Normalize by the FIRST measured count so an explicit
            # device_counts like [2, 4, 8] reports 100% at its base point.
            efficiency=fps * device_counts[0] / (base_fps * nd)))
    return points


def report(points: list[ScalePoint], virtual: bool | None = None,
           unit: str = "cand/s") -> str:
    if virtual is None:
        virtual = jax.devices()[0].platform == "cpu"
    lines = []
    if virtual:
        lines.append("# NOTE: virtual single-host devices — validates the "
                     "sharded program, not real speedup")
    lines.append(f"{'devices':>8} {'mesh':>14} {unit:>12} {'eff':>6}")
    for p in points:
        lines.append(f"{p.n_devices:8d} {str(p.mesh_shape):>14} "
                     f"{p.candidates_per_s:12.1f} {100*p.efficiency:5.1f}%")
    return "\n".join(lines)
