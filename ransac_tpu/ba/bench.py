"""SLAM-scale bundle-adjustment benchmark.

Builds a synthetic 512-camera / 200k-point / ~2M-observation problem ON
DEVICE (no host loops) in the slot layout and times LM iterations of the
matrix-free CG Schur path (``ba.schur_cg``) — a shape where the dense
Schur path's [C, P, 6, 3] cross tensors would need ~7 TB.

Timing: fixed-trip LM (rtol=0) runs entirely inside one jit; both trip
counts are compiled by a warm-up call, every timed call ends in
``jax.block_until_ready``, and seconds/LM-iteration is the median over
three repeats of the difference between a 2-iteration and a 6-iteration
run (which cancels the fixed per-call cost).

Run: ``python -m ransac_tpu.ba.bench [n_cam n_pt slots]``
"""

from __future__ import annotations

import functools
import sys
import time

import jax
import jax.numpy as jnp

from ransac_tpu.ba.schur_cg import BASlotProblem, bundle_adjust_cg
from ransac_tpu.utils.config import BundleAdjustConfig


def synth_slot_problem(n_cam: int = 512, n_pt: int = 200_000,
                       slots: int = 10, seed: int = 0,
                       noise_pt: float = 0.02, noise_cam: float = 0.003):
    """Device-side synthetic SfM scene in slot layout.

    Cameras sit on a ring looking at a point cloud; each point is
    observed by ``slots`` consecutive cameras starting at a hash of its
    id (tracks are short and camera-local like real SfM).  Ground-truth
    projections are perturbed into the initial estimate, so LM has real
    work to do.
    """
    from ransac_tpu.ops import projection as proj
    from ransac_tpu.ops.rotation import exp_so3

    key = jax.random.key(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    K = jnp.array([[700.0, 0, 320.0], [0, 700.0, 240.0], [0, 0, 1.0]],
                  jnp.float32)
    pts = jax.random.uniform(k1, (n_pt, 3), jnp.float32, -1.0, 1.0) \
        * jnp.array([6.0, 6.0, 2.0]) + jnp.array([0.0, 0.0, 10.0])
    # Cameras along a line with mild random rotations.
    rvecs = jax.random.normal(k2, (n_cam, 3), jnp.float32) * 0.03
    tx = jnp.linspace(-2.0, 2.0, n_cam, dtype=jnp.float32)
    tvecs = jnp.stack([tx, jnp.zeros_like(tx), jnp.zeros_like(tx)], -1)
    cams = jnp.concatenate([rvecs, tvecs], -1)            # [C,6]

    # slot_cam[d, p] = (base_p + d) % C with base from a cheap hash
    # (slots-last layout — see ba.schur_cg; building per-d [P]-vectors
    # keeps every intermediate compact, no [P, D, k] minor-dim padding).
    base = (jax.random.randint(k3, (n_pt,), 0, n_cam)).astype(jnp.int32)
    d_off = jnp.arange(slots, dtype=jnp.int32)[:, None]
    slot_cam = (base[None, :] + d_off) % n_cam            # [D,P]

    def project_d(ids_d):
        cam_d = cams[ids_d]                               # [P,6]

        def one(cam6, X):
            R = exp_so3(cam6[:3])
            pix, z = proj.project_points(X[None, :], R, cam6[3:6], K)
            return pix[0], z[0]

        pix, z = jax.vmap(one, (0, 0), out_axes=-1)(cam_d, pts)
        return pix, z                                     # [2,P], [P]

    pix, z = jax.vmap(project_d)(slot_cam)                # [D,2,P], [D,P]
    slot_uv = jnp.moveaxis(pix, 1, 0)                     # [2,D,P]
    slot_w = (z > 0.1).astype(jnp.float32)                # [D,P]
    # Initial estimates: perturbed geometry, exact observations.
    pts0 = pts + jax.random.normal(k4, pts.shape, jnp.float32) * noise_pt
    cams0 = cams.at[1:].add(
        jax.random.normal(jax.random.key(seed + 1), (n_cam - 1, 6),
                          jnp.float32) * noise_cam)
    return BASlotProblem(cameras=cams0, points=pts0, K=K,
                         slot_cam=slot_cam, slot_uv=slot_uv,
                         slot_w=slot_w)


def bench_ba_scale(n_cam: int = 512, n_pt: int = 200_000,
                   slots: int = 10, cg_iters: int = 16):
    """Returns dict with seconds/LM-iteration and the problem shape."""
    sp = synth_slot_problem(n_cam, n_pt, slots)
    n_obs = float(jnp.sum(sp.slot_w))

    def run(n_iters):
        # rtol=0: no early convergence exit -> fixed trip count.
        cfg = BundleAdjustConfig(max_iters=n_iters, rtol=0.0)
        return jax.block_until_ready(
            bundle_adjust_cg(sp, cfg, cg_iters=cg_iters))

    small, large = 2, 6
    print(f"# compiling/running {small}-iter variant...", flush=True)
    run(small)
    print(f"# compiling/running {large}-iter variant...", flush=True)
    run(large)
    print("# compiled; timing", flush=True)
    deltas = []
    costs = None
    for _ in range(3):
        t0 = time.perf_counter()
        run(small)
        t_small = time.perf_counter() - t0
        t0 = time.perf_counter()
        r2 = run(large)
        t_large = time.perf_counter() - t0
        d = (t_large - t_small) / (large - small)
        if d > 0:
            deltas.append(d)
        costs = (float(r2.initial_cost), float(r2.cost))
    deltas.sort()
    sec_per_iter = deltas[len(deltas) // 2]
    return {
        "n_cam": n_cam, "n_pt": n_pt, "n_obs": int(n_obs),
        "cg_iters": cg_iters,
        "sec_per_lm_iter": sec_per_iter,
        "lm_iters_per_s": 1.0 / sec_per_iter,
        "cost_initial": costs[0], "cost_final": costs[1],
    }


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    n_cam = args[0] if len(args) > 0 else 512
    n_pt = args[1] if len(args) > 1 else 200_000
    slots = args[2] if len(args) > 2 else 10
    out = bench_ba_scale(n_cam, n_pt, slots)
    import json

    print(json.dumps(out))
