#!/usr/bin/env python
"""Headline benchmark: plain-XLA RANSAC hypotheses/s on one GPU.

Times ``models.ransac.ransac_homography`` (sample -> minimal DLT solve ->
score -> select -> refit, all one jitted program) at 2^22 random
hypotheses over the reference's 13-correspondence problem with its 75 px
threshold (``/root/reference/main_v1.py:312``), and the plain
``pipelines.localize.score_candidates`` search over 458 candidates x all
C(13,4) = 715 hypotheses.  These are the numbers a fused GPU sweep would
have to beat end to end.

One process, one device, no subprocess: each shape is compiled by a
warm-up call, then every timed call ends in ``block_until_ready``.
Exits non-zero, printing no result, on a backend other than ``gpu``.

Prints the device and the card's name and power limit first, and ONE JSON
line last.  Run: ``python bench.py``.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

N_HYP = 1 << 22
REPS = 10


def problem(n_points=13, seed=0):
    """13 correspondences of a planted homography, the last 3 outliers."""
    import jax.numpy as jnp

    from ransac_tpu.ops import homography as hops

    rng = np.random.default_rng(seed)
    H_true = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0],
                       [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, size=(n_points, 2)).astype(np.float32)
    dst = np.asarray(hops.apply_h(jnp.asarray(H_true), jnp.asarray(src)))
    dst = (dst + rng.normal(scale=1.0, size=dst.shape)).astype(np.float32)
    dst[10:] += 300.0
    return jnp.asarray(src), jnp.asarray(dst), jnp.ones(n_points, jnp.float32)


def time_calls(fn, args_for, reps):
    """Warm-up call (compile) then ``reps`` timed calls, each ended by
    ``block_until_ready``.  Returns (compile+first-call s, [s per call],
    last output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args_for(0)))
    cold = time.perf_counter() - t0
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args_for(i + 1)))
        times.append(time.perf_counter() - t0)
    return cold, times, out


def bench_ransac_h(n_hyp=N_HYP, reps=REPS):
    """Plain engine at ``n_hyp`` random hypotheses x 13 points, 75 px."""
    import jax

    from ransac_tpu.models.ransac import ransac_homography
    from ransac_tpu.utils.config import RansacConfig

    src, dst, mask = problem()
    cfg = RansacConfig(threshold=75.0, num_hypotheses=n_hyp,
                       exhaustive=False)
    cold, times, res = time_calls(
        lambda key: ransac_homography(src, dst, mask, cfg, key),
        lambda i: (jax.random.key(i),), reps)
    n_inl = int(res.num_inliers)
    if n_inl < 10:
        raise AssertionError(f"planted consensus not found: {n_inl} inliers")
    return {"n_hyp": n_hyp, "n_points": 13, "cold_s": cold,
            "median_s": statistics.median(times), "min_s": min(times),
            "max_s": max(times), "reps": reps, "num_inliers": n_inl}


def bench_score_candidates(reps=REPS):
    """Plain ``score_candidates`` over 458 synthetic candidates."""
    import jax

    from __graft_entry__ import _synth_inputs
    from ransac_tpu.pipelines.localize import score_candidates
    from ransac_tpu.utils.config import LocalizeConfig, RansacConfig

    args = _synth_inputs(c=458)
    cfg = LocalizeConfig(ransac=RansacConfig(threshold=75.0))
    cold, times, out = time_calls(
        lambda key: score_candidates(*args, cfg, key),
        lambda i: (jax.random.key(i),), reps)
    best = int(out["best"])
    if best != 3:
        raise AssertionError(f"planted candidate 3 not found: best={best}")
    return {"candidates": 458, "hypotheses_per_candidate": 715,
            "cold_s": cold, "median_s": statistics.median(times),
            "min_s": min(times), "max_s": max(times), "reps": reps}


def main():
    from ransac_tpu.utils.device import (device_record,
                                         enable_compile_cache,
                                         gpu_name_and_power_limit,
                                         require_gpu)

    devices = require_gpu()
    enable_compile_cache()
    device = device_record(devices)
    print(f"device: {device}")
    print(f"nvidia-smi: {gpu_name_and_power_limit()}")

    h = bench_ransac_h()
    print(f"ransac_homography {h['n_hyp']} hyp x 13 pts: median "
          f"{h['median_s'] * 1e3:.3f} ms (min {h['min_s'] * 1e3:.3f}, "
          f"max {h['max_s'] * 1e3:.3f}, n={h['reps']}), compile+first "
          f"{h['cold_s']:.1f} s")
    sc = bench_score_candidates()
    print(f"score_candidates 458 x 715: median "
          f"{sc['median_s'] * 1e3:.3f} ms (min {sc['min_s'] * 1e3:.3f}, "
          f"max {sc['max_s'] * 1e3:.3f}, n={sc['reps']}), compile+first "
          f"{sc['cold_s']:.1f} s")
    print(json.dumps({
        "metric": "ransac_homography_hypotheses_per_s",
        "value": h["n_hyp"] / h["median_s"], "unit": "hypotheses/s",
        "device": device, "ransac_homography": h,
        "score_candidates": sc}))


if __name__ == "__main__":
    main()
