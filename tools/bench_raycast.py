"""Benchmark of the batched DEM ray march on the GPU.

Times each march variant (plain chunked, coarse-to-fine mip with one and
two levels, and mip with active-ray compaction) on synthetic scenes: each
variant is compiled by a warm-up call, then every timed call ends in
``jax.block_until_ready`` and the median is reported.  The reference
marches ONE ray with a PROJ FFI call + scipy interpolation per 1-m step
(main_v1.py:635-658).

Run: python tools/bench_raycast.py [n_rays]
"""
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from ransac_tpu.pipelines import raycast
from ransac_tpu.io import dem as demio


def _scene(n_rays: int, kind: str, seed: int = 0):
    """Rugged synthetic DEM + rays from 300 m above the terrain.

    kind:
      hit    rays descend into terrain (hit after ~300-3000 steps) — the
             reference's typical query (boundary pixels -> ground)
      sky    rays point upward: never hit, march the full 10k-step budget
             unless skipped — the far-sky case the mip levels target
      graze  rays skim within the terrain's relief band for km — the
             adversarial case no skip structure can prune
      mixed  60% hit / 30% sky / 10% graze
    """
    from ransac_tpu.ops.geodesy import SceneFrame

    rng = np.random.default_rng(seed)
    frame = SceneFrame(anchor=np.array([739000.0, 2888000.0, 0.0]), zone=50)
    dem = demio.synthetic_dem(
        frame, extent_m=12000, spacing_m=30.0,
        terrain_fn=lambda X, Y: (40.0 * np.sin(X / 700.0)
                                 * np.cos(Y / 900.0)
                                 + 30.0 * np.sin((X + Y) / 400.0)))
    origins = np.repeat([[0.0, 0.0, 300.0]], n_rays, 0)
    d = rng.normal(size=(n_rays, 3))

    def set_dz(sl, lo, hi, sign):
        k = sl.stop - sl.start
        d[sl, 2] = sign * rng.uniform(lo, hi, k)

    if kind == "hit":
        set_dz(slice(0, n_rays), 0.1, 0.5, -1.0)
    elif kind == "sky":
        set_dz(slice(0, n_rays), 0.05, 0.3, +1.0)
    elif kind == "graze":
        set_dz(slice(0, n_rays), 0.002, 0.01, -1.0)
    else:  # mixed
        k1, k2 = int(0.6 * n_rays), int(0.9 * n_rays)
        set_dz(slice(0, k1), 0.1, 0.5, -1.0)
        set_dz(slice(k1, k2), 0.05, 0.3, +1.0)
        set_dz(slice(k2, n_rays), 0.002, 0.01, -1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (dem, jnp.asarray(origins, jnp.float32),
            jnp.asarray(d, jnp.float32))


def bench(n_rays: int = 4096, max_steps: int = 10000,
          kinds=("hit", "sky", "mixed"), reps: int = 10):
    from ransac_tpu.utils.device import require_gpu

    require_gpu()
    for kind in kinds:
        print(f"--- scene: {kind} ---", flush=True)
        dem, origins, dirs = _scene(n_rays, kind)
        arrs = dem.device_arrays()
        dem_pack = demio.pack_bilinear(arrs[0])
        spacing = 30.0
        pool = 8
        seg_steps = min(max(int(pool * spacing / 1.0), 1), 32)
        lookahead = 32
        pool2 = 1
        while pool2 * spacing < lookahead * seg_steps * 1.0:
            pool2 *= 2
        common = dict(max_steps=max_steps, step=1.0, min_hit_step=150,
                      dem_pack=dem_pack)
        mip = dict(pool=pool, seg_steps=seg_steps, lookahead=lookahead)
        for name, fn, kw in (
            ("march_plain_chunk64", raycast.march_rays, {}),
            ("march_mip_l1", raycast.march_rays_mip, dict(mip, pool2=0)),
            ("march_mip_l2", raycast.march_rays_mip,
             dict(mip, pool2=pool2, lookahead2=16)),
            ("march_mip_l2_compact", raycast.march_rays_mip_compact,
             dict(mip, pool2=pool2, lookahead2=16)),
        ):
            pos, hit = jax.block_until_ready(
                fn(origins, dirs, *arrs, **common, **kw))
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(
                    fn(origins, dirs, *arrs, **common, **kw))
                times.append(time.perf_counter() - t0)
            dt = statistics.median(times)
            print(f"{name:22s} {dt * 1e3:8.3f} ms  "
                  f"{n_rays / dt / 1e3:8.1f} k rays/s  "
                  f"hit={float(np.asarray(hit).mean()):.2f}", flush=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    bench(n)
