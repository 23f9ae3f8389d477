"""Counter-based PRNG helpers for hypothesis sampling.

The reference relies on OpenCV's hidden global RANSAC RNG; here every random
choice flows from an explicit ``jax.random`` key so runs are reproducible and
hypothesis batches can be sharded deterministically across devices (each
shard folds in its mesh position).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def key_for(seed: int, *folds: int) -> jax.Array:
    key = jax.random.key(seed)
    for f in folds:
        key = jax.random.fold_in(key, f)
    return key


def sample_without_replacement(
    key: jax.Array, num_samples: int, sample_size: int, num_points: int,
    point_mask: jax.Array | None = None,
) -> jnp.ndarray:
    """[S, k] index tensor of uniform k-subsets of the valid points.

    Branch-free, shape-static, vmappable — a JAX replacement for
    OpenCV's sequential rejection sampler.  Two paths:

    - no mask and small k: sort-free Fisher-Yates index adjustment — draw
      r_j uniform over a shrinking range and shift past already-chosen
      indices; pure elementwise compares, no top_k/sort over the hypothesis tensor.
    - masked points: top-k-of-uniforms (first k of a random permutation)
      with -inf priority on masked points (requires >= k valid points).
    """
    if point_mask is None and sample_size <= 8:
        return _fisher_yates_indices(key, num_samples, sample_size, num_points)
    u = jax.random.uniform(key, (num_samples, num_points))
    if point_mask is not None:
        u = jnp.where(point_mask[None, :] > 0, u, -jnp.inf)
    _, idx = jax.lax.top_k(u, sample_size)
    return idx


def _fisher_yates_indices(key, num_samples: int, k: int, n: int):
    draws = [
        jax.random.randint(kj, (num_samples,), 0, n - j)
        for j, kj in enumerate(jax.random.split(key, k))
    ]
    chosen: list[jnp.ndarray] = []
    for j, r in enumerate(draws):
        # Shift r past each previously chosen index, in ascending order of
        # those indices: equivalent to sampling from the complement.
        prev = chosen
        # Insertion-sort the (tiny) list of previous picks per row.
        sorted_prev: list[jnp.ndarray] = []
        for p in prev:
            inserted = p
            out = []
            for s in sorted_prev:
                lo = jnp.minimum(s, inserted)
                hi = jnp.maximum(s, inserted)
                out.append(lo)
                inserted = hi
            out.append(inserted)
            sorted_prev = out
        idx = r
        for s in sorted_prev:
            idx = idx + (idx >= s)
        chosen.append(idx)
    return jnp.stack(chosen, axis=1)
