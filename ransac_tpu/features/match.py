"""Patch descriptors + mutual-nearest-neighbor matching.

Descriptor distance matrices are one big matmul (SURVEY.md §2.5 "batched
feature detect/match").  Fixed shapes
throughout: K x K score matrix, mutual-NN + ratio test as masks.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ransac_tpu.ops.precision import einsum



class Matches(NamedTuple):
    idx1: jnp.ndarray    # [M] indices into keypoints 1
    idx2: jnp.ndarray    # [M] indices into keypoints 2
    valid: jnp.ndarray   # [M] bool


@partial(jax.jit, static_argnames=("patch",))
def patch_descriptors(img: jnp.ndarray, xy: jnp.ndarray,
                      valid: jnp.ndarray, patch: int = 8) -> jnp.ndarray:
    """Normalized intensity patches as descriptors: [K, patch*patch],
    zero-mean / unit-norm (illumination invariant).  Bilinear sampling at
    subpixel keypoint locations.

    Each keypoint fetches ONE (patch+1)x(patch+1) window with
    ``dynamic_slice`` (one strided gather) and interpolates all patch^2
    samples from it — the patch offsets are integers, so every sample
    shares the keypoint's fractional weights, instead of 4 scalar
    gathers per sample (4*patch^2 per keypoint).  Windows clamp to the
    image interior (keypoints closer than patch/2+1 to the border sample
    a shifted window; Harris detection already excludes a wider margin).
    """
    H, W = img.shape
    r = patch // 2
    p1 = patch + 1

    # One (p1 x p1) window per keypoint: whole image ROWS by index + a
    # batched one-hot matmul to select the p1 columns.  The layout was
    # chosen where row gathers were cheap and scalar gathers serial;
    # per-sample scalar gathers and a vmapped dynamic_slice both
    # measured far slower there.  Windows clamp to the image interior
    # (border keypoints sample a shifted window; Harris detection
    # already excludes a wider margin).
    x0 = jnp.clip(jnp.floor(xy[:, 0]).astype(jnp.int32) - r, 0, W - p1)
    y0 = jnp.clip(jnp.floor(xy[:, 1]).astype(jnp.int32) - r, 0, H - p1)
    fx = jnp.clip(xy[:, 0] - jnp.floor(xy[:, 0]), 0.0, 1.0)[:, None, None]
    fy = jnp.clip(xy[:, 1] - jnp.floor(xy[:, 1]), 0.0, 1.0)[:, None, None]
    rows = y0[:, None] + jnp.arange(p1)[None, :]          # [K, p1]
    strips = jnp.take(img, rows.reshape(-1), axis=0)      # [K*p1, W]
    strips = strips.reshape(-1, p1, W)                    # [K, p1, W]
    col_oh = (x0[:, None, None] + jnp.arange(p1)[None, None, :]
              == jnp.arange(W)[None, :, None]).astype(img.dtype)  # [K,W,p1]
    win = einsum("kjw,kwc->kjc", strips, col_oh)      # [K, p1, p1]
    v = (win[:, :-1, :-1] * (1 - fy) * (1 - fx)
         + win[:, 1:, :-1] * fy * (1 - fx)
         + win[:, :-1, 1:] * (1 - fy) * fx
         + win[:, 1:, 1:] * fy * fx)
    d = v.reshape(v.shape[0], -1)
    d = d - d.mean(axis=-1, keepdims=True)
    norm = jnp.linalg.norm(d, axis=-1, keepdims=True)
    d = d / jnp.maximum(norm, 1e-6)
    return d * valid[:, None]


@partial(jax.jit, static_argnames=("ratio",))
def mutual_nn_match(d1: jnp.ndarray, d2: jnp.ndarray,
                    valid1: jnp.ndarray, valid2: jnp.ndarray,
                    ratio: float = 0.9) -> Matches:
    """Mutual nearest neighbors with Lowe ratio test.

    Similarity = d1 @ d2.T (one matmul).  Returns fixed-size [K1]
    match slots (idx1 = arange) with a valid mask.
    """
    sim = d1 @ d2.T  # [K1,K2], cosine similarity in [-1,1]
    neg = -1e9
    sim = jnp.where(valid1[:, None] & valid2[None, :], sim, neg)

    best2 = jnp.argmax(sim, axis=1)                    # [K1]
    best_sim = jnp.max(sim, axis=1)
    # Second best for the ratio test (on distance = 2 - 2*sim).  Masked
    # via an iota compare, NOT ``.at[...].set``: a compare fuses into
    # the max, where a scatter is a separate pass.
    cols = jax.lax.broadcasted_iota(jnp.int32, sim.shape, 1)
    sim_wo_best = jnp.where(cols == best2[:, None], neg, sim)
    second_sim = jnp.max(sim_wo_best, axis=1)
    d_best = jnp.sqrt(jnp.maximum(2.0 - 2.0 * best_sim, 0.0))
    d_second = jnp.sqrt(jnp.maximum(2.0 - 2.0 * second_sim, 1e-12))
    pass_ratio = d_best <= ratio * d_second

    best1_of_2 = jnp.argmax(sim, axis=0)               # [K2]
    mutual = best1_of_2[best2] == jnp.arange(sim.shape[0])

    ok = mutual & pass_ratio & valid1 & (best_sim > neg / 2)
    return Matches(idx1=jnp.arange(sim.shape[0]), idx2=best2, valid=ok)
