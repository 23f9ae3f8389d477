"""Distributed candidate search: shard_map over a (data, model) mesh.

The multi-device form of the localization pipeline (SURVEY.md §2.5):

- candidate cameras shard over the ``data`` axis (the reference's 458-
  iteration Python loop, main_v1.py:274),
- the RANSAC hypothesis tensor shards over the ``model`` axis (the loop
  inside cv2.findHomography), each shard drawing an independent key-folded
  sample block,
- the per-shard best hypotheses are combined with an all-gather over
  ``model`` and an on-device argmin — no host round-trips.

The same structure scales to multi-host: the mesh simply spans hosts and
XLA routes the all-gather between them.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ransac_tpu.models import ransac as ransac_mod
from ransac_tpu.ops import homography as hops
from ransac_tpu.ops import projection as proj
from ransac_tpu.utils.config import LocalizeConfig, RansacConfig


def _local_candidate_scores(pixels, pos3d, point_mask, cam_locs, keys, rcfg):
    """Score a local block of candidates with a local block of hypotheses.

    Runs inside shard_map: cam_locs is the data-shard, the hypothesis budget
    in ``rcfg`` is already divided by the model-axis size, and ``keys`` are
    per-(candidate, model-shard) fold keys.  Returns per-candidate
    (msac_best, model, inlier_mask, num_inliers).
    """

    def per_candidate(loc, key):
        pos2, _ = proj.east_axis_plane_projection(pos3d, loc)
        flat, valid, counts, msac, best, best_mask = ransac_mod.ransac_fit(
            ransac_mod._h_solve, ransac_mod._h_residual, pos2, pixels,
            point_mask, 4, rcfg, key,
            degenerate_fn=ransac_mod._h_degenerate)
        return msac[best], flat[best], best_mask, counts[best], pos2

    return jax.vmap(per_candidate)(cam_locs, keys)


def _combine_and_score(pixels, point_mask, msac_all, model_all, mask_all,
                       pos2_l, grid_l, cfg):
    """Pick each candidate's best hypothesis across the stacked model
    shards and produce reference err1/err2.  Shared verbatim by the
    shard_map body (stacks arrive via all_gather over 'model') and the
    single-device emulation (stacks built by a vmap over shard ids), so
    the dryrun's decision-equality assert compares the identical math
    routed through collectives vs not."""
    best_shard = jnp.argmin(msac_all, axis=0)             # [c_l]
    c_l = msac_all.shape[1]
    take = lambda arr: jnp.take_along_axis(
        arr, best_shard[None, :].reshape((1, c_l) + (1,) * (arr.ndim - 2)),
        axis=0)[0]
    H_best = take(model_all)
    inl = take(mask_all.astype(jnp.float32)) > 0.5

    # Reference err1/err2 scoring on the winning model: shared helper
    # from the single-mesh pipeline (pipelines.localize).  The refit
    # here is plain DLT (no LM polish) — the distributed path trades
    # that final polish for throughput; scoring semantics are shared.
    from ransac_tpu.pipelines.localize import reference_scores

    def score_one(H_raw, inl_c, pos2):
        w = inl_c.astype(pixels.dtype) * point_mask
        H = hops.dlt_homography(pos2, pixels, w)
        bad = jnp.logical_not(jnp.all(jnp.isfinite(H)))
        H = jnp.where(bad, H_raw, H)
        return reference_scores(H, pos2, pixels, inl_c, point_mask,
                                cfg.ransac.threshold)

    err1_l, err2_l = jax.vmap(score_one)(H_best, inl, pos2_l)
    gate = grid_l >= cfg.grid_code_min
    err1_l = jnp.where(gate, err1_l, 0.0)
    err2_l = jnp.where(gate, err2_l, 0.0)
    return err1_l, err2_l


def _local_rcfg(rcfg: RansacConfig, n_model: int) -> RansacConfig:
    """Per-model-shard hypothesis budget (shared by both paths)."""
    per_shard = max(rcfg.num_hypotheses // n_model, 64)
    return RansacConfig(
        threshold=rcfg.threshold, num_hypotheses=per_shard,
        exhaustive=rcfg.exhaustive and n_model == 1,
        max_exhaustive_samples=rcfg.max_exhaustive_samples,
        selection=rcfg.selection, refit=False,
        refine_iters=0, seed=rcfg.seed)


@partial(jax.jit, static_argnames=("cfg", "n_data", "n_model"))
def emulate_hypothesis_sharded(
    pixels, pos3d, point_mask, cam_locs, grid_codes, cfg: LocalizeConfig,
    key: jax.Array, n_data: int, n_model: int,
):
    """Single-device mirror of ``distributed_score_candidates`` on an
    (n_data x n_model) mesh: identical fold-key derivation
    ``fold_in(fold_in(key, di), mi)``, identical per-shard budget, and the
    identical combine math (``_combine_and_score``) — with the collectives
    replaced by stacking.  The multichip dryrun asserts the mesh program
    reproduces this bit-for-bit-in-decision (best index, err1/err2)."""
    C = cam_locs.shape[0]
    assert C % n_data == 0, (C, n_data)
    c_l = C // n_data
    rcfg_local = _local_rcfg(cfg.ransac, n_model)

    def data_shard(di):
        locs_l = jax.lax.dynamic_slice_in_dim(cam_locs, di * c_l, c_l)
        grid_l = jax.lax.dynamic_slice_in_dim(grid_codes, di * c_l, c_l)

        def model_shard(mi):
            kk = jax.random.fold_in(jax.random.fold_in(key, di), mi)
            keys = jax.random.split(kk, c_l)
            return _local_candidate_scores(
                pixels, pos3d, point_mask, locs_l, keys, rcfg_local)

        msac_all, model_all, mask_all, _, pos2_all = jax.vmap(model_shard)(
            jnp.arange(n_model))
        return _combine_and_score(
            pixels, point_mask, msac_all, model_all, mask_all, pos2_all[0],
            grid_l, cfg)

    err1, err2 = jax.vmap(data_shard)(jnp.arange(n_data))
    err1 = err1.reshape(-1)
    err2 = err2.reshape(-1)
    err2_sel = jnp.where((err2 == 0.0) | ~jnp.isfinite(err2), 1e6, err2)
    best = jnp.argmin(err2_sel)
    return {"err1": err1, "err2": err2, "best": best,
            "best_err2": err2_sel[best]}


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def distributed_score_candidates(
    pixels: jnp.ndarray,       # [N,2] replicated
    pos3d: jnp.ndarray,        # [N,3] replicated
    point_mask: jnp.ndarray,   # [N] replicated
    cam_locs: jnp.ndarray,     # [C,3], C divisible by data-axis size
    grid_codes: jnp.ndarray,   # [C]
    cfg: LocalizeConfig,
    key: jax.Array,
    mesh: Mesh,
):
    """Full candidate search sharded (data=candidates, model=hypotheses).

    Output is replicated: err1 [C], err2 [C], best index.  Scoring
    semantics are shared with pipelines.localize.score_candidates
    (reference_scores); the per-candidate refit here is plain DLT without
    the final LM polish (a deliberate throughput trade in the distributed
    path), so scores can differ slightly from the single-mesh pipeline.
    """
    n_model = mesh.shape["model"]
    n_data = mesh.shape["data"]
    C = cam_locs.shape[0]
    assert C % n_data == 0, (C, n_data)
    rcfg = cfg.ransac
    # Split the hypothesis budget across the model axis.  Exhaustive mode
    # enumerates all samples on every shard only if it fits the per-shard
    # budget; otherwise shards draw disjoint random blocks via fold keys.
    rcfg_local = _local_rcfg(rcfg, n_model)

    def shard_fn(pixels, pos3d, point_mask, cam_locs_l, grid_l, key):
        di = jax.lax.axis_index("data")
        mi = jax.lax.axis_index("model")
        kk = jax.random.fold_in(jax.random.fold_in(key[0], di), mi)
        keys = jax.random.split(kk, cam_locs_l.shape[0])
        msac_l, model_l, mask_l, count_l, pos2_l = _local_candidate_scores(
            pixels, pos3d, point_mask, cam_locs_l, keys, rcfg_local)

        # Combine hypothesis shards: all-gather over 'model', argmin msac.
        msac_all = jax.lax.all_gather(msac_l, "model")        # [m, c_l]
        model_all = jax.lax.all_gather(model_l, "model")      # [m, c_l, 3,3]
        mask_all = jax.lax.all_gather(mask_l, "model")        # [m, c_l, N]
        err1_l, err2_l = _combine_and_score(
            pixels, point_mask, msac_all, model_all, mask_all, pos2_l,
            grid_l, cfg)
        # Replicate over 'model' rows implicitly (identical on all shards);
        # gather candidate shards over 'data'.
        err1_g = jax.lax.all_gather(err1_l, "data").reshape(-1)
        err2_g = jax.lax.all_gather(err2_l, "data").reshape(-1)
        return err1_g, err2_g

    err1, err2 = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P("data"), P("data"), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(pixels, pos3d, point_mask, cam_locs, grid_codes, key[None])
    # Zero-score and non-finite guard (mirrors pipelines.localize).
    err2_sel = jnp.where((err2 == 0.0) | ~jnp.isfinite(err2), 1e6, err2)
    best = jnp.argmin(err2_sel)
    return {"err1": err1, "err2": err2, "best": best,
            "best_err2": err2_sel[best]}
