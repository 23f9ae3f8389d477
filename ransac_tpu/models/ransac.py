"""Generic fixed-shape batched RANSAC engine.

A JAX replacement for OpenCV's sequential hypothesize-and-verify
loops (``cv2.findHomography(..., cv2.RANSAC, ...)`` at
``/root/reference/main_v1.py:312``; ``cv2.solvePnPRansac(5000, 30, 0.99)``
at ``main_v1.py:497-502``).  Design (SURVEY.md §7.1/§7.2):

- **Fixed-shape hypothesis tensor**: instead of a data-dependent early-exit
  loop, a static batch of S minimal samples is drawn (or, for small point
  counts, *every* C(N,k) sample is enumerated — deterministic and strictly
  stronger than any random budget), solved by a vmapped minimal solver, and
  scored in one launch.
- **Multi-solution solvers** (P3P's up-to-4 roots) flatten into the
  hypothesis axis with a validity mask — no Python branching.
- **Selection**: pure inlier count (OpenCV semantics) or MSAC truncated
  residual; invalid hypotheses are masked, never branched on.
- **Refit**: weighted least-squares on the winning inlier set + optional LM
  polish, matching OpenCV's final refinement stage.

The whole engine is jit/vmap-compatible: the localization pipeline vmaps it
over 458 candidate cameras so (458 candidates x 715 hypotheses) run as one
XLA program (SURVEY.md §2.5 "candidate parallelism").
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from itertools import combinations
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ransac_tpu.ops import epipolar, homography, pnp, projection
from ransac_tpu.ops.lm import refine_homography, refine_pose
from ransac_tpu.ops.precision import mm
from ransac_tpu.ops.rotation import exp_so3, log_so3
from ransac_tpu.utils.config import RansacConfig
from ransac_tpu.utils.prng import sample_without_replacement


class RansacResult(NamedTuple):
    model: Any                # best (refit) model parameters
    raw_model: Any            # best minimal-solver model (pre-refit)
    inlier_mask: jnp.ndarray  # [N] bool, from the best hypothesis
    num_inliers: jnp.ndarray  # scalar int
    score: jnp.ndarray        # scalar: MSAC score of best hypothesis
    best_index: jnp.ndarray   # scalar int into the hypothesis axis
    counts: jnp.ndarray       # [H] per-hypothesis inlier counts
    num_hypotheses: int


def _sample_indices(key, n_points: int, sample_size: int, cfg: RansacConfig,
                    point_mask):
    """Static [S, k] sample-index tensor: exhaustive enumeration when small
    enough, else random without replacement."""
    n_comb = math.comb(n_points, sample_size)
    if cfg.exhaustive and n_comb <= cfg.max_exhaustive_samples:
        idx = np.array(
            list(combinations(range(n_points), sample_size)), dtype=np.int32)
        return jnp.asarray(idx)
    return sample_without_replacement(
        key, cfg.num_hypotheses, sample_size, n_points, point_mask)


def ransac_fit(
    solve_fn: Callable,        # (x_k, y_k) -> (models [M,...], valid [M])
    residual_fn: Callable,     # (model, x, y) -> [N] residuals (native units)
    x: jnp.ndarray,            # [N, dx]
    y: jnp.ndarray,            # [N, dy]
    point_mask: jnp.ndarray,   # [N] bool/0-1
    sample_size: int,
    cfg: RansacConfig,
    key: jax.Array,
    degenerate_fn: Callable | None = None,
    residual_is_squared: bool = False,
    threshold=None,
):
    """Engine core.  Returns (models_flat, valid, counts, msac, best_idx,
    inlier_mask_best).  ``residual_is_squared`` marks residuals already in
    squared units (Sampson) so thresholding stays consistent."""
    n_points = x.shape[0]
    point_mask = point_mask.astype(bool)
    idx = _sample_indices(key, n_points, sample_size, cfg, point_mask)

    xs = x[idx]  # [S, k, dx]
    ys = y[idx]
    sample_ok = jnp.all(point_mask[idx], axis=-1)
    if degenerate_fn is not None:
        sample_ok = sample_ok & jnp.logical_not(jax.vmap(degenerate_fn)(xs, ys))

    models, valid = jax.vmap(solve_fn)(xs, ys)  # [S, M, ...], [S, M]
    valid = valid & sample_ok[:, None]

    # Flatten solutions into the hypothesis axis.
    n_sol = valid.shape[1]
    flat = jax.tree.map(
        lambda m: m.reshape((m.shape[0] * n_sol,) + m.shape[2:]), models)
    valid = valid.reshape(-1)

    thr = cfg.threshold if threshold is None else threshold
    inlier, counts, msac = score_hypotheses(
        flat, valid, residual_fn, x, y, point_mask, thr,
        residual_is_squared)
    best = _select_best(counts, msac, cfg.selection)
    best_mask = inlier[best]
    return flat, valid, counts, msac, best, best_mask


def score_hypotheses(models, valid, residual_fn, x, y, point_mask,
                     threshold, residual_is_squared: bool = False):
    """Score every hypothesis against every point: returns (inlier [H,N]
    bool, counts [H] (-1 where invalid), msac [H] truncated squared
    residual sum (inf where invalid)).  Non-finite residuals count as
    outliers at the truncation value."""
    point_mask = point_mask.astype(bool)
    r = jax.vmap(lambda m: residual_fn(m, x, y))(models)  # [H, N]
    thr_sq = threshold * threshold
    r_sq = r if residual_is_squared else r * r
    r_sq = jnp.where(jnp.isfinite(r_sq), r_sq, jnp.inf)
    inlier = (r_sq <= thr_sq) & point_mask[None, :]
    counts = jnp.where(valid, inlier.sum(-1), -1)
    msac = jnp.where(
        valid,
        jnp.where(point_mask[None, :], jnp.minimum(r_sq, thr_sq), 0.0).sum(-1),
        jnp.inf,
    )
    return inlier, counts, msac


def _select_best(counts, msac, selection: str):
    """Hypothesis selection: 'msac' = min truncated score; 'count' = max
    inlier count with a true lexicographic MSAC tie-break (a single
    counts*1e9 - msac float key loses the tie-break to f32 rounding)."""
    if selection == "count":
        max_count = jnp.max(counts)
        tied_msac = jnp.where(counts == max_count, msac, jnp.inf)
        return jnp.argmin(tied_msac)
    return jnp.argmin(msac)


# --------------------------------------------------------------------------
# Homography
# --------------------------------------------------------------------------
def _h_solve(xs, ys):
    H, ok = homography.dlt_homography_minimal(xs, ys)
    return H[None], ok[None]


def _h_residual(H, x, y):
    return homography.transfer_errors(H, x, y)


def _h_degenerate(xs, ys):
    return homography.sample_is_degenerate(xs) | homography.sample_is_degenerate(ys)


@partial(jax.jit, static_argnames=("cfg",))
def ransac_homography(
    src: jnp.ndarray, dst: jnp.ndarray, point_mask: jnp.ndarray,
    cfg: RansacConfig, key: jax.Array,
) -> RansacResult:
    """OpenCV ``findHomography(..., RANSAC, thr)`` equivalent: forward
    transfer error threshold, inlier-count selection, inlier refit (+LM)."""
    flat, valid, counts, msac, best, best_mask = ransac_fit(
        _h_solve, _h_residual, src, dst, point_mask, 4, cfg, key,
        degenerate_fn=_h_degenerate)
    H_best = flat[best]
    H_ref = H_best
    if cfg.refit:
        w = best_mask.astype(src.dtype)
        H_ref = homography.dlt_homography(src, dst, w)
        if cfg.refine_iters > 0:
            H_ref, _ = refine_homography(
                H_ref, src, dst, w, max_iters=cfg.refine_iters)
        bad = jnp.logical_not(jnp.all(jnp.isfinite(H_ref)))
        H_ref = jnp.where(bad, H_best, H_ref)
    return RansacResult(
        model=H_ref, raw_model=H_best, inlier_mask=best_mask,
        num_inliers=best_mask.sum(), score=msac[best], best_index=best,
        counts=counts, num_hypotheses=int(valid.shape[0]))


# --------------------------------------------------------------------------
# PnP
# --------------------------------------------------------------------------
def _pnp_residual(model, X, pix_n, ay=1.0):
    """model = [12]: flattened R (9) + t (3); residual in fx-normalized
    units: ``err * fx`` is the exact PIXEL reprojection error when the
    y-component is scaled by ``ay = fy / fx`` (anisotropy).  Callers divide
    the pixel threshold by fx, making the bound pixel-true even for the
    reference's fx/fy = 1.85 camera (main_v1.py:869-883; cv2.solvePnPRansac
    thresholds in pixels, main_v1.py:497-502).  Points behind the camera
    get +inf residual (cheirality)."""
    R = model[:9].reshape(3, 3)
    t = model[9:12]
    Xc = mm(X, R.T) + t
    z = Xc[:, 2]
    good_z = z > 1e-6
    uv = Xc[:, :2] / jnp.where(good_z, z, 1.0)[:, None]
    d = uv - pix_n
    err = jnp.sqrt(d[:, 0] ** 2 + (ay * d[:, 1]) ** 2)
    return jnp.where(good_z, err, jnp.inf)


def _pnp_solve(Xs, xs):
    R, t, valid = pnp.p3p_grunert(Xs, xs)  # [4,3,3], [4,3], [4]
    model = jnp.concatenate(
        [R.reshape(4, 9), t.reshape(4, 3)], axis=-1)  # [4,12]
    valid = valid & jnp.all(jnp.isfinite(model), axis=-1)
    return model, valid


def _epnp_solve(Xs, xs):
    """EPnP (ops.pnp.epnp) as a 6-point minimal solver: 2 beta-case
    candidates per sample flatten into the hypothesis axis."""
    R, t, valid = pnp.epnp(Xs, xs)  # [2,3,3], [2,3], [2]
    model = jnp.concatenate(
        [R.reshape(2, 9), t.reshape(2, 3)], axis=-1)  # [2,12]
    valid = valid & jnp.all(jnp.isfinite(model), axis=-1)
    return model, valid


def _pnp_msac(model, Xw, pix_n, point_mask, thr_n, ay):
    r = _pnp_residual(model, Xw, pix_n, ay=ay)
    r_sq = jnp.where(jnp.isfinite(r), r * r, jnp.inf)
    thr_sq = thr_n * thr_n
    ok = jnp.all(jnp.isfinite(model))
    w = point_mask.astype(r_sq.dtype)
    return jnp.where(ok, (jnp.minimum(r_sq, thr_sq) * w).sum(), jnp.inf)


def _pnp_refit_seed(R_best, t_best, Xw, pix_n, w, point_mask, thr_n, ay):
    """LM seed for the PnP refit: best of {raw winner, DLT-PnP, EPnP
    case-1/2 on the inlier set} by truncated-MSAC — the cv2-style
    large-inlier refit with EPnP wired in (VERDICT r1 item 9)."""
    raw = jnp.concatenate([R_best.reshape(9), t_best])
    R_dlt, t_dlt = pnp.dlt_pnp(Xw, pix_n, w)
    dlt = jnp.concatenate([R_dlt.reshape(9), t_dlt])
    R_ep, t_ep, v_ep = pnp.epnp(Xw, pix_n, w)  # [2,...]
    ep = jnp.concatenate([R_ep.reshape(2, 9), t_ep], axis=-1)
    cands = jnp.stack([raw, dlt, ep[0], ep[1]])  # [4,12]
    # DLT needs >=6 points; EPnP >=4 — gate linear seeds below that.
    n_inl = (w > 0).sum()
    gate = jnp.stack([
        jnp.asarray(True),
        n_inl >= 6,
        v_ep[0] & (n_inl >= 4),
        v_ep[1] & (n_inl >= 4),
    ])
    scores = jax.vmap(
        lambda m: _pnp_msac(m, Xw, pix_n, point_mask, thr_n, ay))(cands)
    scores = jnp.where(gate, scores, jnp.inf)
    seed = cands[jnp.argmin(scores)]
    return seed[:9].reshape(3, 3), seed[9:12]


def _pnp_threshold_scales(K, dtype):
    """(thr_scale, ay): divide the pixel threshold by ``thr_scale`` (= fx)
    and scale y-residuals by ``ay`` (= fy/fx) so thresholding happens in
    true pixel units under anisotropic K (traced — no recompile per K)."""
    K = jnp.asarray(K)
    fx = K[0, 0].astype(dtype)
    fy = K[1, 1].astype(dtype)
    return fx, fy / fx


@partial(jax.jit, static_argnames=("cfg", "solver"))
def ransac_pnp(
    Xw: jnp.ndarray, pixels: jnp.ndarray, K: jnp.ndarray,
    point_mask: jnp.ndarray, cfg: RansacConfig, key: jax.Array,
    solver: str = "p3p",
) -> RansacResult:
    """``cv2.solvePnPRansac`` equivalent over a minimal-solver hypothesis
    tensor.  ``solver``: "p3p" (Grunert, 3-pt minimal, up to 4 roots) or
    "epnp" (Lepetit, 6-pt samples, 2 beta-case candidates) — mirroring
    cv2's SOLVEPNP_P3P / SOLVEPNP_EPNP flags.

    ``cfg.threshold`` is in pixels (30.0 in the reference, main_v1.py:500);
    residuals are computed in fx-normalized coordinates with the
    y-component scaled by fy/fx, so the bound is pixel-TRUE even for
    anisotropic K (the reference camera has fx/fy = 1.85,
    main_v1.py:869-883).  Refit: best of {DLT-PnP, EPnP, raw winner} on
    the inlier set as the LM seed (= solvePnPRefineLM, main_v1.py:508).
    """
    pix_n = projection.normalize_pixels(pixels, K)
    fx, ay = _pnp_threshold_scales(K, pix_n.dtype)
    thr_n = cfg.threshold / fx
    solve_fn, k = {"p3p": (_pnp_solve, 3), "epnp": (_epnp_solve, 6)}[solver]
    flat, valid, counts, msac, best, best_mask = ransac_fit(
        solve_fn, partial(_pnp_residual, ay=ay), Xw, pix_n, point_mask,
        k, cfg, key, threshold=thr_n)
    model_best = flat[best]
    R_best = model_best[:9].reshape(3, 3)
    t_best = model_best[9:12]
    R_ref, t_ref = R_best, t_best
    if cfg.refit:
        w = best_mask.astype(Xw.dtype)
        R_seed, t_seed = _pnp_refit_seed(
            R_best, t_best, Xw, pix_n, w, point_mask, thr_n, ay)
        rvec, tvec, _ = refine_pose(
            log_so3(R_seed), t_seed, Xw, pixels, K, w,
            max_iters=max(cfg.refine_iters, 1))
        R_lm = exp_so3(rvec)
        ok = jnp.all(jnp.isfinite(rvec)) & jnp.all(jnp.isfinite(tvec))
        R_ref = jnp.where(ok, R_lm, R_best)
        t_ref = jnp.where(ok, tvec, t_best)
    model = jnp.concatenate([R_ref.reshape(9), t_ref])
    return RansacResult(
        model=model, raw_model=model_best, inlier_mask=best_mask,
        num_inliers=best_mask.sum(), score=msac[best], best_index=best,
        counts=counts, num_hypotheses=int(valid.shape[0]))


def pnp_pose_from_result(res: RansacResult):
    R = res.model[:9].reshape(3, 3)
    t = res.model[9:12]
    return R, t


# --------------------------------------------------------------------------
# Essential matrix
# --------------------------------------------------------------------------
def _e_solve(xs, ys):
    E = epipolar.eight_point(xs, ys, essential=True)
    valid = jnp.all(jnp.isfinite(E))
    return E[None], valid[None]


def _e_residual(E, x1, x2):
    return epipolar.sampson_distance(E, x1, x2)


@partial(jax.jit, static_argnames=("cfg",))
def ransac_essential(
    x1: jnp.ndarray, x2: jnp.ndarray, point_mask: jnp.ndarray,
    cfg: RansacConfig, key: jax.Array,
) -> RansacResult:
    """8-point essential-matrix RANSAC on normalized coords;
    ``cfg.threshold`` is the Sampson distance bound (normalized units).
    Sampson distance is already squared, so it is compared directly against
    the squared threshold convention via ``residual_is_squared``."""
    cfg_sq = RansacConfig(
        threshold=math.sqrt(cfg.threshold),  # engine squares it back
        num_hypotheses=cfg.num_hypotheses, exhaustive=False,
        max_exhaustive_samples=cfg.max_exhaustive_samples,
        selection=cfg.selection, refit=cfg.refit,
        refine_iters=cfg.refine_iters, seed=cfg.seed)
    flat, valid, counts, msac, best, best_mask = ransac_fit(
        _e_solve, _e_residual, x1, x2, point_mask, 8, cfg_sq, key,
        residual_is_squared=True)
    E_best = flat[best]
    E_ref = E_best
    if cfg.refit:
        w = best_mask.astype(x1.dtype)
        E_ref = epipolar.eight_point(x1, x2, w, essential=True)
        bad = jnp.logical_not(jnp.all(jnp.isfinite(E_ref)))
        E_ref = jnp.where(bad, E_best, E_ref)
    return RansacResult(
        model=E_ref, raw_model=E_best, inlier_mask=best_mask,
        num_inliers=best_mask.sum(), score=msac[best], best_index=best,
        counts=counts, num_hypotheses=int(valid.shape[0]))
