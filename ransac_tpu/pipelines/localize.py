"""Single-image candidate-camera localization pipeline.

The reference's primary flow (``/root/reference/main_v1.py:836-930``):

  458-candidate Python loop, one OpenCV homography-RANSAC per candidate
  (~6.8 ms each, debug.log) -> argmin err2 -> PnP-RANSAC (5000 iters) ->
  LM refine -> camera origin.

Here the whole candidate search is ONE jitted launch: the east-axis plane
projection, the C(N,4)-exhaustive homography hypothesis tensor, fused
inlier scoring, per-candidate refit and the reference's err1/err2 scoring
(SURVEY.md §2.4 semantics, incl. the outlier penalty err2 += outliers *
ransacbound, main_v1.py:419) are vmapped over all candidates
(458 x 715 hypotheses per launch), followed by a vmapped-P3P PnP-RANSAC on
the winning correspondences.  Geometry runs scene-centered f32 on device;
absolute UTM in/out stays f64 on host.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ransac_tpu.io.tables import Scene
from ransac_tpu.models import ransac as ransac_mod
from ransac_tpu.ops import homography as hops
from ransac_tpu.ops.linalg import inv3x3
from ransac_tpu.ops import projection as proj
from ransac_tpu.utils.config import LocalizeConfig, RansacConfig
from ransac_tpu.utils.logging import get_logger, metrics, timed

log = get_logger("localize")


def reference_scores(H, pos2, pixels, inlier_mask, point_mask, ransacbound):
    """The reference's per-candidate (err1, err2) scoring (SURVEY.md §2.4,
    main_v1.py:332-419): pixel-space error over inliers, plane-space error
    over inliers plus (#outliers x ransacbound).  Shared by the single- and
    sharded-mesh search paths.  Non-finite errors (singular H) are replaced
    by a large finite penalty so masked sums cannot turn into NaN."""
    inl_f = (inlier_mask & point_mask.astype(bool)).astype(pixels.dtype)
    pred_pix = hops.apply_h(H, pos2)
    e1 = jnp.linalg.norm(pred_pix - pixels, axis=-1)
    e1 = jnp.where(jnp.isfinite(e1), e1, 1e9)
    err1 = (e1 * inl_f).sum()
    pred_plane = hops.apply_h(inv3x3(H), pixels)
    e2 = jnp.linalg.norm(pred_plane - pos2, axis=-1)
    e2 = jnp.where(jnp.isfinite(e2), e2, 1e9)
    err2 = (e2 * inl_f).sum()
    n_out = point_mask.sum() - inl_f.sum()
    return err1, err2 + n_out * ransacbound


@partial(jax.jit, static_argnames=("cfg",))
def score_candidates(
    pixels: jnp.ndarray,      # [N,2]
    pos3d: jnp.ndarray,       # [N,3] centered
    point_mask: jnp.ndarray,  # [N]
    cam_locs: jnp.ndarray,    # [C,3] centered
    grid_codes: jnp.ndarray,  # [C]
    cfg: LocalizeConfig,
    key: jax.Array,
):
    """Score every candidate camera location in one launch.

    Returns dict with err1 [C], err2 [C] (reference §2.4 semantics),
    H [C,3,3] (plane->pixel, the OpenCV-convention M), inliers [C,N],
    counts [C].  Candidates with grid_code < cfg.grid_code_min score 0
    exactly like main_v1.py:274-282.
    """
    rcfg = cfg.ransac

    def per_candidate(loc, key):
        pos2, d_east = proj.east_axis_plane_projection(pos3d, loc)
        res = ransac_mod.ransac_homography(pos2, pixels, point_mask, rcfg, key)
        err1, err2 = reference_scores(
            res.model, pos2, pixels, res.inlier_mask, point_mask,
            rcfg.threshold)
        return err1, err2, res.model, \
            res.inlier_mask & point_mask.astype(bool), res.num_inliers

    keys = jax.random.split(key, cam_locs.shape[0])
    err1, err2, H, inliers, counts = jax.vmap(per_candidate)(cam_locs, keys)
    gate = grid_codes >= cfg.grid_code_min
    err1 = jnp.where(gate, err1, 0.0)
    err2 = jnp.where(gate, err2, 0.0)
    # Reference argmin semantics (main_v1.py:863-866): zeros -> 1e6.  Also
    # guard non-finite scores (a fully-degenerate candidate can yield a
    # singular refit H whose inv() poisons err2 with NaN, which would
    # otherwise hijack argmin).
    err2_sel = jnp.where((err2 == 0.0) | ~jnp.isfinite(err2), 1e6, err2)
    best = jnp.argmin(err2_sel)
    return {
        "err1": err1, "err2": err2, "H": H, "inliers": inliers,
        "counts": counts, "best": best, "best_err2": err2_sel[best],
    }


@dataclass
class LocalizationResult:
    best_index: int
    best_location_utm: np.ndarray     # [3] f64
    err1: np.ndarray                  # [C]
    err2: np.ndarray                  # [C]
    homographies: np.ndarray          # [C,3,3]
    inlier_masks: np.ndarray          # [C,N]
    K: np.ndarray                     # [3,3]
    R: np.ndarray | None              # [3,3] world(centered UTM)->camera
    t: np.ndarray | None              # [3] (centered frame)
    camera_origin_utm: np.ndarray | None  # [3] f64
    pnp_inliers: np.ndarray | None    # [N] bool
    scores_rows: list                 # per-candidate CSV rows (ref layout)


def export_best_candidate_report(
    scene: Scene, result: "LocalizationResult", outputfile: str,
    image=None, depth_val: float = 1.0, make_plots: bool = True,
    all_features=None,
):
    """The reference's show-mode artifacts for the winning candidate
    (main_v1.py:384-417 + find_homographies(show=True) second pass):
    ``*_accuracies.csv``, ``*_correlations.csv`` and the diagnostic plots
    (annotated overlay, error histograms, bearing rose, NN distances,
    homography heatmap, RANSAC scatter) saved next to ``outputfile``.

    ``all_features``: optional FeatureTable read with
    ``keep_unannotated=True`` — its (0,0)-pixel rows are forward-projected
    through the winning H into the accuracies/correlations CSVs and the
    overlay (black squares), matching the reference's unnoted-feature
    block (main_v1.py:367-383: ``pp2 = M^-1 @ [pos2, 1]`` with actual
    pixel written as (0, 0)).
    """
    from ransac_tpu import analytics, viz
    from ransac_tpu.io.export import write_rows_csv
    from ransac_tpu.ops import homography as hops_mod

    best = result.best_index
    H = jnp.asarray(result.homographies[best])
    feats = scene.features if all_features is None else all_features
    pos3d_local = (scene.pos3d if all_features is None
                   else scene.frame.center(feats.pos3d_utm))
    loc = scene.cam_locs[best]
    pos2, _ = proj.east_axis_plane_projection(
        jnp.asarray(np.asarray(pos3d_local, np.float32)), jnp.asarray(loc))
    calc_pixels = np.asarray(hops_mod.apply_h(H, pos2))
    annotated = (np.abs(np.asarray(feats.pixels)) > 0).any(axis=1)
    pos_xy = feats.pos3d_utm[:, :2]

    acc_rows = analytics.accuracy_rows(
        feats.symbols, feats.names, pos_xy, feats.pixels, calc_pixels)
    write_rows_csv(outputfile.replace(".jpg", "_accuracies.csv"), acc_rows,
                   encoding="utf-8-sig")
    corr_rows = analytics.correlate_features(
        feats.symbols, pos_xy, feats.pixels, calc_pixels, depth_val)
    write_rows_csv(outputfile.replace(".jpg", "_correlations.csv"), corr_rows)

    if make_plots:
        base = outputfile.replace(".jpg", "")
        inl_best = np.asarray(result.inlier_masks[best])
        if all_features is None:
            inl = inl_best
        else:
            # Map the search's annotated-row inlier mask onto the full
            # table (row order is preserved by ingest); unannotated rows
            # are display-only, never scored.
            inl = np.zeros(len(feats), bool)
            inl[annotated] = inl_best
        viz.plot_annotated_image(
            image, feats.pixels, feats.symbols, calc_pixels, inl,
            unannotated_mask=~annotated, save_to=base + "_output.png")
        err = np.linalg.norm(calc_pixels - feats.pixels, axis=1)
        viz.plot_error_histogram(err[inl], "inlier pixel error",
                                 save_to=base + "_err_hist.png")
        viz.plot_angle_rose(
            analytics.calc_bearing(
                feats.pixels[:, 0], feats.pixels[:, 1],
                calc_pixels[:, 0], calc_pixels[:, 1]),
            save_to=base + "_rose.png")
        viz.plot_nearest_neighbor_distances(
            analytics.nearest_neighbor_distances(feats.pixels),
            save_to=base + "_nn.png")
        viz.plot_homography_heatmap(result.homographies[best],
                                    save_to=base + "_H.png")
        viz.plot_ransac_scatter(feats.pixels[inl], feats.pixels[~inl],
                                save_to=base + "_ransac.png")
        viz.plot_camera_location_scores(
            result.scores_rows, zone=scene.frame.zone,
            save_to=base + "_scores.png")
        viz.plot_camera_pose(scene.cameras.pos3d_utm, best,
                             zone=scene.frame.zone,
                             save_to=base + "_pose.png")
    return acc_rows, corr_rows


def localize(
    scene: Scene,
    image_size: tuple[int, int],
    cfg: LocalizeConfig = LocalizeConfig(),
    seed: int = 0,
) -> LocalizationResult:
    """Full localization: candidate search + PnP pose (reference
    main_v1.py:836-930 flow, minus DEM/raycast which live in
    pipelines.raycast).
    """
    width, height = image_size
    key = jax.random.key(seed)
    k_search, k_pnp = jax.random.split(key)

    with timed("localize.search"):
        search_args = (
            jnp.asarray(scene.pixels), jnp.asarray(scene.pos3d),
            jnp.asarray(scene.point_mask), jnp.asarray(scene.cam_locs),
            jnp.asarray(scene.grid_codes))
        out = score_candidates(*search_args, cfg, k_search)
        out = jax.tree.map(np.asarray, out)
    best = int(out["best"])
    best_loc = scene.frame.uncenter(scene.cam_locs[best])
    log.info("best candidate %d grid=%d err2=%.3f utm=%s", best,
             int(scene.grid_codes[best]), float(out["err2"][best]), best_loc)
    metrics.record("localize.best_index", best)
    metrics.record("localize.best_err2", float(out["err2"][best]))

    # Reference CSV rows (main_v1.py:283): [i+1, err1, err2, grid, E, N, z].
    scores_rows = []
    cam_utm = scene.cameras.pos3d_utm
    for i in range(len(scene.grid_codes)):
        scores_rows.append([
            i + 1, float(out["err1"][i]), float(out["err2"][i]),
            int(scene.grid_codes[i]), cam_utm[i, 0], cam_utm[i, 1],
            cam_utm[i, 2],
        ])

    K = np.asarray(proj.intrinsics_from_physical(
        cfg.intrinsics.focal_length_mm, cfg.intrinsics.sensor_width_mm,
        cfg.intrinsics.sensor_height_mm, width, height,
        cfg.intrinsics.cx, cfg.intrinsics.cy))

    # PnP on annotated correspondences (centered frame).
    R = t = origin_utm = pnp_inl = None
    with timed("localize.pnp"):
        res = ransac_mod.ransac_pnp(
            jnp.asarray(scene.pos3d), jnp.asarray(scene.pixels),
            jnp.asarray(K, dtype=jnp.float32), jnp.asarray(scene.point_mask),
            cfg.pnp_ransac, k_pnp)
        n_inl = int(res.num_inliers)
        if n_inl >= cfg.min_pnp_inliers:
            Rj, tj = ransac_mod.pnp_pose_from_result(res)
            R = np.asarray(Rj, dtype=np.float64)
            t = np.asarray(tj, dtype=np.float64)
            origin_local = -R.T @ t
            origin_utm = scene.frame.uncenter(origin_local)
            pnp_inl = np.asarray(res.inlier_mask)
            metrics.record("localize.pnp_inliers", n_inl)
            log.info("PnP pose: %d inliers, origin %s", n_inl, origin_utm)
        else:
            # main_v1.py:504-506 guard.
            log.warning("PnP RANSAC failed or insufficient inliers (%d)", n_inl)

    return LocalizationResult(
        best_index=best, best_location_utm=best_loc,
        err1=out["err1"], err2=out["err2"], homographies=out["H"],
        inlier_masks=out["inliers"], K=K, R=R, t=t,
        camera_origin_utm=origin_utm, pnp_inliers=pnp_inl,
        scores_rows=scores_rows)
