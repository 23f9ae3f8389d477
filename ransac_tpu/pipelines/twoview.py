"""Two-view reconstruction pipeline (BASELINE.json configs[2]).

detect (Harris top-K) -> describe (normalized patches) -> match (mutual-NN
on one matmul) -> essential-matrix RANSAC (8-point hypothesis tensor)
-> pose recovery (cheirality over the 4 decompositions) -> DLT
triangulation.  Everything after image load is jitted with fixed shapes;
the keyframe axis batches over the mesh ``data`` axis for multi-frame
workloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ransac_tpu.features.detect import detect_harris
from ransac_tpu.features.match import mutual_nn_match, patch_descriptors
from ransac_tpu.models import ransac as ransac_mod
from ransac_tpu.ops import epipolar
from ransac_tpu.ops import projection as proj
from ransac_tpu.utils.config import TwoViewConfig


@dataclass
class TwoViewResult:
    kp1: np.ndarray          # [K,2]
    kp2: np.ndarray
    matches: np.ndarray      # [M,2] keypoint index pairs (valid only)
    E: np.ndarray            # [3,3]
    inliers: np.ndarray      # [M] bool (per returned match)
    R: np.ndarray            # [3,3] relative pose view1->view2
    t: np.ndarray            # [3] unit translation
    points3d: np.ndarray     # [M,3] triangulated (view1 frame)
    n_cheiral: int


def two_view_pipeline(img1: np.ndarray, img2: np.ndarray, K: np.ndarray,
                      cfg: TwoViewConfig = TwoViewConfig(),
                      seed: int = 0) -> TwoViewResult:
    """Full two-view flow on a pair of grayscale float images."""
    img1j = jnp.asarray(img1, jnp.float32)
    img2j = jnp.asarray(img2, jnp.float32)
    Kj = jnp.asarray(K, jnp.float32)

    kp1 = detect_harris(img1j, cfg.max_keypoints, cfg.nms_radius, cfg.harris_k)
    kp2 = detect_harris(img2j, cfg.max_keypoints, cfg.nms_radius, cfg.harris_k)
    d1 = patch_descriptors(img1j, kp1.xy, kp1.valid, cfg.patch_size)
    d2 = patch_descriptors(img2j, kp2.xy, kp2.valid, cfg.patch_size)
    m = mutual_nn_match(d1, d2, kp1.valid, kp2.valid, cfg.match_ratio)

    # Fixed-size correspondence tensors (slots masked by m.valid).
    x1_pix = kp1.xy[m.idx1]
    x2_pix = kp2.xy[m.idx2]
    x1 = proj.normalize_pixels(x1_pix, Kj)
    x2 = proj.normalize_pixels(x2_pix, Kj)
    mask = m.valid.astype(jnp.float32)

    # cfg threshold is in pixels; Sampson distance lives in squared
    # normalized units -> bound = (px / focal)^2.
    focal = float(K[0, 0] + K[1, 1]) / 2.0
    e_cfg = ransac_mod.RansacConfig(
        threshold=(cfg.ransac.threshold / focal) ** 2,
        num_hypotheses=cfg.ransac.num_hypotheses, exhaustive=False,
        selection=cfg.ransac.selection, refit=cfg.ransac.refit,
        refine_iters=cfg.ransac.refine_iters, seed=cfg.ransac.seed)
    res = ransac_mod.ransac_essential(
        x1, x2, mask, e_cfg, jax.random.key(seed))
    inl_w = res.inlier_mask.astype(jnp.float32)
    R0, t0, _, _ = epipolar.recover_pose(res.model, x1, x2, inl_w)
    # Geometric polish: LM on inlier Sampson residuals over (rvec, t).
    R, t, E_ref = epipolar.refine_relative_pose(R0, t0, x1, x2, inl_w)
    _, _, X, n = epipolar.recover_pose(E_ref, x1, x2, inl_w)

    valid_rows = np.asarray(m.valid)
    return TwoViewResult(
        kp1=np.asarray(kp1.xy), kp2=np.asarray(kp2.xy),
        matches=np.stack([np.asarray(m.idx1), np.asarray(m.idx2)], 1)[valid_rows],
        E=np.asarray(res.model),
        inliers=np.asarray(res.inlier_mask)[valid_rows],
        R=np.asarray(R), t=np.asarray(t),
        points3d=np.asarray(X)[valid_rows], n_cheiral=int(n))
