"""Typed configuration for every pipeline.

The reference has no flag system at all: behavior is selected by editing an
``images_info`` list-of-dicts (``/root/reference/main_v1.py:975-1013``), by
1000-line module-level ``if img == ...`` ladders (``testpro.py:927-1134``) and
by magic inline constants (ransacbound 75.0 at ``main_v1.py:862``, +2.0 m
observer height at ``main_v1.py:748``, the 150-step ray-march warmup at
``main_v1.py:650``).  Here every one of those knobs is a named, documented
dataclass field with the reference's value as the default.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class RansacConfig:
    """Fixed-shape RANSAC engine configuration.

    Replaces OpenCV's adaptive hypothesize-and-verify loop
    (``cv2.findHomography(..., cv2.RANSAC, bound)`` at ``main_v1.py:312`` and
    ``cv2.solvePnPRansac(iterationsCount=5000, ...)`` at ``main_v1.py:497``)
    with a static hypothesis tensor sized for XLA.
    """

    #: Inlier threshold in the residual's native units (pixels for
    #: homography/PnP; Sampson distance for essential).  75.0 is the
    #: reference's homography bound (main_v1.py:862), 30.0 its PnP bound
    #: (main_v1.py:500).
    threshold: float = 75.0
    #: Number of minimal-sample hypotheses when sampling randomly.  The
    #: reference's PnP budget is 5000 (main_v1.py:499).
    num_hypotheses: int = 4096
    #: If True and the (static) point count is small enough, enumerate every
    #: minimal sample instead of sampling — deterministic and strictly
    #: stronger than any random budget.  C(13,4)=715 for the reference's
    #: homography search; C(12,3)=220 for its P3P.
    exhaustive: bool = True
    #: Cap on enumerated samples before falling back to random sampling.
    max_exhaustive_samples: int = 8192
    #: 'count' reproduces OpenCV's pure inlier-count objective; 'msac' uses
    #: the truncated-residual MSAC score (better, still count-compatible on
    #: clean data).
    selection: str = "msac"
    #: Refit the model on the winning inlier set (OpenCV does a final LM
    #: refine on inliers for findHomography / solvePnPRefineLM).
    refit: bool = True
    #: LM refinement iterations applied after the least-squares refit.
    refine_iters: int = 10
    seed: int = 0


@dataclass(frozen=True)
class CameraIntrinsicsConfig:
    """Physical-film intrinsics, reference semantics (main_v1.py:869-883):
    fx = f_mm / sensor_w_mm * W, fy = f_mm / sensor_h_mm * H."""

    focal_length_mm: float = 240.0
    sensor_width_mm: float = 127.0
    sensor_height_mm: float = 178.0
    cx: float = 9.82666819e02
    cy: float = 6.97950868e02


@dataclass(frozen=True)
class LocalizeConfig:
    """Single-image candidate-camera localization (= reference main_v1 flow)."""

    ransac: RansacConfig = field(default_factory=RansacConfig)
    pnp_ransac: RansacConfig = field(
        default_factory=lambda: RansacConfig(threshold=30.0, num_hypotheses=5000)
    )
    intrinsics: CameraIntrinsicsConfig = field(default_factory=CameraIntrinsicsConfig)
    #: Candidates with grid_code below this are skipped (score forced to 0,
    #: then clamped to 1e6 at argmin) — main_v1.py:275 uses 0, process.py:398
    #: uses 7.
    grid_code_min: int = 0
    #: Observer height added to each candidate elevation (main_v1.py:748).
    observer_height_m: float = 2.0
    #: Minimum PnP inliers required (main_v1.py:504).
    min_pnp_inliers: int = 6
    #: Feature-table z semantics: 'elevation' (main_v1.py:718) or
    #: 'height_plus_elevation' (test_pro.py:725).
    z_mode: str = "elevation"
    #: Divisor applied to annotated pixel coordinates (main_v1.py:705).
    pixel_scale: float = 1.0


@dataclass(frozen=True)
class RaycastConfig:
    """DEM ray-march geo-inversion (main_v1.py:635-684)."""

    max_search_dist_m: float = 10_000.0
    step_m: float = 1.0
    #: Reference quirk: a hit only counts after this many steps
    #: (150 at main_v1.py:650; 120 at testpro.py:689). 0 disables.
    min_hit_step: int = 150
    #: Ray-correction mode: 'weighted_factors' (main_v1.py:577-632),
    #: 'lsq_scales' (test_pro.py:645-680), or 'none'.
    correction: str = "weighted_factors"
    #: Inverse-distance weight cap and nearest-neighbor boost
    #: (main_v1.py:577: max_weight=1, knn_weight=10).
    max_weight: float = 1.0
    knn_weight: float = 10.0
    #: Per-component optimization factors with |f|>2 are dropped
    #: (main_v1.py:616).
    factor_abs_max: float = 2.0
    #: Camera altitude snap above terrain (main_v1.py:915).
    camera_height_above_dem_m: float = 1.5
    #: March strategy: 'mip' (coarse-to-fine over a pooled-max DEM,
    #: identical results, ~4x fewer DEM samples) or 'chunk' (plain
    #: chunked lockstep march).
    march: str = "mip"


@dataclass(frozen=True)
class TwoViewConfig:
    """Two-view pipeline: detect → match → essential RANSAC → triangulate."""

    max_keypoints: int = 1024
    harris_k: float = 0.04
    nms_radius: int = 4
    patch_size: int = 8
    match_ratio: float = 0.9
    #: RANSAC threshold is in PIXELS (converted to a squared normalized
    #: Sampson bound using the focal length inside the pipeline).
    ransac: RansacConfig = field(
        default_factory=lambda: RansacConfig(
            threshold=2.0, num_hypotheses=8192, exhaustive=False
        )
    )


@dataclass(frozen=True)
class BundleAdjustConfig:
    max_iters: int = 30
    damping_init: float = 1e-3
    damping_up: float = 4.0
    damping_down: float = 0.5
    rtol: float = 1e-8
    #: Huber robust-loss scale in pixels (0 disables).
    huber_scale: float = 0.0


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def from_mapping(cls, m: Mapping[str, Any]):
    """Build a (possibly nested) config dataclass from a plain mapping."""
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in m:
            continue
        v = m[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, Mapping):
            v = from_mapping(ftype, v)
        kwargs[f.name] = v
    return cls(**kwargs)
