"""ransac_tpu — a JAX geometric-vision / localization framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
repo ``Mendel0408/Code-Reproduction-RANSAC`` (historical-photo camera
localization via candidate-camera search + homography-RANSAC scoring +
PnP-RANSAC pose estimation + DEM ray-casting), generalized into a batched,
massively-parallel SLAM/SfM engine:

- ``ransac_tpu.ops``       pure-JAX geometry kernels (SO(3), projection,
                           homography, P3P/EPnP, epipolar, geodesy, LM).
- ``ransac_tpu.models``    estimation-model plugins (homography / PnP /
                           essential) + the generic fixed-shape RANSAC engine
                           and camera models/calibration.
- ``ransac_tpu.pipelines`` end-to-end pipelines: single-image localization
                           (reference parity), DEM ray-cast geo-inversion,
                           two-view, incremental SfM.
- ``ransac_tpu.ba``        Levenberg-Marquardt bundle adjustment with Schur
                           complement and pose-graph optimization.
- ``ransac_tpu.parallel``  device-mesh sharding (pjit/shard_map) for
                           hypothesis-/candidate-/observation-parallelism and
                           distributed BA over device collectives.
- ``ransac_tpu.io``        host-side ingest (CSV feature/camera tables, DEM
                           rasters) and export (CSV, GeoJSON, ESRI shapefile).
- ``ransac_tpu.utils``     config, logging, profiling, checkpointing, PRNG.

Design stance (see SURVEY.md §7): scene-centered f64->f32 coordinate hygiene,
fixed-shape hypothesis tensors instead of data-dependent RANSAC loops, and
one geometry core shared by every pipeline.
"""

__version__ = "0.1.0"

from ransac_tpu.utils.config import (  # noqa: F401
    BundleAdjustConfig,
    LocalizeConfig,
    RansacConfig,
    RaycastConfig,
    TwoViewConfig,
)


def __getattr__(name):
    """Lazy top-level API (keeps `import ransac_tpu` light)."""
    if name in ("localize", "score_candidates"):
        from ransac_tpu.pipelines import localize as _m

        return getattr(_m, name)
    if name in ("build_scene", "read_camera_locations", "read_points_data"):
        from ransac_tpu.io import tables as _m

        return getattr(_m, name)
    if name in ("ransac_homography", "ransac_pnp", "ransac_essential"):
        from ransac_tpu.models import ransac as _m

        return getattr(_m, name)
    if name == "two_view_pipeline":
        from ransac_tpu.pipelines.twoview import two_view_pipeline

        return two_view_pipeline
    if name == "incremental_sfm":
        from ransac_tpu.pipelines.sfm import incremental_sfm

        return incremental_sfm
    if name == "bundle_adjust":
        from ransac_tpu.ba.bundle import bundle_adjust

        return bundle_adjust
    raise AttributeError(name)
