#!/usr/bin/env python
"""Quickest proof that the system runs on one GPU, end to end.

Phases, each of which fails the run (non-zero exit, no result line) if its
check fails:

- device:   JAX's default backend must be ``gpu``; prints the card's name
            and power limit, the JAX/CUDA environment and ``XLA_FLAGS``.
- localize: writes a seeded synthetic scene in the reference's CSV schema
            (29 features, 13 annotated; 458 candidates over 49 grid codes
            near the reference site; a 2142x1620 photo) and localizes it
            through ``ransac_tpu.cli.main(["localize", ...])``, the entry
            point a user calls.  Checks the planted candidate wins and the
            PnP origin lies near the planted camera; prints cold and warm
            wall time; then reruns on the CPU backend in this process and
            compares.
- raycast:  ``GeoInverter`` on a 20 km x 20 km, 10 m DEM (2001^2, 16 MB on
            the device): 4096 pixels to ground from the recovered pose,
            compared with the CPU backend.
- twoview:  one rendered 1024x1024 pair through ``two_view_pipeline`` with
            512 keypoints; checks the relative pose against the rendering.
- headline: the plain RANSAC engine at 2^22 hypotheses x 13 points.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; every number is
printed on earlier lines.

``--devices 4`` runs only ``__graft_entry__.dryrun_multichip(4)``: the
candidate- and hypothesis-sharded searches, distributed Schur BA and the
distributed Sim(3) pose graph, each checked against its single-device
result, across four cards.

Run: ``python chip_smoke.py [--devices 4]``.
"""

import argparse
import contextlib
import csv
import io
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np

# Near the reference's site (Kuliang, Fuzhou; UTM zone 50N).
SITE_LON, SITE_LAT = 119.39055, 26.09361
IMAGE_W, IMAGE_H = 2142, 1620
N_FEATURES, N_ANNOTATED, N_CANDIDATES, N_GRID = 29, 13, 458, 49
PIXEL_NOISE = 0.5           # px, added to the annotated pixels
# The PnP origin from 13 annotations with 0.5 px noise at 0.8-3 km depth
# and fx ~ 4048 px: lateral error ~0.3 m, along the view ~10x that.
PNP_ORIGIN_TOL_M = 10.0
# GPU vs CPU backend on identical inputs.  Both run the same float32
# program; only reduction order and the GPU's TF32/fused arithmetic may
# differ.  err2 sums plane-space errors (1e-3 to 1e-1 per candidate here)
# plus 75 per outlier, so relative differences above 1e-3 mean different
# inlier sets or a lossy product, not reordering.
LOCALIZE_ERR_RTOL = 1e-3
LOCALIZE_ERR_ATOL = 1e-6
PNP_PARITY_TOL_M = 0.5
# Hits march in 1 m steps; a hit decided one step apart moves by <= 1 m.
RAYCAST_POS_TOL_M = 1.0
RAYCAST_MAX_FLIPS = 4       # of 4096 rays may change hit/no-hit
# Two rendered views 0.045 apart at 4-9 depth, ~7 px of parallax: on the
# CPU backend seeds 0-2 give 0.0 deg rotation and 0.95-1.57 deg direction
# error.
TWOVIEW_ROT_TOL_DEG = 0.5
TWOVIEW_TDIR_TOL_DEG = 5.0


def write_scene(directory, n_candidates=N_CANDIDATES, seed=0):
    """Write ``features.csv`` and ``cameras.csv`` in the reference schema
    (main_v1.py:689-762) for a photo taken by a planted camera.

    The camera looks east, as the reference's plane projection assumes.
    The 13 annotated landmarks are back-projected from random pixels at
    0.8-3 km depth through the pipeline's default intrinsics; the other
    16 carry pixel (0, 0) (unannotated).  Candidates sit at >= 30 m from
    each other around the camera; one of them is the camera itself.
    Returns the paths, the planted index and the camera's UTM origin."""
    from ransac_tpu.ops.geodesy import utm_to_wgs84, wgs84_to_utm
    from ransac_tpu.utils.config import CameraIntrinsicsConfig

    rng = np.random.default_rng(seed)
    e0, n0 = wgs84_to_utm(SITE_LON, SITE_LAT)
    cam = np.array([e0, n0, 180.0])
    ic = CameraIntrinsicsConfig()
    fx = ic.focal_length_mm / ic.sensor_width_mm * IMAGE_W
    fy = ic.focal_length_mm / ic.sensor_height_mm * IMAGE_H
    # Camera axes in (E, N, up): right = south, down, forward = east,
    # pitched up 3 degrees.
    p = np.deg2rad(3.0)
    fwd = np.array([np.cos(p), 0.0, np.sin(p)])
    right = np.array([0.0, -1.0, 0.0])
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])        # world -> camera rows

    uv = np.stack([rng.uniform(100, IMAGE_W - 100, N_ANNOTATED),
                   rng.uniform(100, IMAGE_H - 100, N_ANNOTATED)], 1)
    depth = rng.uniform(800.0, 3000.0, N_ANNOTATED)
    xc = np.stack([(uv[:, 0] - ic.cx) / fx * depth,
                   (uv[:, 1] - ic.cy) / fy * depth, depth], 1)
    pts = cam + xc @ R
    extra = cam + np.stack([rng.uniform(500, 4000, N_FEATURES - N_ANNOTATED),
                            rng.uniform(-2000, 2000,
                                        N_FEATURES - N_ANNOTATED),
                            rng.uniform(0, 500, N_FEATURES - N_ANNOTATED)],
                           1)
    feats = np.concatenate([pts, extra])
    pix = np.zeros((N_FEATURES, 2))
    pix[:N_ANNOTATED] = uv + rng.normal(scale=PIXEL_NOISE,
                                        size=uv.shape)
    order = rng.permutation(N_FEATURES)
    feats, pix = feats[order], pix[order]
    lon, lat = utm_to_wgs84(feats[:, 0], feats[:, 1])

    fpath = os.path.join(directory, "features.csv")
    with open(fpath, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["ID", "Symbol", "Name", "Height", "Longitude",
                    "Latitude", "Elevation", "Pixel_x_synth.jpg",
                    "Pixel_y_synth.jpg"])
        for i in range(N_FEATURES):
            w.writerow([i + 1, f"L{i + 1}", f"landmark {i + 1}", 0.0,
                        repr(float(lon[i])), repr(float(lat[i])),
                        repr(float(feats[i, 2])), repr(float(pix[i, 0])),
                        repr(float(pix[i, 1]))])

    # Candidates: rejection-sampled at >= 30 m spacing in a 1.2 km box.
    cands = [cam.copy()]
    while len(cands) < n_candidates:
        c = cam + np.array([rng.uniform(-600, 600), rng.uniform(-600, 600),
                            rng.uniform(-30, 30)])
        if min(np.linalg.norm(c[:2] - q[:2]) for q in cands) >= 30.0:
            cands.append(c)
    cands = np.array(cands)
    planted = int(rng.integers(n_candidates))
    cands[[0, planted]] = cands[[planted, 0]]
    side = int(np.sqrt(N_GRID))
    gx = np.clip(((cands[:, 0] - cam[0] + 600) / 1200 * side).astype(int),
                 0, side - 1)
    gy = np.clip(((cands[:, 1] - cam[1] + 600) / 1200 * side).astype(int),
                 0, side - 1)
    grid = gy * side + gx + 1
    clon, clat = utm_to_wgs84(cands[:, 0], cands[:, 1])
    observer_height = 2.0   # read_camera_locations adds it back
    cpath = os.path.join(directory, "cameras.csv")
    with open(cpath, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["ID", "grid_code", "Longitude", "Latitude",
                    "Elevation"])
        for i in range(n_candidates):
            w.writerow([i + 1, int(grid[i]), repr(float(clon[i])),
                        repr(float(clat[i])),
                        repr(float(cands[i, 2] - observer_height))])
    return {"features": fpath, "cameras": cpath, "planted": planted,
            "camera_utm": cam}


def localize_argv(scene):
    return ["localize", "--features", scene["features"],
            "--cameras", scene["cameras"],
            "--pixel-x", "Pixel_x_synth.jpg", "--pixel-y",
            "Pixel_y_synth.jpg", "--width", str(IMAGE_W),
            "--height", str(IMAGE_H)]


def run_localize(scene):
    """``cli.main(["localize", ...])``; returns (result, wall s, stdout)."""
    from ransac_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cli.main(localize_argv(scene))
    return res, time.perf_counter() - t0, buf.getvalue()


def check_localization(res, scene):
    """The planted candidate wins and PnP lands near the planted camera;
    returns the origin's distance in meters."""
    if res.best_index != scene["planted"]:
        raise AssertionError(f"best candidate {res.best_index} is not the "
                             f"planted {scene['planted']}")
    if res.camera_origin_utm is None:
        raise AssertionError("PnP found no pose")
    dist = float(np.linalg.norm(res.camera_origin_utm - scene["camera_utm"]))
    if dist > PNP_ORIGIN_TOL_M:
        raise AssertionError(f"PnP origin {dist:.2f} m from the planted "
                             f"camera (limit {PNP_ORIGIN_TOL_M} m)")
    return dist


def compare_localizations(gpu, cpu):
    """GPU vs CPU: best index, per-candidate err1/err2, PnP origin."""
    if gpu.best_index != cpu.best_index:
        raise AssertionError(f"best index gpu={gpu.best_index} "
                             f"cpu={cpu.best_index}")
    report = {}
    for name in ("err1", "err2"):
        a = np.asarray(getattr(gpu, name), np.float64)
        b = np.asarray(getattr(cpu, name), np.float64)
        bad = np.abs(a - b) > LOCALIZE_ERR_ATOL + LOCALIZE_ERR_RTOL * np.abs(b)
        report[name] = (float(np.max(np.abs(a - b) / np.maximum(
            np.abs(b), 1e-12))), int(bad.sum()))
        if bad.any():
            i = int(np.argmax(np.abs(a - b)))
            raise AssertionError(
                f"{name}: {int(bad.sum())} of {len(a)} candidates differ "
                f"beyond rtol={LOCALIZE_ERR_RTOL} (worst #{i}: gpu {a[i]} "
                f"cpu {b[i]})")
    d = float(np.linalg.norm(gpu.camera_origin_utm - cpu.camera_origin_utm))
    if d > PNP_PARITY_TOL_M:
        raise AssertionError(f"PnP origins differ by {d:.3f} m")
    report["pnp_origin_m"] = d
    return report


def phase_device():
    import jax

    from ransac_tpu.utils.device import (device_record,
                                         gpu_name_and_power_limit,
                                         require_gpu)

    devices = require_gpu()
    print("nvidia-smi --query-gpu=name,power.limit:")
    print(gpu_name_and_power_limit())
    print(f"jax {jax.__version__}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    info = jax.print_environment_info(return_string=True)
    print("\n".join(line for line in info.splitlines()
                    if "CUDA" in line or "jaxlib" in line
                    or "jax_plugins" in line))
    return device_record(devices)


def phase_localize(tmp):
    import jax

    scene = write_scene(tmp)
    res, cold, out = run_localize(scene)
    dist = check_localization(res, scene)
    _, warm, _ = run_localize(scene)
    print(out.strip())
    print(f"localize: planted candidate {scene['planted']} recovered, PnP "
          f"origin {dist:.3f} m from the planted camera; wall time cold "
          f"{cold:.2f} s, warm {warm:.2f} s")
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu, t_cpu, _ = run_localize(scene)
    rep = compare_localizations(res, res_cpu)
    print(f"localize parity gpu vs cpu: best index equal; err1 max rel "
          f"diff {rep['err1'][0]:.3g}, err2 max rel diff "
          f"{rep['err2'][0]:.3g} (rtol {LOCALIZE_ERR_RTOL}); PnP origins "
          f"{rep['pnp_origin_m']:.4f} m apart (cpu run {t_cpu:.1f} s)")
    return res, scene


def build_inverter(res, scene):
    """GeoInverter at the recovered pose over a 20 km square, 10 m DEM,
    camera 1.5 m above the terrain (main_v1.py:914-915), the annotated
    landmarks as control points."""
    from ransac_tpu.io.dem import synthetic_dem
    from ransac_tpu.io.tables import read_points_data
    from ransac_tpu.ops.geodesy import SceneFrame
    from ransac_tpu.pipelines.raycast import GeoInverter

    feats = read_points_data(scene["features"], "Pixel_x_synth.jpg",
                             "Pixel_y_synth.jpg")
    frame = SceneFrame(anchor=np.asarray(res.camera_origin_utm, np.float64))
    dem = synthetic_dem(
        frame, extent_m=10_000.0, spacing_m=10.0,
        terrain_fn=lambda X, Y: (60.0 * np.sin(X / 900.0)
                                 * np.cos(Y / 1300.0)
                                 + 25.0 * np.sin((X + 2 * Y) / 500.0)))
    z0 = float(dem.data[dem.data.shape[0] // 2, dem.data.shape[1] // 2])
    origin = np.array([0.0, 0.0, z0 + 1.5])
    return GeoInverter(K=res.K, R=res.R, ray_origin=origin, dem=dem,
                       control_pixels=feats.pixels,
                       control_pos3d=frame.center(feats.pos3d_utm,
                                                  np.float64))


def raycast_pixels(n_side=64):
    u, v = np.meshgrid(np.linspace(0, IMAGE_W - 1, n_side),
                       np.linspace(0, IMAGE_H - 1, n_side))
    return np.stack([u.ravel(), v.ravel()], 1)


def compare_raycasts(gpu, cpu):
    (utm_g, hit_g), (utm_c, hit_c) = gpu, cpu
    flips = int((hit_g != hit_c).sum())
    both = hit_g & hit_c
    d = np.linalg.norm(utm_g[both] - utm_c[both], axis=1)
    dmax = float(d.max()) if d.size else 0.0
    if flips > RAYCAST_MAX_FLIPS or dmax > RAYCAST_POS_TOL_M:
        raise AssertionError(f"raycast gpu vs cpu: {flips} hit flips, "
                             f"max hit distance {dmax:.3f} m")
    return flips, dmax


def phase_raycast(res, scene):
    import jax

    inv = build_inverter(res, scene)
    pix = raycast_pixels()
    t0 = time.perf_counter()
    utm, hit = inv.pixel_to_geo(pix)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    inv.pixel_to_geo(pix)
    warm = time.perf_counter() - t0
    if not (0 < hit.sum() < len(hit)) or not np.isfinite(utm).all():
        raise AssertionError(f"raycast: {int(hit.sum())} of {len(hit)} "
                             f"rays hit; expected ground and sky")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        inv_cpu = build_inverter(res, scene)
        utm_c, hit_c = inv_cpu.pixel_to_geo(pix)
    flips, dmax = compare_raycasts((utm, hit), (utm_c, hit_c))
    print(f"raycast: {len(pix)} pixels on a {inv.dem.data.shape} DEM, "
          f"{int(hit.sum())} hit; cold {cold:.2f} s, warm {warm:.3f} s; "
          f"gpu vs cpu: {flips} hit flips, max hit distance {dmax:.4f} m")


def twoview_errors(res, centers):
    """(rotation error deg, translation direction error deg) of a
    two-view result against the rendered R = I motion."""
    ang = np.degrees(np.arccos(np.clip((np.trace(res.R) - 1) / 2, -1, 1)))
    t_true = centers[0] - centers[1]
    cosang = float(np.dot(res.t, t_true) / (np.linalg.norm(res.t)
                                            * np.linalg.norm(t_true)))
    return float(ang), float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))


def phase_twoview():
    from ransac_tpu.pipelines.sfm_demo import synth_trajectory_frames
    from ransac_tpu.pipelines.twoview import two_view_pipeline
    from ransac_tpu.utils.config import TwoViewConfig

    imgs, K, centers, _ = synth_trajectory_frames(F=2, H=1024, W=1024,
                                                  seed=0)
    cfg = TwoViewConfig(max_keypoints=512)
    t0 = time.perf_counter()
    res = two_view_pipeline(imgs[0], imgs[1], K, cfg)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    two_view_pipeline(imgs[0], imgs[1], K, cfg)
    warm = time.perf_counter() - t0
    rot, tdir = twoview_errors(res, centers)
    if rot > TWOVIEW_ROT_TOL_DEG or tdir > TWOVIEW_TDIR_TOL_DEG:
        raise AssertionError(f"twoview pose: rotation {rot:.3f} deg, "
                             f"translation direction {tdir:.3f} deg")
    print(f"twoview 1024x1024, 512 keypoints: {len(res.matches)} matches, "
          f"{int(res.inliers.sum())} inliers; rotation error {rot:.3f} deg "
          f"(limit {TWOVIEW_ROT_TOL_DEG}), translation direction "
          f"{tdir:.3f} deg (limit {TWOVIEW_TDIR_TOL_DEG}); cold {cold:.2f} "
          f"s, warm {warm:.3f} s")


def phase_headline():
    import bench

    h = bench.bench_ransac_h(reps=5)
    print(f"headline: ransac_homography {h['n_hyp']} hyp x 13 pts, 75 px: "
          f"median {h['median_s'] * 1e3:.3f} ms "
          f"(min {h['min_s'] * 1e3:.3f}, n={h['reps']}) = "
          f"{h['n_hyp'] / h['median_s']:.4g} hyp/s; compile+first "
          f"{h['cold_s']:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card dryrun_multichip")
    args = ap.parse_args(argv)
    # The parity phases compare against JAX's CPU backend in this
    # process; keep it available beside an explicitly chosen platform.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    from ransac_tpu.utils.device import enable_compile_cache

    t_start = time.perf_counter()
    device = phase_device()
    enable_compile_cache()
    if args.devices == 4:
        from __graft_entry__ import dryrun_multichip

        dryrun_multichip(4)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            res, scene = phase_localize(tmp)
            phase_raycast(res, scene)
        phase_twoview()
        phase_headline()
    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
