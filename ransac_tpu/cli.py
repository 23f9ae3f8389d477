"""Command-line interface.

The reference has no flag system at all — behavior is selected by editing
``images_info`` dicts and module-level if/elif ladders (SURVEY.md §5).
Subcommands:

    localize    candidate-camera search + PnP pose (+ optional DEM
                geo-inversion and boundary export) — main_v1.py flow
    twoview     detect/match/essential/triangulate on an image pair
    sfm         incremental SfM over a track table
    intrinsics  focal/sensor grid search (testpro-K flow)
    bench       one-line JSON benchmark (same as bench.py)

Run: python -m ransac_tpu.cli <subcommand> --help
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _cmd_calibrate(args):
    """Chessboard calibration pipeline (the reference's calibration-first
    flow, testpro.py:947-956): detect inner corners on each board image,
    run the Zhang + joint-LM calibration, report K / distortion / RMS and
    save an .npz that ``localize --calibration`` consumes."""
    import glob as globmod

    import jax.numpy as jnp
    from PIL import Image

    from ransac_tpu.features.chessboard import find_chessboard_corners
    from ransac_tpu.models.calibration import (calibrate_camera,
                                               checkerboard_object_points)

    paths = sorted(p for pat in args.images for p in globmod.glob(pat))
    if not paths:
        print("error: no images matched", file=sys.stderr)
        return 2
    views, used, size = [], [], None
    for p in paths:
        img = np.asarray(Image.open(p).convert("L"), np.float32)
        if size is None:
            size = img.shape
        found, corners = find_chessboard_corners(img, args.cols, args.rows)
        if not found:
            print(f"  {p}: corners NOT found, skipping")
            continue
        views.append(corners)
        used.append(p)
        print(f"  {p}: {args.cols}x{args.rows} corners found")
    if len(views) < 3:
        print(f"error: only {len(views)} usable views (need >= 3)",
              file=sys.stderr)
        return 2
    obj = checkerboard_object_points(args.cols, args.rows,
                                     args.square_size)
    res = calibrate_camera(jnp.asarray(obj),
                           jnp.asarray(np.stack(views), jnp.float32))
    K = np.asarray(res.K, np.float64)
    dist = np.asarray(res.dist, np.float64)
    print(f"calibrated from {len(views)} views: "
          f"fx={K[0, 0]:.2f} fy={K[1, 1]:.2f} "
          f"cx={K[0, 2]:.2f} cy={K[1, 2]:.2f}")
    print(f"distortion [k1 k2 p1 p2 k3]: "
          + " ".join(f"{d:+.5f}" for d in dist))
    print(f"reprojection RMS: {float(res.rms):.4f} px")
    if args.out:
        np.savez(args.out, K=K, dist=dist, rms=float(res.rms),
                 height=size[0], width=size[1],
                 views=np.array(used))
        print(f"wrote {args.out}")
    return 0


def _apply_calibration(feats, calib_path):
    """Undistort the annotated feature pixels with a saved calibration
    (testpro.py undistorts the whole image before the search,
    testpro.py:954-955; undistorting the annotation coordinates is the
    pipeline-equivalent operation).  Returns the calibrated K."""
    import jax.numpy as jnp

    from ransac_tpu.models.calibration import undistort_points

    d = np.load(calib_path, allow_pickle=True)
    K = np.asarray(d["K"], np.float64)
    dist = np.asarray(d["dist"], np.float64)
    annotated = (np.abs(feats.pixels) > 0).any(axis=1)
    und = np.asarray(undistort_points(
        jnp.asarray(feats.pixels[annotated], jnp.float32),
        jnp.asarray(K, jnp.float32), jnp.asarray(dist, jnp.float32)),
        np.float64)
    shift = float(np.abs(und - feats.pixels[annotated]).max()) \
        if annotated.any() else 0.0
    feats.pixels = feats.pixels.copy()
    feats.pixels[annotated] = und
    print(f"calibration {calib_path}: undistorted "
          f"{int(annotated.sum())} feature pixels "
          f"(max shift {shift:.2f} px)")
    return K


def _cmd_localize(args):
    from ransac_tpu.io.tables import (build_scene, read_camera_locations,
                                      read_points_data)
    from ransac_tpu.io.export import write_location_csv
    from ransac_tpu.pipelines.localize import localize
    from ransac_tpu.utils.config import LocalizeConfig, RansacConfig

    feats = read_points_data(
        args.features, args.pixel_x, args.pixel_y, scale=args.scale,
        z_mode=args.z_mode)
    if getattr(args, "calibration", ""):
        _apply_calibration(feats, args.calibration)
    cams = read_camera_locations(args.cameras,
                                 observer_height=args.observer_height)
    scene = build_scene(feats, cams)
    cfg = LocalizeConfig(
        ransac=RansacConfig(threshold=args.ransacbound),
        grid_code_min=args.grid_code_min,
        min_pnp_inliers=args.min_pnp_inliers)
    res = localize(scene, (args.width, args.height), cfg, seed=args.seed)
    print(f"best location: index {res.best_index} "
          f"grid={scene.grid_codes[res.best_index]} "
          f"utm=({res.best_location_utm[0]:.2f}, "
          f"{res.best_location_utm[1]:.2f}, {res.best_location_utm[2]:.2f})")
    if res.camera_origin_utm is not None:
        print(f"PnP camera origin (UTM): {res.camera_origin_utm}")
    else:
        print("PnP RANSAC failed or insufficient inliers.")
    if args.output:
        out = args.output.replace(".jpg", "_location.csv")
        if not out.endswith(".csv"):
            out += "_location.csv"
        write_location_csv(out, res.scores_rows)
        print(f"wrote {out}")

    if args.report and args.output:
        from ransac_tpu.pipelines.localize import export_best_candidate_report

        img = None
        if args.image and os.path.exists(args.image):
            from PIL import Image

            img = np.asarray(Image.open(args.image))
        # Full table incl. (0,0)-pixel rows: unannotated landmarks are
        # forward-projected into the report (main_v1.py:367-383).
        feats_all = read_points_data(
            args.features, args.pixel_x, args.pixel_y, scale=args.scale,
            z_mode=args.z_mode, keep_unannotated=True)
        export_best_candidate_report(scene, res, args.output, image=img,
                                     all_features=feats_all)
        print(f"wrote accuracies/correlations CSVs + diagnostic PNGs for "
              f"{args.output}")

    if args.viz_pass is not None and args.output:
        # test02.py:468 second pass: re-run the search at a tight
        # ransacbound (5.0 there) and emit the pandas-style dashboards
        # (visualize_accuracies / visualize_correlations /
        # visualize_camera_locations, test02.py:160-203).
        from ransac_tpu import viz
        from ransac_tpu.pipelines.localize import (
            export_best_candidate_report, localize as _localize)

        cfg_viz = LocalizeConfig(
            ransac=RansacConfig(threshold=args.viz_pass),
            grid_code_min=args.grid_code_min,
            min_pnp_inliers=args.min_pnp_inliers)
        res_viz = _localize(scene, (args.width, args.height), cfg_viz,
                            seed=args.seed)
        base = args.output.replace(".jpg", "") + "_viz"
        write_location_csv(base + "_location.csv", res_viz.scores_rows)
        acc_rows, corr_rows = export_best_candidate_report(
            scene, res_viz, base + ".jpg", make_plots=False)
        viz.plot_accuracies(acc_rows, save_to=base + "_accuracies.png")
        viz.plot_correlation_heatmap(corr_rows,
                                     save_to=base + "_correlations.png")
        viz.plot_camera_location_scores(res_viz.scores_rows,
                                        zone=scene.frame.zone,
                                        save_to=base + "_locations.png")
        print(f"wrote tight-threshold viz pass (ransacbound="
              f"{args.viz_pass}) artifacts at {base}_*")

    if args.dem and res.camera_origin_utm is not None:
        from ransac_tpu.io.dem import load_geotiff, resample_to_utm
        from ransac_tpu.io.export import (save_boundary_shapefiles,
                                          write_boundary_csv)
        from ransac_tpu.pipelines.raycast import GeoInverter
        from ransac_tpu.utils.config import RaycastConfig

        dem_ll = load_geotiff(args.dem)
        dem = resample_to_utm(dem_ll, scene.frame, spacing_m=args.dem_spacing)
        origin_local = scene.frame.center(res.camera_origin_utm[None])[0]
        # Reference altitude clamp (main_v1.py:914-915): camera sits
        # 1.5 m above the terrain under its (E, N).
        from ransac_tpu.io.dem import bilinear_sample
        import jax.numpy as jnp_

        z_dem = float(bilinear_sample(
            jnp_.asarray(dem.data), dem.x0, dem.y0, dem.dx, dem.dy,
            jnp_.float32(origin_local[0]), jnp_.float32(origin_local[1])))
        origin_local = np.array([origin_local[0], origin_local[1],
                                 z_dem + 1.5])
        # DEM-bounds sanity check (main_v1.py:921-929).
        from ransac_tpu.io.dem import in_bounds

        if not bool(in_bounds(dem, origin_local[0], origin_local[1])):
            print("camera origin outside DEM coverage; "
                  "skipping geo-inversion")
            return res
        inv = GeoInverter(
            K=res.K, R=res.R, ray_origin=origin_local.astype(np.float64),
            dem=dem, control_pixels=scene.pixels.astype(np.float64),
            control_pos3d=scene.pos3d.astype(np.float64),
            cfg=RaycastConfig())
        if args.json_file:
            data = json.load(open(args.json_file, encoding="utf-8"))
            geo, pix = inv.convert_boundary(data)
            write_boundary_csv("boundary_points_geo.csv", geo, pix)
            save_boundary_shapefiles(
                geo, "output_shapefiles",
                data.get("info", {}).get("name", ""))
            print("wrote boundary_points_geo.csv + output_shapefiles/")
        def answer(px, py):
            utm, hit = inv.pixel_to_geo(np.array([[px, py]]))
            if hit[0]:
                print(f"pixel ({px:.0f},{py:.0f}) -> "
                      f"E={utm[0,0]:.2f} N={utm[0,1]:.2f} z={utm[0,2]:.2f}")
            else:
                print(f"pixel ({px:.0f},{py:.0f}) -> no DEM intersection")

        for q in args.query:
            px, py = (float(v) for v in q.split(","))
            answer(px, py)

        if args.interactive:
            # The reference's REPL (main_v1.py:934-958).
            while True:
                try:
                    line = input("pixel x,y (or 'exit'): ").strip()
                except EOFError:
                    break
                if line.lower() == "exit":
                    break
                parts = line.replace(" ", "").replace("，", ",").split(",")
                if len(parts) != 2:
                    print("format: 755,975")
                    continue
                try:
                    answer(float(parts[0]), float(parts[1]))
                except ValueError as e:
                    print(f"bad input: {e}")
    return res


def _cmd_run(args):
    """Batch driver: a JSON config holding an images_info-style list
    (main_v1.py:975-1013 parity, minus the edit-the-source workflow)."""
    cfg = json.load(open(args.config, encoding="utf-8"))
    jobs = cfg if isinstance(cfg, list) else cfg.get("images", [])
    for job in jobs:
        print(f"=== {job.get('image_name', job.get('output', '?'))} ===")
        ns = argparse.Namespace(
            features=job["features"], cameras=job["camera_locations"],
            pixel_x=job["pixel_x"], pixel_y=job["pixel_y"],
            width=int(job.get("width", 0)), height=int(job.get("height", 0)),
            scale=float(job.get("scale", 1.0)),
            ransacbound=float(job.get("ransacbound", 75.0)),
            grid_code_min=int(job.get("grid_code_min", 0)),
            observer_height=float(job.get("observer_height", 2.0)),
            z_mode=job.get("z_mode", "elevation"),
            output=job.get("output", ""), dem=job.get("dem_file", ""),
            dem_spacing=float(job.get("dem_spacing", 10.0)),
            json_file=job.get("json_file", ""),
            query=job.get("query", []), seed=int(job.get("seed", 0)),
            min_pnp_inliers=int(job.get("min_pnp_inliers", 6)),
            report=bool(job.get("report", False)),
            viz_pass=job.get("viz_pass", None),
            image=job.get("image_name", ""), interactive=False)
        _cmd_localize(ns)


def _cmd_twoview(args):
    from PIL import Image

    from ransac_tpu.pipelines.twoview import two_view_pipeline
    from ransac_tpu.utils.config import TwoViewConfig

    def load(p):
        return np.asarray(Image.open(p).convert("L"), np.float32) / 255.0

    K = np.loadtxt(args.intrinsics).reshape(3, 3) if args.intrinsics else None
    img1, img2 = load(args.image1), load(args.image2)
    if K is None:
        f = 1.2 * max(img1.shape)
        K = np.array([[f, 0, img1.shape[1] / 2],
                      [0, f, img1.shape[0] / 2], [0, 0, 1.0]])
    res = two_view_pipeline(img1, img2, K, TwoViewConfig(
        max_keypoints=args.max_keypoints))
    print(f"matches: {len(res.matches)}  inliers: {int(res.inliers.sum())}  "
          f"cheiral: {res.n_cheiral}")
    print("R:", np.array2string(res.R, precision=4))
    print("t:", np.array2string(res.t, precision=4))
    if args.out:
        np.savez(args.out, **res.__dict__)
        print(f"wrote {args.out}")


def _cmd_sfm(args):
    """Incremental SfM over a track table.

    Track formats: .npz with arrays frame [M], track [M], uv [M,2]; or
    .json mapping "frame,track" -> [u, v].
    """
    from ransac_tpu.pipelines.sfm import incremental_sfm
    from ransac_tpu.ops.rotation import exp_so3
    import jax.numpy as jnp

    if args.demo:
        from ransac_tpu.pipelines.sfm_demo import run_demo

        out = run_demo(frames=args.demo, seed=args.seed, loop=args.loop)
        if args.out:
            import json as _json

            with open(args.out, "w", encoding="utf-8") as fh:
                _json.dump({k: v for k, v in out.items() if k != "report"},
                           fh, indent=1, default=float)
            print(f"wrote {args.out}")
        return 0
    if not args.tracks or not args.intrinsics:
        print("error: --tracks and --intrinsics are required "
              "(or use --demo N)", file=sys.stderr)
        return 2
    if args.tracks.endswith(".npz"):
        d = np.load(args.tracks)
        tracks = {(int(f), int(t)): np.asarray(uv, np.float64)
                  for f, t, uv in zip(d["frame"], d["track"], d["uv"])}
    else:
        raw = json.load(open(args.tracks, encoding="utf-8"))
        tracks = {}
        for k, uv in raw.items():
            f, t = (int(v) for v in k.split(","))
            tracks[(f, t)] = np.asarray(uv, np.float64)
    K = np.loadtxt(args.intrinsics).reshape(3, 3)
    frames = sorted({f for f, _ in tracks})
    m = incremental_sfm(tracks, K, frames, seed=args.seed)
    print(f"registered {len(m.camera_poses)}/{len(frames)} frames, "
          f"{len(m.points)} map points")
    for f in sorted(m.camera_poses):
        p = m.camera_poses[f]
        R = np.asarray(exp_so3(jnp.asarray(p[:3], jnp.float32)))
        C = -R.T @ p[3:]
        print(f"  frame {f}: center=({C[0]:.3f}, {C[1]:.3f}, {C[2]:.3f})")
    if args.out:
        np.savez(
            args.out,
            frames=np.array(sorted(m.camera_poses)),
            poses=np.stack([m.camera_poses[f]
                            for f in sorted(m.camera_poses)]),
            track_ids=np.array(sorted(m.points)),
            points=np.stack([m.points[t] for t in sorted(m.points)]),
        )
        print(f"wrote {args.out}")


def _cmd_intrinsics(args):
    from ransac_tpu.io.tables import read_points_data
    from ransac_tpu.ops.geodesy import SceneFrame
    from ransac_tpu.pipelines.intrinsics_search import search_intrinsics

    feats = read_points_data(args.features, args.pixel_x, args.pixel_y)
    frame = SceneFrame.from_points(feats.pos3d_utm)
    X = frame.center(feats.pos3d_utm).astype(np.float64)
    known = None
    if args.known_origin:
        e, n, z = (float(v) for v in args.known_origin.split(","))
        known = frame.center(np.array([[e, n, z]]))[0].astype(np.float64)
    res = search_intrinsics(X, feats.pixels, (args.width, args.height),
                            known_origin=known,
                            rank_by="dist" if known is not None else "err")
    print(f"{'rank':>4} {'f(mm)':>6} {'sensor':>10} {'err(px)':>8} "
          f"{'inl':>4} {'dist(m)':>9}")
    for i, c in enumerate(res.candidates[:5]):
        print(f"{i+1:4d} {c.focal_mm:6.0f} {str(c.sensor_mm):>10} "
              f"{c.mean_err_px:8.2f} {c.n_inliers:4d} {c.dist_to_known:9.1f}")
    print(f"refined mean reprojection error: {res.refined_mean_err_px:.2f} px")


def _cmd_bench(args):
    import bench

    bench.main()


def _run_scaling():
    from ransac_tpu.utils.scaling import (
        measure_frontend_scaling, measure_scaling, report)

    pts = measure_scaling()
    print(report(pts))
    print("# keyframe front end (weak scaling over mesh data axis)")
    print(report(measure_frontend_scaling(), unit="frames/s"))


def _cmd_profile(args):
    """Roofline report for the hot kernels against the device's published
    peaks (BASELINE.md deliverable: 'SoL utilization per chip')."""
    import jax
    import jax.numpy as jnp

    if getattr(args, "scaling_only", False):
        return _run_scaling()

    from ransac_tpu.ops import homography as hops
    from ransac_tpu.utils.profiling import SolProfiler

    prof = SolProfiler()
    rng = np.random.default_rng(0)
    n, H = 13, args.hypotheses

    def bench_entry(name, step_scalar, **kw):
        """Time one row; a row that fails (e.g. out of device memory at
        an aggressive H) is reported and skipped so the rest of the table
        still lands."""
        try:
            prof.measure(name, jax.jit(step_scalar), jnp.int32(0), **kw)
        except Exception as e:  # pragma: no cover - hardware-dependent
            print(f"# {name}: FAILED ({type(e).__name__}): "
                  f"{str(e)[:200]}", file=sys.stderr)

    src = jnp.asarray(rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32))
    dst = jnp.asarray(rng.uniform(0, 1000, (n, 2)).astype(np.float32))

    def solve(seed):
        i = jax.random.randint(jax.random.key(seed), (H, 4), 0, n)
        Hm, ok = jax.vmap(hops.dlt_homography_minimal)(src[i], dst[i])
        return ok.sum().astype(jnp.float32) + Hm[0, 0, 0] * 1e-6

    bench_entry("dlt_minimal_solve", solve,
                flops=H * 700, bytes_moved=H * (32 + 36 + 4))

    # Matching (BASELINE.md: "BA/matching kernel SoL"): batched
    # mutual-NN over descriptor matmuls.
    from ransac_tpu.features.match import mutual_nn_match

    B, Kp, D = 16, 1024, 64
    valid = jnp.ones((B, Kp), bool)

    def match(seed):
        k1, k2 = jax.random.split(jax.random.key(seed))
        d1 = jax.random.normal(k1, (B, Kp, D), jnp.float32)
        d2 = jax.random.normal(k2, (B, Kp, D), jnp.float32)
        m = jax.vmap(mutual_nn_match)(d1, d2, valid, valid)
        return jnp.sum(m.idx2).astype(jnp.float32)

    bench_entry("mutual_nn_match", match,
                flops=B * 2 * Kp * Kp * D, bytes_moved=B * 2 * Kp * D * 4,
                unit="tf32")

    from ransac_tpu.features.detect import harris_response

    def harris_seeded(seed):
        img = jax.random.uniform(jax.random.key(seed), (1024, 1024),
                                 jnp.float32)
        return jnp.sum(harris_response(img))

    bench_entry("harris_response_1024", harris_seeded,
                flops=1024 * 1024 * 400, bytes_moved=1024 * 1024 * 4 * 6,
                unit="tf32")

    # Whole two-view frame step as ONE jitted program (BASELINE.md
    # "frames/s at 1 chip"): detect -> describe -> match -> essential
    # RANSAC -> pose recovery + LM polish.
    from ransac_tpu.features.detect import detect_harris
    from ransac_tpu.features.match import patch_descriptors
    from ransac_tpu.models import ransac as ransac_mod
    from ransac_tpu.ops import epipolar
    from ransac_tpu.ops import projection as oproj
    from ransac_tpu.utils.config import RansacConfig

    Kc = jnp.asarray([[600.0, 0, 512], [0, 600.0, 512], [0, 0, 1.0]],
                     jnp.float32)
    e_cfg = RansacConfig(threshold=(2.0 / 600.0) ** 2,
                         num_hypotheses=4096, exhaustive=False)

    def twoview_frame(seed):
        key = jax.random.key(seed)
        ki1, ki2, kr = jax.random.split(key, 3)
        img1 = jax.random.uniform(ki1, (1024, 1024), jnp.float32)
        img2 = jax.random.uniform(ki2, (1024, 1024), jnp.float32)
        kp1 = detect_harris(img1, 512)
        kp2 = detect_harris(img2, 512)
        d1 = patch_descriptors(img1, kp1.xy, kp1.valid)
        d2 = patch_descriptors(img2, kp2.xy, kp2.valid)
        m = mutual_nn_match(d1, d2, kp1.valid, kp2.valid)
        x1 = oproj.normalize_pixels(kp1.xy[m.idx1], Kc)
        x2 = oproj.normalize_pixels(kp2.xy[m.idx2], Kc)
        mask = m.valid.astype(jnp.float32)
        res = ransac_mod.ransac_essential(x1, x2, mask, e_cfg, kr)
        inl_w = res.inlier_mask.astype(jnp.float32)
        R0, t0, _, _ = epipolar.recover_pose(res.model, x1, x2, inl_w)
        R, t, _ = epipolar.refine_relative_pose(R0, t0, x1, x2, inl_w)
        return (res.num_inliers.astype(jnp.float32) + t[0] * 1e-6
                + R[0, 0] * 1e-6)

    bench_entry(
        "twoview_frame_1024", twoview_frame,
        flops=2 * 1024 * 1024 * 400 + 4096 * 5200,
        bytes_moved=2 * 1024 * 1024 * 4 * 6)
    if prof.reports and prof.reports[-1].name == "twoview_frame_1024":
        print(f"# twoview frames/s (1 device): "
              f"{1.0 / prof.reports[-1].seconds:.1f}")

    print(prof.table())
    if args.out:
        import json as jsonmod

        with open(args.out, "w") as f:
            jsonmod.dump([r.row() for r in prof.reports], f, indent=1)
        print(f"wrote {args.out}")

    if args.scaling:
        _run_scaling()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ransac_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("localize", help="candidate search + PnP (+DEM)")
    p.add_argument("--features", required=True)
    p.add_argument("--cameras", required=True)
    p.add_argument("--pixel-x", dest="pixel_x", required=True)
    p.add_argument("--pixel-y", dest="pixel_y", required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--ransacbound", type=float, default=75.0)
    p.add_argument("--grid-code-min", dest="grid_code_min", type=int, default=0)
    p.add_argument("--observer-height", type=float, default=2.0)
    p.add_argument("--z-mode", dest="z_mode", default="elevation",
                   choices=["elevation", "height_plus_elevation"])
    p.add_argument("--calibration", default="",
                   help=".npz from `calibrate`: undistorts the annotated "
                        "feature pixels before the search (the "
                        "reference's calibration-first flow, "
                        "testpro.py:947-956)")
    p.add_argument("--min-pnp-inliers", dest="min_pnp_inliers", type=int,
                   default=6, help="PnP inlier guard (main_v1.py:504)")
    p.add_argument("--output", default="")
    p.add_argument("--dem", default="")
    p.add_argument("--dem-spacing", type=float, default=10.0)
    p.add_argument("--json-file", default="")
    p.add_argument("--query", nargs="*", default=[],
                   help="pixel queries 'x,y' for geo-inversion")
    p.add_argument("--interactive", action="store_true",
                   help="REPL for pixel->geo queries (needs --dem)")
    p.add_argument("--report", action="store_true",
                   help="write accuracies/correlations CSVs + plots")
    p.add_argument("--viz-pass", dest="viz_pass", type=float, default=None,
                   help="re-run the search at this tight ransacbound and "
                        "emit the pandas-style dashboards "
                        "(test02.py:468 uses 5.0)")
    p.add_argument("--image", default="", help="image path for the report")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_localize)

    p = sub.add_parser("run", help="batch config runner (images_info JSON)")
    p.add_argument("--config", required=True)
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("twoview", help="two-view pipeline on an image pair")
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--intrinsics", default="", help="3x3 K txt file")
    p.add_argument("--max-keypoints", type=int, default=1024)
    p.add_argument("--out", default="")
    p.set_defaults(fn=_cmd_twoview)

    p = sub.add_parser("sfm", help="incremental SfM over a track table")
    p.add_argument("--tracks", default="", help=".npz or .json tracks")
    p.add_argument("--intrinsics", default="", help="3x3 K txt file")
    p.add_argument("--demo", type=int, default=0, metavar="F",
                   help="run the end-to-end multi-frame SLAM demo on F "
                        "synthetic frames (sharded frontend -> tracks -> "
                        "SfM -> CG-BA) and print the frames/s table")
    p.add_argument("--loop", action="store_true",
                   help="with --demo: closed-circuit trajectory + loop-"
                        "closure detection + pose-graph optimization; "
                        "prints ATE with/without the pose graph")
    p.add_argument("--out", default="")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_sfm)

    p = sub.add_parser("calibrate",
                       help="chessboard camera calibration (Zhang + LM)")
    p.add_argument("--images", nargs="+", required=True,
                   help="board image paths/globs")
    p.add_argument("--cols", type=int, default=9,
                   help="inner corners per row (reference board: 9)")
    p.add_argument("--rows", type=int, default=6,
                   help="inner corners per column (reference board: 6)")
    p.add_argument("--square-size", dest="square_size", type=float,
                   default=1.0, help="board square edge length")
    p.add_argument("--out", default="", help="output .npz (K, dist, rms)")
    p.set_defaults(fn=_cmd_calibrate)

    p = sub.add_parser("intrinsics", help="focal/sensor grid search")
    p.add_argument("--features", required=True)
    p.add_argument("--pixel-x", dest="pixel_x", required=True)
    p.add_argument("--pixel-y", dest="pixel_y", required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--known-origin", default="", help="'E,N,z' UTM")
    p.set_defaults(fn=_cmd_intrinsics)

    p = sub.add_parser("bench", help="one-line JSON benchmark")
    p.set_defaults(fn=_cmd_bench)

    p = sub.add_parser("profile", help="speed-of-light kernel report")
    p.add_argument("--hypotheses", type=int, default=1 << 20)
    p.add_argument("--out", default="")
    p.add_argument("--scaling", action="store_true",
                   help="also run the multi-device scaling harness")
    p.add_argument("--scaling-only", action="store_true",
                   help="skip the kernel table (scaling harness only)")
    p.set_defaults(fn=_cmd_profile)

    args = ap.parse_args(argv)
    from ransac_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
