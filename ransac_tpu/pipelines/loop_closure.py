"""Loop-closure detection + pose-graph construction for incremental SfM.

BASELINE.json names "pose-graph optimization" as a deliverable and the
round-3 SLAM demo measured the exact failure mode it exists to fix:
monocular drift of ~10% of the trajectory with `ba.posegraph` sitting
unused.  This module supplies the missing glue:

- **Covisibility loop detection** (`loop_closure_pairs`): frame pairs
  far apart in time (``|i - j| >= min_gap``) that share many tracks —
  computed from the track table with one vectorized pass (a [F, T]
  incidence matmul), no per-pair Python scans.
- **Drift-free relative-similarity measurement** (`closure_edge`): a
  hybrid Sim(3) estimator — rotation from essential-RANSAC on the
  pair's own pixel matches, relative scale from robust pairwise-distance
  ratios between matched region-local 3-D points, translation from
  component medians (see `closure_edge` for the measured failure modes
  of the two earlier designs this replaces).
- **Pose-graph assembly** (`build_pose_graph`): odometry edges between
  consecutive registered frames (measured from the incremental
  estimates — locally accurate, globally drifted) plus the closure
  edges, feeding ``ba.posegraph.optimize_pose_graph`` (gauge pinned at
  node 0).
- **Loop fusion**: track-identity merges proved by the closure inlier
  matches, applied to the track table (``apply_pose_graph``) so the
  rebuilt map + global BA enforce the closure via reprojection
  constraints directly.

Reference lineage: the reference's single-image pipeline has no
multi-frame machinery at all; this generalizes its LM pose refinement
(/root/reference/main_v1.py:508) to trajectory-level consistency.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ransac_tpu.ba.posegraph import PoseGraph, PoseGraphSim3, relative
from ransac_tpu.utils.config import RansacConfig
from ransac_tpu.utils.logging import get_logger

log = get_logger("loop_closure")


def loop_closure_pairs(tracks: dict, frames: list[int],
                       min_gap: int = 16, min_shared: int = 24,
                       max_pairs: int = 4) -> list[tuple[int, int]]:
    """Candidate loop pairs from track covisibility.

    Builds the [F, T] binary incidence matrix and takes its Gram matrix
    (shared-track counts for every frame pair) in one matmul; returns up
    to ``max_pairs`` non-adjacent pairs (``j - i >= min_gap``) with at
    least ``min_shared`` shared tracks, greedily keeping pairs that are
    not within ``min_gap / 2`` of an already-chosen one (one closure per
    revisit region is enough for the pose graph)."""
    fidx = {f: k for k, f in enumerate(frames)}
    tids = sorted({t for _, t in tracks})
    tidx = {t: k for k, t in enumerate(tids)}
    inc = np.zeros((len(frames), len(tids)), np.float32)
    for (f, t) in tracks:
        if f in fidx:
            inc[fidx[f], tidx[t]] = 1.0
    shared = inc @ inc.T                                 # [F, F]
    cand = []
    F = len(frames)
    for a in range(F):
        for b in range(a + min_gap, F):
            if shared[a, b] >= min_shared:
                cand.append((int(shared[a, b]), a, b))
    cand.sort(reverse=True)
    chosen: list[tuple[int, int]] = []
    for cnt, a, b in cand:
        if len(chosen) >= max_pairs:
            break
        if any(abs(a - ca) < min_gap // 2 and abs(b - cb) < min_gap // 2
               for ca, cb in chosen):
            continue
        chosen.append((a, b))
        log.info("loop candidate: frames %d-%d share %d tracks",
                 frames[a], frames[b], cnt)
    return [(frames[a], frames[b]) for a, b in chosen]


def detect_closures_appearance(xy, valid, desc, min_gap: int = 16,
                               min_matches: int = 24, stride: int = 2,
                               max_pairs: int = 4, ratio: float = 0.9):
    """Place recognition by brute-force descriptor matching of far frame
    pairs — the consecutive-frame tracker cannot link a circuit's ends
    (no shared track ids survive a full revisit), so closures must be
    found by APPEARANCE.  All candidate pairs (``j - i >= min_gap``,
    both subsampled by ``stride``) run as ONE vmapped mutual-NN batch on
    device (each pair is a [K, K] matmul).  Returns up to
    ``max_pairs`` tuples ``(fi, fj, uv_i [M,2], uv_j [M,2])`` sorted by
    match count, de-duplicated by revisit region."""
    import jax

    from ransac_tpu.features.match import mutual_nn_match

    desc = jnp.asarray(desc)
    valid = jnp.asarray(valid)
    F = int(desc.shape[0])
    cands = [(a, b) for a in range(0, F, stride)
             for b in range(a + min_gap, F, stride)]
    if not cands:
        return []
    ia = jnp.asarray(np.array([a for a, b in cands], np.int32))
    ib = jnp.asarray(np.array([b for a, b in cands], np.int32))

    def pair(a, b):
        mt = mutual_nn_match(desc[a], desc[b], valid[a], valid[b], ratio)
        return mt.idx2, mt.valid

    idx2, mv = jax.jit(jax.vmap(pair))(ia, ib)
    counts = np.asarray(mv.sum(-1))
    idx2 = np.asarray(idx2)
    mv = np.asarray(mv)
    xy = np.asarray(xy)
    order = np.argsort(-counts)
    out = []
    for k in order:
        if counts[k] < min_matches or len(out) >= max_pairs:
            break
        a, b = cands[k]
        if any(abs(a - fa) < min_gap // 2 and abs(b - fb) < min_gap // 2
               for fa, fb, _, _ in out):
            continue
        sel = mv[k].astype(bool)
        uv_i = xy[a][sel]
        uv_j = xy[b][idx2[k][sel]]
        log.info("appearance closure: frames %d-%d, %d matches",
                 a, b, int(counts[k]))
        out.append((a, b, uv_i, uv_j))
    return out


def _region_points(m, tracks, tids, f0: int, window: int,
                   max_px: float = 3.0) -> dict:
    """Triangulate each track in ``tids`` from its registered
    observations WITHIN ``window`` frames of ``f0`` (widest such pair,
    cheirality/reprojection/angle-gated).  Region-local by construction:
    consecutive-frame poses are locally consistent even on a globally
    drifted trajectory, so the recovered points live in the f0 region's
    own map scale — one side of the Sim(3) Horn alignment in
    ``closure_edge``.  Ignores ``m.points`` entirely (a shared track
    spanning the loop must yield DIFFERENT per-region points, that
    difference being exactly the drift the closure measures)."""
    from ransac_tpu.pipelines.sfm import (_cam_center,
                                          _triangulate_pair_gated)

    need = sorted({t for t in tids if t is not None})
    if not need:
        return {}
    need_set = set(need)
    obs_by_track: dict = {}
    for (g, t) in tracks:
        if (t in need_set and g in m.camera_poses
                and abs(g - f0) <= window):
            obs_by_track.setdefault(t, []).append(g)
    centers = {g: _cam_center(m.camera_poses[g])
               for gs in obs_by_track.values() for g in gs}
    # Candidate pairs per track: by descending estimated baseline, up to
    # 3 fallbacks.  A BROKEN pose in the window (observed: an early
    # frame 77x off the median step) fakes the widest baseline and its
    # triangulations fail every gate — the retry with the next-widest
    # pair self-heals around it.
    cand: dict = {}
    for t, gs in obs_by_track.items():
        gs_s = sorted(set(gs))
        if len(gs_s) < 2:
            continue
        C = np.stack([centers[g] for g in gs_s])
        d2 = np.sum((C[:, None] - C[None, :]) ** 2, -1)
        iu = np.triu_indices(len(gs_s), 1)
        order = np.argsort(-d2[iu])
        prs = [tuple(sorted((gs_s[iu[0][k]], gs_s[iu[1][k]])))
               for k in order[:3] if d2[iu][k] > 0]
        if prs:
            cand[t] = prs
    Kj = jnp.asarray(m.K, jnp.float32)
    gate_n = max_px / float(np.asarray(m.K)[0, 0])
    out: dict = {}
    pending = dict(cand)
    for attempt in range(3):
        by_pair: dict = {}
        nxt: dict = {}
        for t, prs in pending.items():
            if attempt < len(prs):
                by_pair.setdefault(prs[attempt], []).append(t)
                nxt[t] = prs
        if not by_pair:
            break
        for (g1, g2), tl in by_pair.items():
            got = _triangulate_pair_gated(
                m, tracks, g1, g2, sorted(tl), Kj, gate_n,
                min_angle_deg=0.5)
            out.update(got)
            for t in got:
                nxt.pop(t, None)
        pending = nxt
    return out


def _pairwise_scale(A: np.ndarray, B: np.ndarray,
                    max_pairs: int = 4000, seed: int = 0):
    """Robust relative scale between two matched 3-D point sets: the
    median of pairwise-distance ratios |B_i - B_j| / |A_i - A_j| over
    random index pairs.  Rotation/translation-independent by
    construction, and far more robust than per-point depth ratios or a
    full Procrustes fit: map depths are ray-consistent but depth-noisy
    (a point can reproject perfectly at its anchor frame while sitting
    anywhere along the ray), which scatters absolute positions but
    cancels in the DISTANCE statistics' median.  Returns (s, mad_log)
    or (None, None) with < 4 usable pairs."""
    n = len(A)
    if n < 3:
        return None, None
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, 1)
    if len(iu[0]) > max_pairs:
        sel = rng.choice(len(iu[0]), max_pairs, replace=False)
        iu = (iu[0][sel], iu[1][sel])
    da = np.linalg.norm(A[iu[0]] - A[iu[1]], axis=1)
    db = np.linalg.norm(B[iu[0]] - B[iu[1]], axis=1)
    ok = (da > 1e-9) & (db > 1e-9)
    if ok.sum() < 4:
        return None, None
    logr = np.log(db[ok] / da[ok])
    med = float(np.median(logr))
    mad = float(np.median(np.abs(logr - med)))
    return float(np.exp(med)), mad


def closure_edge(tracks: dict, m, K, fi: int, fj: int,
                 ransac_cfg: RansacConfig | None = None, seed: int = 17,
                 uv_pair=None, window: int | None = None):
    """Measure the relative similarity Z (j <- i) for a loop pair with a
    HYBRID estimator, each component taken from its best-conditioned
    domain (round-5 design after two measured failures):

    - **Rotation** from essential-matrix RANSAC on the pair's own PIXEL
      correspondences — sub-degree,
      independent of any 3-D noise.  (A point-cloud Procrustes rotation
      was tried first: map depths are ray-consistent but depth-noisy,
      capping its consensus at ~20% on real revisits.)
    - **Relative scale** s = s_j / s_i from the median of pairwise-
      distance ratios between matched region-local 3-D points
      (`_pairwise_scale`) — translation/rotation-independent, robust to
      along-ray depth scatter.  (Per-point depth-ratio medians — the
      round-4 design — disagreed by 20% between same-gap closures and
      made the pose graph WORSE.)
    - **Translation** as the component-wise median of B - s R A over
      the matched 3-D pairs.

    Correspondences come from shared tracks or appearance matches
    (``uv_pair``); each side's 3-D points are region-local (healthy map
    points, else windowed triangulation — `_side_points` below).
    Returns ``(z7 [7], n_inliers, fuse_pairs)`` or ``None``.
    Generalizes the reference's single-image pose machinery
    (/root/reference/main_v1.py:497-512) to trajectory consistency.
    """
    import jax

    from ransac_tpu.models import ransac as ransac_mod
    from ransac_tpu.ops import epipolar
    from ransac_tpu.ops import projection as proj
    from ransac_tpu.ops.rotation import log_so3
    from ransac_tpu.pipelines.sfm import _np_rodrigues

    if uv_pair is None:
        common = sorted(t for t in {t for f, t in tracks if f == fi}
                        if (fj, t) in tracks)
        pairs = [(t, t) for t in common]
        if len(pairs) < 8:
            log.info("closure %d-%d REJECTED: %d matched tracks", fi,
                     fj, len(pairs))
            return None
        x1p = np.stack([tracks[(fi, t)] for t in common])
        x2p = np.stack([tracks[(fj, t)] for t in common])
    else:
        x1p, x2p = uv_pair
        uv2tid_i = {tuple(np.asarray(uv)): t
                    for (f, t), uv in tracks.items() if f == fi}
        uv2tid_j = {tuple(np.asarray(uv)): t
                    for (f, t), uv in tracks.items() if f == fj}
        pairs = [(uv2tid_i.get(tuple(a)), uv2tid_j.get(tuple(b)))
                 for a, b in zip(x1p, x2p)]
        pairs = [(a, b) for a, b in pairs
                 if a is not None and b is not None]
        if len(pairs) < 8 or len(x1p) < 16:
            log.info("closure %d-%d REJECTED: %d matched tracks", fi,
                     fj, len(pairs))
            return None

    # --- rotation: essential RANSAC on the pixel matches.
    Kj = jnp.asarray(K, jnp.float32)
    x1 = proj.normalize_pixels(jnp.asarray(x1p, jnp.float32), Kj)
    x2 = proj.normalize_pixels(jnp.asarray(x2p, jnp.float32), Kj)
    w = jnp.ones(len(x1p), jnp.float32)
    cfg = ransac_cfg or RansacConfig(threshold=4.0, num_hypotheses=4096)
    e_cfg = RansacConfig(
        threshold=(cfg.threshold / float(np.asarray(K)[0, 0])) ** 2,
        num_hypotheses=cfg.num_hypotheses, selection=cfg.selection)
    eres = ransac_mod.ransac_essential(x1, x2, w, e_cfg,
                                       jax.random.key(seed))
    R_e, t_e, X_e, n_e = epipolar.recover_pose(
        eres.model, x1, x2, eres.inlier_mask.astype(jnp.float32))
    if int(n_e) < 10:
        log.info("closure %d-%d REJECTED: %d cheiral essential inliers",
                 fi, fj, int(n_e))
        return None
    R = np.asarray(R_e, np.float64)

    # --- region-local 3-D points per side.
    if window is None:
        window = 8

    def _side_points(tids, f0):
        """Per-track 3-D points for one side, in that side's own
        region-local scale: healthy BA-polished map points (tracks are
        consecutive-frame-local, so a map point IS region-local) with
        windowed triangulation as fallback.  A track SPANNING the loop
        (same tid both sides) must NOT use its map point — the caller
        routes spanning tids through the regional path only."""
        pose = m.camera_poses[f0]
        Ra = _np_rodrigues(pose[:3])
        Kn = np.asarray(K, np.float64)
        out: dict = {}
        rest = []
        for t in {t for t in tids if t is not None}:
            X = m.points.get(t)
            uv_obs = tracks.get((f0, t))
            if X is not None and uv_obs is not None:
                xc = Ra @ X + pose[3:]
                if xc[2] > 1e-6:
                    pr = Kn[:2, :2] @ (xc[:2] / xc[2]) + Kn[:2, 2]
                    if np.linalg.norm(
                            pr - np.asarray(uv_obs, np.float64)) < 4.0:
                        out[t] = X
                        continue
            rest.append(t)
        out.update(_region_points(m, tracks, rest, f0, window))
        return out

    spanning = {a for a, b in pairs if a == b}
    Xi = _side_points([a for a, _ in pairs if a not in spanning], fi)
    Xi.update(_region_points(m, tracks, sorted(spanning), fi, window))
    Xj = _side_points([b for _, b in pairs if b not in spanning], fj)
    Xj.update(_region_points(m, tracks, sorted(spanning), fj, window))
    pose_i = m.camera_poses[fi]
    pose_j = m.camera_poses[fj]
    Ri = _np_rodrigues(pose_i[:3])
    Rj = _np_rodrigues(pose_j[:3])
    A, B, kept = [], [], []
    for a, b in pairs:
        if a not in Xi or b not in Xj:
            continue
        xa = Ri @ Xi[a] + pose_i[3:]
        xb = Rj @ Xj[b] + pose_j[3:]
        if xa[2] <= 1e-6 or xb[2] <= 1e-6:
            continue
        A.append(xa)
        B.append(xb)
        kept.append((a, b))
    if len(A) < 8:
        log.info("closure %d-%d REJECTED: %d/%d region-point pairs",
                 fi, fj, len(A), len(pairs))
        return None
    A = np.stack(A)
    B = np.stack(B)

    # --- scale + translation, robust.
    s, mad_log = _pairwise_scale(A, B, seed=seed)
    if s is None or not (0.02 < s < 50.0) or mad_log > 0.6:
        log.info("closure %d-%d REJECTED: scale %s (mad_log %s, %d "
                 "pairs)", fi, fj, s, mad_log, len(A))
        return None
    # Translation DIRECTION from the essential decomposition (pixel-
    # domain, cheirality-resolved — measured 0.1-deg-accurate rotations
    # come with similarly clean baselines), MAGNITUDE as the robust 1-D
    # median of the residual component along that direction.  A full
    # component-median t = median(B - sRA) was tried first and produced
    # garbage directions: the 3-D pair residuals scatter ALONG THE VIEW
    # RAYS (correlated, non-isotropic), which biases every component,
    # while the along-baseline projection median averages it out.
    t_dir = np.asarray(t_e, np.float64).reshape(3)
    t_dir /= max(np.linalg.norm(t_dir), 1e-12)
    resid = B - s * (A @ R.T)
    t_mag = float(np.median(resid @ t_dir))
    t_vec = t_mag * t_dir
    err = np.linalg.norm(resid - t_vec, axis=1) \
        / np.maximum(np.linalg.norm(B, axis=1), 1e-9)
    inl = err < 0.25
    n = int(inl.sum())
    if n < 6:
        log.info("closure %d-%d REJECTED: %d/%d Sim(3)-consistent "
                 "pairs", fi, fj, n, len(A))
        return None
    t_vec = float(np.median(resid[inl] @ t_dir)) * t_dir

    z7 = np.concatenate([np.asarray(log_so3(jnp.asarray(R)), np.float64),
                         t_vec.astype(np.float64), [np.log(s)]])
    log.info("closure %d-%d: %d essential inliers, %d/%d 3-D pairs "
             "consistent, rel scale %.3f (mad_log %.2f)", fi, fj,
             int(n_e), n, len(A), s, mad_log)
    fuse = [(a, b) for k, (a, b) in enumerate(kept)
            if inl[k] and a != b]
    return z7, n, fuse


def build_pose_graph(m, tracks: dict, K,
                     closure_pairs: list[tuple[int, int]],
                     ransac_cfg: RansacConfig | None = None,
                     loop_weight: float = 2.0, seed: int = 17):
    """Sim(3) pose graph over the registered frames: odometry edges
    between consecutive registered frames (relative similarity measured
    from the incremental SfM estimates, scale 1 — locally consistent,
    globally drifted) + measured Sim(3) loop-closure edges carrying the
    observed relative scale.  Returns ``(graph, frame_list,
    n_loop_edges, fuse_pairs)`` — ``fuse_pairs`` are the track-identity
    merges proved by the accepted closures' inlier matches."""
    frames = sorted(m.camera_poses)
    fidx = {f: k for k, f in enumerate(frames)}
    poses6 = np.stack([m.camera_poses[f] for f in frames])
    poses7 = jnp.asarray(
        np.concatenate([poses6, np.zeros((len(frames), 1))], axis=1),
        jnp.float32)
    ei, ej, ez, ew, esw = [], [], [], [], []
    for a, b in zip(frames[:-1], frames[1:]):
        z = relative(jnp.asarray(poses6[fidx[a]], jnp.float32),
                     jnp.asarray(poses6[fidx[b]], jnp.float32))
        ei.append(fidx[a])
        ej.append(fidx[b])
        ez.append(np.concatenate([np.asarray(z, np.float64), [0.0]]))
        ew.append(1.0)
        # Odometry observes no relative scale (the monocular
        # unobservable); only loop closures carry a measured scale.
        esw.append(0.0)
    n_loop = 0
    fuse_pairs: list[tuple] = []
    for pair in closure_pairs:
        fi, fj = pair[0], pair[1]
        uv_pair = (pair[2], pair[3]) if len(pair) > 2 else None
        if fi not in fidx or fj not in fidx:
            continue
        out = closure_edge(tracks, m, K, fi, fj, ransac_cfg,
                           seed=seed + n_loop, uv_pair=uv_pair)
        if out is None:
            continue
        z7, _n, fuse = out
        fuse_pairs.extend(fuse)
        ei.append(fidx[fi])
        ej.append(fidx[fj])
        ez.append(z7)
        ew.append(loop_weight)
        esw.append(1.0)
        n_loop += 1
    g = PoseGraphSim3(
        poses=poses7,
        edge_i=jnp.asarray(np.array(ei, np.int32)),
        edge_j=jnp.asarray(np.array(ej, np.int32)),
        edge_z=jnp.asarray(np.stack(ez).astype(np.float32)),
        edge_w=jnp.asarray(np.array(ew, np.float32)),
        edge_sw=jnp.asarray(np.array(esw, np.float32)))
    return g, frames, n_loop, fuse_pairs


def fuse_tracks(m, tracks: dict, fuse_pairs) -> int:
    """Merge track identities proved equal by loop-closure inlier
    matches (ORB-SLAM "loop fusion").  Union-find over the pairs; every
    observation of a merged track is rewritten to the root id IN PLACE
    (first observation wins on frame conflicts — a track can only have
    one uv per frame), and merged map points are dropped (the rebuild
    retriangulates the fused track from its now-loop-spanning
    observations).  Returns the number of root groups actually fused."""
    parent: dict = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    n_groups = 0
    for a, b in fuse_pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
            n_groups += 1
    if not n_groups:
        return 0
    moved = [(f, t) for (f, t) in tracks if find(t) != t]
    for (f, t) in moved:
        uv = tracks.pop((f, t))
        key = (f, find(t))
        if key not in tracks:
            tracks[key] = uv
    for t in {t for _, t in moved}:
        m.points.pop(t, None)
    log.info("loop fusion: %d track merges (%d observations rewritten)",
             n_groups, len(moved))
    return n_groups


def apply_pose_graph(m, tracks: dict, K,
                     ransac_cfg: RansacConfig | None = None,
                     min_gap: int = 16, min_shared: int = 24,
                     seed: int = 17, frontend=None) -> int:
    """Detect closures, optimize the pose graph, and write the corrected
    poses back into the map (points are NOT moved here — callers should
    retriangulate / re-run BA from the corrected poses).  Returns the
    number of loop edges used (0 = nothing to do, map untouched).

    ``frontend = (xy, valid, desc)`` enables APPEARANCE-based closure
    detection (descriptor matching of far frame pairs) in addition to
    track covisibility — required whenever the tracker only matches
    consecutive frames, since no track id survives a full revisit."""
    from ransac_tpu.ba.posegraph import (optimize_pose_graph_sim3,
                                         sim3_to_se3)

    frames = sorted(m.camera_poses)
    pairs: list = loop_closure_pairs(tracks, frames, min_gap=min_gap,
                                     min_shared=min_shared)
    if frontend is not None:
        xy, valid, desc = frontend
        app = detect_closures_appearance(
            xy, valid, desc, min_gap=min_gap,
            min_matches=max(min_shared, 16))
        covis = {(a, b) for a, b in pairs}
        for fi, fj, uv_i, uv_j in app:
            if (fi, fj) not in covis:
                pairs.append((fi, fj, uv_i, uv_j))
    if not pairs:
        return 0
    g, frame_list, n_loop, fuse_pairs = build_pose_graph(
        m, tracks, K, pairs, ransac_cfg, seed=seed)
    if n_loop == 0:
        return 0
    # 200 LM iterations: a single-closure 64-node graph measured ~150
    # iterations to converge (the closure's translation rows start 2-3
    # orders above everything else); the graph is tiny, each iteration
    # is microseconds.
    poses_new, cost, iters = optimize_pose_graph_sim3(g, max_iters=200)
    scales = np.exp(np.asarray(poses_new[:, 6], np.float64))
    log.info("pose graph (sim3): %d nodes, %d edges (%d loop), cost "
             "%.4g (%d iters); node scales %.3f..%.3f", len(frame_list),
             int(g.edge_i.shape[0]), n_loop, float(cost), int(iters),
             float(scales.min()), float(scales.max()))
    # Physical plausibility gate on the optimized SCALE FIELD: node
    # scales interpolate the measured closure drifts, so their extremes
    # must not exceed the largest measured |log rel-scale| by more than
    # a margin — a wilder field means the optimizer absorbed odometry
    # noise into scale (measured: a 0.033 node scale against a 1.5x
    # measured closure, which the slot-retention gate downstream did
    # NOT catch because the distorted map stays self-consistent).
    z_logs = np.abs(np.asarray(g.edge_z[:, 6], np.float64))
    sw = np.asarray(g.edge_sw)
    max_meas = float(z_logs[sw >= 1.0].max()) if (sw >= 1.0).any() else 0.0
    if float(np.abs(np.log(scales)).max()) > max_meas + np.log(2.0):
        log.info("pose graph REJECTED: node scale field %.3f..%.3f "
                 "exceeds the measured closure drift bound (max |log z| "
                 "%.3f + ln 2)", float(scales.min()),
                 float(scales.max()), max_meas)
        return 0
    poses_old = {f: np.asarray(m.camera_poses[f], np.float64)
                 for f in frame_list}
    poses_np = np.asarray(sim3_to_se3(poses_new), np.float64)
    new7 = np.asarray(poses_new, np.float64)
    for k, f in enumerate(frame_list):
        m.camera_poses[f] = poses_np[k]
    # Map-point transport (ORB-SLAM CorrectLoop): move every point by
    # its ANCHOR frame's similarity correction, preserving the point's
    # camera-frame coordinates up to the node's scale correction —
    # c_new = c_old / s_anchor under the corrected pose.  This keeps
    # local map structure exactly (a from-scratch retriangulation
    # measured as destructive: it discards the BA-polished multi-view
    # structure and re-derives 2-view depths from whatever pair
    # survives the correction).
    from ransac_tpu.pipelines.sfm import _np_rodrigues

    fidx_new = {f: k for k, f in enumerate(frame_list)}
    anchor: dict = {}
    for (g, t) in tracks:
        if t in m.points and g in fidx_new:
            a = anchor.get(t)
            if a is None or g < a:
                anchor[t] = g
    Rs_new = {f: _np_rodrigues(poses_np[fidx_new[f]][:3])
              for f in set(anchor.values())}
    Rs_old = {f: _np_rodrigues(poses_old[f][:3])
              for f in set(anchor.values())}
    n_moved = 0
    for t, f in anchor.items():
        k = fidx_new[f]
        s_f = float(np.exp(new7[k, 6]))
        c_old = Rs_old[f] @ m.points[t] + poses_old[f][3:]
        # R1 x' + t1/s1 = c_old / s1  ->  x' = R1^T (c_old - t1) / s1
        m.points[t] = Rs_new[f].T @ (c_old - new7[k, 3:6]) / s_f
        n_moved += 1
    log.info("transported %d map points by their anchor-frame Sim(3) "
             "corrections", n_moved)
    # Loop fusion: the closure matches prove track identities across the
    # loop; merging them lets the caller's global BA close the loop
    # through reprojection constraints (far stronger than the measured
    # Sim(3) edges alone).
    fuse_tracks(m, tracks, fuse_pairs)
    return n_loop
