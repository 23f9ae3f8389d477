"""DEM ray-cast geo-inversion: pixel -> ground coordinates.

Replaces the reference's scalar REPL path (``/root/reference/main_v1.py:
547-684``): per query pixel it builds one ray, then marches it 1 m at a
time, calling PROJ + scipy interpolation from Python on EVERY step (hot
loop #4, SURVEY.md §3.1) — the slowest interactive path in the reference.

Here all query pixels march in lockstep inside one ``lax.while_loop`` over
a [R,3] position tensor with a per-ray done mask, sampling a pre-warped
scene-centered UTM DEM with a fused bilinear gather — zero host round-trips
and zero in-loop geodesy.  Both of the reference's ray-correction modes are
implemented:

- weighted optimization factors (main_v1.py:577-632): per-control-point
  componentwise ideal/computed direction ratios, |f|>2 outlier filter,
  inverse-distance weights capped at ``max_weight`` with the nearest
  control point boosted ``knn_weight``x, z-component correction;
- per-axis least-squares scales (test_pro.py:645-680) via the shared LM
  core (``ops.lm.fit_ray_scales``).

The reference's >=150-step hit warmup (main_v1.py:650) is reproduced via
``RaycastConfig.min_hit_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ransac_tpu.io.dem import (DemUtm, bilinear_sample,
                               bilinear_sample_packed, pack_bilinear)
from ransac_tpu.ops import projection as proj
from ransac_tpu.ops.lm import fit_ray_scales
from ransac_tpu.utils.config import RaycastConfig


# ------------------------------------------------------------ corrections
def calculate_weights(query_pixels: jnp.ndarray, control_pixels: jnp.ndarray,
                      max_weight: float = 1.0, knn_weight: float = 10.0):
    """Batched main_v1.py:577-596: weights [R, C] — inverse pixel distance
    capped at max_weight, nearest control point boosted knn_weight x."""
    d = jnp.linalg.norm(
        query_pixels[:, None, :] - control_pixels[None, :, :], axis=-1)
    w = jnp.minimum(jnp.where(d == 0.0, 1.0, 1.0 / jnp.where(d == 0, 1.0, d)),
                    max_weight)
    nearest = jnp.argmin(d, axis=1)
    boost = jax.nn.one_hot(nearest, control_pixels.shape[0], dtype=w.dtype)
    return w * (1.0 + (knn_weight - 1.0) * boost)


def compute_optimization_factors(
    control_pixels: jnp.ndarray,   # [C,2]
    control_pos3d: jnp.ndarray,    # [C,3] centered UTM
    K: jnp.ndarray, R: jnp.ndarray, ray_origin: jnp.ndarray,
    factor_abs_max: float = 2.0,
):
    """Batched main_v1.py:599-625.  Returns (factors [C,3], valid [C]) —
    componentwise ideal/computed ray ratios; |f| > factor_abs_max rows are
    filtered (valid=False) exactly like the reference's continue."""
    ideal = control_pos3d - ray_origin[None, :]
    norm = jnp.linalg.norm(ideal, axis=-1, keepdims=True)
    valid = norm[:, 0] > 0
    ideal = ideal / jnp.where(norm > 0, norm, 1.0)
    rays = proj.pixel_to_ray(control_pixels, K, R)
    factors = ideal / jnp.where(jnp.abs(rays) < 1e-12, 1e-12, rays)
    valid = valid & jnp.all(jnp.abs(factors) <= factor_abs_max, axis=-1)
    return factors, valid


def weighted_factors(factors: jnp.ndarray, valid: jnp.ndarray,
                     weights: jnp.ndarray):
    """Batched main_v1.py:627-632 over query rows: weights [R,C] x factors
    [C,3] -> [R,3] normalized weighted mean over valid control points."""
    w = weights * valid[None, :].astype(weights.dtype)
    wsum = jnp.maximum(w.sum(-1, keepdims=True), 1e-12)
    return (w[..., None] * factors[None, :, :]).sum(1) / wsum


# ------------------------------------------------------------ ray march
@partial(jax.jit,
         static_argnames=("max_steps", "min_hit_step", "step", "chunk"))
def march_rays(
    origins: jnp.ndarray,      # [R,3] centered UTM
    directions: jnp.ndarray,   # [R,3] unit
    dem_data: jnp.ndarray, x0, y0, dx, dy,
    max_steps: int, step: float = 1.0, min_hit_step: int = 150,
    chunk: int = 64, dem_pack: jnp.ndarray | None = None,
):
    """Lockstep batched ray march.  Returns (hits [R,3], hit_mask [R]).
    ``dem_pack`` (from :func:`ransac_tpu.io.dem.pack_bilinear`) routes DEM
    sampling through one-row-gather quad-packed bilinear.

    Termination per ray: z <= DEM(x, y) after >= min_hit_step steps (the
    reference warmup quirk, main_v1.py:650), or leaving the DEM footprint,
    or max_steps.  Instead of one tiny gather per 1 m step (the reference
    does one PROJ FFI call + scipy interpolation per step, main_v1.py:
    638-656), each while_loop iteration evaluates ``chunk`` future steps of
    every active ray in a single [R*chunk] bilinear gather and resolves the
    first crossing in the chunk — same step-0..max_steps-1 semantics, 1/chunk
    the trip count, and gathers big enough to saturate the memory system.
    Early-exits when every ray is done.
    """
    n = origins.shape[0]
    h, w = dem_data.shape
    xmax = x0 + dx * (w - 1)
    ymax = y0 + dy * (h - 1)
    if dem_pack is None:
        _sample = lambda xs, ys: bilinear_sample(  # noqa: E731
            dem_data, x0, y0, dx, dy, xs, ys)
    else:
        _sample = lambda xs, ys: bilinear_sample_packed(  # noqa: E731
            dem_pack, h, w, x0, y0, dx, dy, xs, ys)
    ks = jnp.arange(chunk, dtype=origins.dtype)        # relative step ids

    def cond(state):
        i, pos, done, hit = state
        return (i < max_steps) & jnp.logical_not(jnp.all(done))

    def body(state):
        i, pos, done, hit = state
        # Candidate positions for global steps i..i+chunk-1 (active rays
        # carry pos == origin + i*step*dir, so P[:, k] is step i+k).
        P = pos[:, None, :] + (step * ks)[None, :, None] * directions[:, None, :]
        z_dem = _sample(
            P[..., 0].reshape(-1), P[..., 1].reshape(-1)).reshape(n, chunk)
        inside = ((P[..., 0] >= x0) & (P[..., 0] <= xmax)
                  & (P[..., 1] >= y0) & (P[..., 1] <= ymax))
        gstep = i + jnp.arange(chunk)                  # [chunk] global ids
        in_budget = gstep < max_steps
        hit_k = ((gstep >= min_hit_step)[None, :] & (P[..., 2] <= z_dem)
                 & inside & in_budget[None, :])
        stop_k = (hit_k | ~inside) & in_budget[None, :]
        any_stop = stop_k.any(axis=1) & ~done
        first = jnp.argmax(stop_k, axis=1)             # first stop in chunk
        first_is_hit = jnp.take_along_axis(hit_k, first[:, None], 1)[:, 0]
        stop_pos = jnp.take_along_axis(P, first[:, None, None], 1)[:, 0, :]
        adv = jnp.minimum(jnp.asarray(chunk), max_steps - i)
        adv_pos = pos + (adv * step) * directions
        new_pos = jnp.where(done[:, None], pos,
                            jnp.where(any_stop[:, None], stop_pos, adv_pos))
        hit = hit | (any_stop & first_is_hit)
        done = done | any_stop
        return i + chunk, new_pos, done, hit

    i0 = jnp.asarray(0)
    done0 = jnp.zeros(n, bool)
    hit0 = jnp.zeros(n, bool)
    _, pos, done, hit = jax.lax.while_loop(
        cond, body, (i0, origins, done0, hit0))
    return pos, hit



def _mip_setup(dem_data, dem_pack, x0, y0, dx, dy, pool, pool2,
               lookahead, lookahead2, seg_steps, step):
    """Shared setup for the coarse-to-fine march: bilinear sampler +
    dilated pooled-max mip tables (see march_rays_mip docstring)."""
    h, w = dem_data.shape
    xmax = x0 + dx * (w - 1)
    ymax = y0 + dy * (h - 1)
    if dem_pack is None:
        _sample = lambda xs, ys: bilinear_sample(  # noqa: E731
            dem_data, x0, y0, dx, dy, xs, ys)
    else:
        _sample = lambda xs, ys: bilinear_sample_packed(  # noqa: E731
            dem_pack, h, w, x0, y0, dx, dy, xs, ys)

    # Pooled-max mip, padded with -inf, 3x3-dilated.
    def build_mip(p):
        hb = -(-h // p)
        wb = -(-w // p)
        padded = jnp.full((hb * p, wb * p), -jnp.inf,
                          dem_data.dtype).at[:h, :w].set(dem_data)
        pooled = padded.reshape(hb, p, wb, p).max(axis=(1, 3))
        pp = jnp.pad(pooled, 1, constant_values=-jnp.inf)
        dil = pp[1:-1, 1:-1]
        for ro in (-1, 0, 1):
            for co in (-1, 0, 1):
                dil = jnp.maximum(
                    dil, pp[1 + ro:1 + ro + hb, 1 + co:1 + co + wb])
        return dil.reshape(-1), hb, wb

    pooled_flat, hb, wb = build_mip(pool)
    l1 = (pooled_flat, hb, wb, pool * dx, pool * dy)
    l2 = None
    if pool2 > 0:
        pooled2_flat, hb2, wb2 = build_mip(pool2)
        l2 = (pooled2_flat, hb2, wb2, pool2 * dx, pool2 * dy,
              jnp.arange(lookahead2, dtype=jnp.float32),
              lookahead * seg_steps * step)
    return _sample, l1, l2, (x0, y0, xmax, ymax)


def _mip_machine(origins, directions, _sample, l1, l2, geom,
                 max_steps, step, min_hit_step, seg_steps, lookahead,
                 lookahead2):
    """Builds the (cond, body) pair of the coarse-to-fine march
    while_loop for THESE rays — shared by ``march_rays_mip`` (one loop
    over all rays) and ``march_rays_mip_compact`` (staged loops over
    shrinking active sets).  State: (allclear, i, done, hit, istop)."""
    n = origins.shape[0]
    pooled_flat, hb, wb, bx_size, by_size = l1
    x0, y0, xmax, ymax = geom
    seg_len = seg_steps * step
    ks = jnp.arange(lookahead, dtype=jnp.float32)      # segment ids
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dxr, dyr, dzr = directions[:, 0], directions[:, 1], directions[:, 2]
    if l2 is not None:
        pooled2_flat, hb2, wb2, b2x_size, b2y_size, ks2, seg2_len = l2

    def cond(state):
        allclear, i, done, hit, istop = state
        return jnp.logical_not(jnp.all(done))

    def body(state):
        allclear, i, done, hit, istop = state

        def outside(t):
            px = ox[:, None] + t * dxr[:, None]
            py = oy[:, None] + t * dyr[:, None]
            return ((px < x0) | (px > xmax) | (py < y0) | (py > ymax))

        if l2 is not None:
            # ---- level-2 scan: lookahead2 super-segments of seg2_len,
            # active only once the fast hits have resolved (see doc).
            def l2_scan(i):
                t2 = (i.astype(jnp.float32) * step)[:, None] \
                    + ks2[None, :] * seg2_len             # [R,K2]
                t2e = t2 + seg2_len
                t2m = t2 + 0.5 * seg2_len
                m2x = ox[:, None] + t2m * dxr[:, None]
                m2y = oy[:, None] + t2m * dyr[:, None]
                b2xi = jnp.clip(((m2x - x0) / b2x_size).astype(jnp.int32),
                                0, wb2 - 1)
                b2yi = jnp.clip(((m2y - y0) / b2y_size).astype(jnp.int32),
                                0, hb2 - 1)
                zmax2 = jnp.take(pooled2_flat, b2yi * wb2 + b2xi)
                z2s = oz[:, None] + t2 * dzr[:, None]
                z2e = oz[:, None] + t2e * dzr[:, None]
                susp2 = ((jnp.minimum(z2s, z2e) <= zmax2)
                         | outside(t2) | outside(t2e))
                fs2 = jnp.where(susp2.any(axis=1),
                                jnp.argmax(susp2, axis=1),
                                jnp.int32(lookahead2))
                return i + fs2 * (lookahead * seg_steps)

            i = jax.lax.cond(allclear, l2_scan, lambda i: i, i)
        t0 = i.astype(jnp.float32) * step                 # [R] arc length

        # ---- coarse scan: lookahead segments [t0 + k*seg, ...]
        t_start = t0[:, None] + ks[None, :] * seg_len     # [R,KC]
        t_end = t_start + seg_len
        t_mid = t_start + 0.5 * seg_len
        mx = ox[:, None] + t_mid * dxr[:, None]
        my = oy[:, None] + t_mid * dyr[:, None]
        bxi = jnp.clip(((mx - x0) / bx_size).astype(jnp.int32), 0, wb - 1)
        byi = jnp.clip(((my - y0) / by_size).astype(jnp.int32), 0, hb - 1)
        zmax_seg = jnp.take(pooled_flat, byi * wb + bxi)  # [R,KC]
        z_s = oz[:, None] + t_start * dzr[:, None]
        z_e = oz[:, None] + t_end * dzr[:, None]
        zmin_seg = jnp.minimum(z_s, z_e)

        suspicious = ((zmin_seg <= zmax_seg)
                      | outside(t_start) | outside(t_end))
        any_susp = suspicious.any(axis=1)
        allclear = jnp.logical_not(jnp.any(any_susp & ~done))
        fs = jnp.where(any_susp,
                       jnp.argmax(suspicious, axis=1),
                       jnp.int32(lookahead))              # segments skipped
        i_skip = i + fs * seg_steps

        # ---- fine scan: seg_steps exact steps from i_skip
        g = i_skip[:, None] + jnp.arange(seg_steps)[None, :]  # [R,S] global
        t = g.astype(jnp.float32) * step
        px = ox[:, None] + t * dxr[:, None]
        py = oy[:, None] + t * dyr[:, None]
        pz = oz[:, None] + t * dzr[:, None]
        z_dem = _sample(px.reshape(-1), py.reshape(-1)).reshape(
            n, seg_steps)
        inside = (px >= x0) & (px <= xmax) & (py >= y0) & (py <= ymax)
        in_budget = g < max_steps
        hit_k = ((g >= min_hit_step) & (pz <= z_dem) & inside & in_budget)
        stop_k = (hit_k | ~inside) & in_budget
        any_stop = stop_k.any(axis=1) & ~done
        first = jnp.argmax(stop_k, axis=1)
        first_is_hit = jnp.take_along_axis(hit_k, first[:, None], 1)[:, 0]

        i_next = jnp.minimum(i_skip + seg_steps, max_steps)
        new_i = jnp.where(done, i, jnp.where(any_stop, i_skip + first,
                                             i_next))
        hit = hit | (any_stop & first_is_hit)
        istop = jnp.where(done, istop, jnp.where(any_stop, i_skip + first,
                                                 i_next))
        done = done | any_stop | (new_i >= max_steps)
        return allclear, new_i, done, hit, istop

    return cond, body


@partial(jax.jit, static_argnames=(
    "max_steps", "min_hit_step", "step", "pool", "seg_steps", "lookahead",
    "pool2", "lookahead2"))
def march_rays_mip(
    origins: jnp.ndarray,      # [R,3] centered UTM
    directions: jnp.ndarray,   # [R,3] unit
    dem_data: jnp.ndarray, x0, y0, dx, dy,
    max_steps: int, step: float = 1.0, min_hit_step: int = 150,
    pool: int = 8, seg_steps: int = 32, lookahead: int = 32,
    dem_pack: jnp.ndarray | None = None,
    pool2: int = 0, lookahead2: int = 16,
):
    """Coarse-to-fine (max-mipmap) batched ray march — same semantics as
    :func:`march_rays`, far fewer DEM samples.

    A pooled-max mip of the DEM (``pool`` x ``pool`` cells, 3x3-block
    dilated so it upper-bounds every bilinear sample whose query falls in
    the block) lets whole ray segments be skipped with one nearest-
    neighbor lookup: a segment [s, s+seg_steps*step] cannot contain a
    z <= DEM crossing if min(z_start, z_end) > pooled_max(mid).  Each
    while_loop trip per ray: scan ``lookahead`` segments coarsely (one
    [R, lookahead] gather of the mip), jump to the first suspicious one,
    then fine-scan its ``seg_steps`` steps exactly like march_rays.  Empty
    sky costs lookahead+seg_steps samples per lookahead*seg_steps steps
    instead of one bilinear sample per step.

    Caller must ensure ``seg_steps * step <= pool * min(dx, dy)`` (the
    dilation's coverage guarantee); ``GeoInverter`` computes a valid
    ``seg_steps`` from the DEM spacing.  Positions are exact
    ``origin + i*step*dir`` (no accumulation drift).

    ``pool2 > 0`` enables a SECOND mip level (round-3, VERDICT r2
    next-steps #8): each trip first scans ``lookahead2`` super-segments
    of ``lookahead * seg_steps`` steps against a ``pool2``-cell dilated
    max mip and jumps to the first suspicious one, so empty sky advances
    up to ``lookahead2 * lookahead * seg_steps`` steps per trip.
    On the accelerator this was first built for it sped all-sky batches
    up several-fold over the single-level march but cost ~27% on
    batches with rays inside the terrain relief band — so the L2 scan
    self-activates (``lax.cond`` on a scalar carry) only
    while the PREVIOUS trip found every active ray's whole level-1
    window clear: the pure-sky regime where super-skips help, and
    exactly zero overhead otherwise.
    Requires ``lookahead * seg_steps * step <= pool2 * min(dx, dy)``
    (same coverage argument, one level up); ``GeoInverter`` picks a
    valid ``pool2`` automatically.
    """
    n = origins.shape[0]
    _sample, l1, l2, geom = _mip_setup(
        dem_data, dem_pack, x0, y0, dx, dy, pool, pool2, lookahead,
        lookahead2, seg_steps, step)
    cond, body = _mip_machine(
        origins, directions, _sample, l1, l2, geom, max_steps, step,
        min_hit_step, seg_steps, lookahead, lookahead2)

    i0 = jnp.zeros(n, jnp.int32)
    done0 = jnp.zeros(n, bool)
    hit0 = jnp.zeros(n, bool)
    istop0 = jnp.full((n,), max_steps, jnp.int32)
    _, _, done, hit, istop = jax.lax.while_loop(
        cond, body, (jnp.bool_(False), i0, done0, hit0, istop0))
    t_stop = istop.astype(jnp.float32) * step
    pos = origins + t_stop[:, None] * directions
    return pos, hit


@partial(jax.jit, static_argnames=(
    "max_steps", "min_hit_step", "step", "pool", "seg_steps", "lookahead",
    "pool2", "lookahead2", "stages"))
def march_rays_mip_compact(
    origins: jnp.ndarray,      # [R,3] centered UTM
    directions: jnp.ndarray,   # [R,3] unit
    dem_data: jnp.ndarray, x0, y0, dx, dy,
    max_steps: int, step: float = 1.0, min_hit_step: int = 150,
    pool: int = 8, seg_steps: int = 32, lookahead: int = 32,
    dem_pack: jnp.ndarray | None = None,
    pool2: int = 0, lookahead2: int = 16,
    stages: tuple = (4, 16),
):
    """Active-ray-compacting coarse-to-fine march — same semantics as
    :func:`march_rays_mip` (VERDICT r3 #7).

    The lockstep march makes EVERY ray pay every while-trip until the
    slowest ray finishes: on mixed scenes most rays hit terrain within a
    few hundred steps while a minority (sky / grazing) churn the full
    budget, so the batch runs at the stragglers' pace at full width.
    This variant runs STAGED while_loops entirely on device (no host
    round-trips):
    stage k exits early once the active count fits the next static
    bucket ``R / stages[k]``; a stable argsort on ``done`` then packs
    the active rays to the front, a static slice drops the finished
    majority, and the next stage marches only the stragglers at 1/4,
    1/16, ... of the original width.  Results scatter back through the
    carried original-index array.  All-sky batches (nothing resolves
    early) simply run stage 0 to completion — zero overhead beyond the
    cheap final sorts of an all-done batch."""
    n = origins.shape[0]
    _sample, l1, l2, geom = _mip_setup(
        dem_data, dem_pack, x0, y0, dx, dy, pool, pool2, lookahead,
        lookahead2, seg_steps, step)

    sizes = [n] + [max(-(-n // s), 1) for s in stages]
    # Full-size accumulators (scattered into at stage boundaries).
    hit_full = jnp.zeros(n, bool)
    istop_full = jnp.full((n,), max_steps, jnp.int32)

    orig = jnp.arange(n, dtype=jnp.int32)
    cur_o, cur_d = origins, directions
    cur_i = jnp.zeros(n, jnp.int32)
    cur_done = jnp.zeros(n, bool)
    cur_hit = jnp.zeros(n, bool)
    cur_istop = jnp.full((n,), max_steps, jnp.int32)

    for k, size in enumerate(sizes):
        nxt = sizes[k + 1] if k + 1 < len(sizes) else 0
        cond0, body = _mip_machine(
            cur_o, cur_d, _sample, l1, l2, geom, max_steps, step,
            min_hit_step, seg_steps, lookahead, lookahead2)

        if nxt > 0:
            def cond(state, _c=cond0, _nxt=nxt):
                allclear, i, done, hit, istop = state
                return _c(state) & (jnp.sum(~done) > _nxt)
        else:
            cond = cond0

        _, cur_i, cur_done, cur_hit, cur_istop = jax.lax.while_loop(
            cond, body,
            (jnp.bool_(False), cur_i, cur_done, cur_hit, cur_istop))

        # Scatter this stage's results to full size.
        hit_full = hit_full.at[orig].set(cur_hit)
        istop_full = istop_full.at[orig].set(cur_istop)
        if nxt > 0:
            # Stable sort: active rays (done=False) first.
            order = jnp.argsort(cur_done.astype(jnp.int32),
                                stable=True)[:nxt]
            cur_o = cur_o[order]
            cur_d = cur_d[order]
            cur_i = cur_i[order]
            cur_done = cur_done[order]
            cur_hit = cur_hit[order]
            cur_istop = cur_istop[order]
            orig = orig[order]

    t_stop = istop_full.astype(jnp.float32) * step
    pos = origins + t_stop[:, None] * directions
    return pos, hit_full


# ------------------------------------------------------------ inverter
@dataclass
class GeoInverter:
    """Holds the solved camera + DEM and answers pixel->geo queries in
    batch — the engine behind the reference's REPL (main_v1.py:934-958) and
    boundary conversion (main_v1.py:765-785)."""

    K: np.ndarray
    R: np.ndarray
    ray_origin: np.ndarray      # [3] centered UTM
    dem: DemUtm
    control_pixels: np.ndarray  # [C,2]
    control_pos3d: np.ndarray   # [C,3] centered
    cfg: RaycastConfig = RaycastConfig()

    def __post_init__(self):
        # One-time quad-pack of the DEM for one-gather bilinear in the
        # march hot loop (4x memory).
        self._dem_pack = pack_bilinear(self.dem.data)
        self._factors, self._valid = compute_optimization_factors(
            jnp.asarray(self.control_pixels, jnp.float32),
            jnp.asarray(self.control_pos3d, jnp.float32),
            jnp.asarray(self.K, jnp.float32),
            jnp.asarray(self.R, jnp.float32),
            jnp.asarray(self.ray_origin, jnp.float32),
            self.cfg.factor_abs_max)
        if self.cfg.correction == "lsq_scales":
            ideal = self.control_pos3d - self.ray_origin
            ideal = ideal / np.linalg.norm(ideal, axis=1, keepdims=True)
            rays = np.asarray(proj.pixel_to_ray(
                jnp.asarray(self.control_pixels, jnp.float32),
                jnp.asarray(self.K, jnp.float32),
                jnp.asarray(self.R, jnp.float32)))
            scales, _ = fit_ray_scales(
                jnp.asarray(ideal, jnp.float32), jnp.asarray(rays))
            self._scales = np.asarray(scales)
        else:
            self._scales = np.ones(3, np.float32)

    def rays_for(self, pixels: np.ndarray) -> jnp.ndarray:
        pixels = jnp.asarray(np.atleast_2d(pixels), jnp.float32)
        rays = proj.pixel_to_ray(
            pixels, jnp.asarray(self.K, jnp.float32),
            jnp.asarray(self.R, jnp.float32))
        if self.cfg.correction == "weighted_factors":
            w = calculate_weights(
                pixels, jnp.asarray(self.control_pixels, jnp.float32),
                self.cfg.max_weight, self.cfg.knn_weight)
            f = weighted_factors(self._factors, self._valid, w)
            # Reference applies only the z factor then renormalizes
            # (main_v1.py:671-678).
            rays = rays.at[:, 2].multiply(f[:, 2])
        elif self.cfg.correction == "lsq_scales":
            rays = rays * jnp.asarray(self._scales)[None, :]
        return rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)

    def pixel_to_geo(self, pixels: np.ndarray):
        """[R,2] pixels -> (utm [R,3] f64 absolute, hit_mask [R])."""
        pixels = np.atleast_2d(np.asarray(pixels, np.float64))
        rays = self.rays_for(pixels)
        origins = jnp.broadcast_to(
            jnp.asarray(self.ray_origin, jnp.float32), rays.shape)
        dem_arrs = self.dem.device_arrays()
        max_steps = int(self.cfg.max_search_dist_m / self.cfg.step_m)
        if self.cfg.march == "mip":
            # Coverage guarantee: seg_steps * step <= pool * min(dx, dy).
            pool = 8
            spacing = min(abs(self.dem.dx), abs(self.dem.dy))
            seg_steps = max(int(pool * spacing / self.cfg.step_m), 1)
            seg_steps = int(min(seg_steps, 32))
            # Second mip level: smallest power-of-two pool2 covering a
            # whole level-1 lookahead window (32 segments), so empty sky
            # advances lookahead2 windows per trip.
            lookahead = 32
            pool2 = 1
            while pool2 * spacing < lookahead * seg_steps * self.cfg.step_m:
                pool2 *= 2
            pos, hit = march_rays_mip(
                origins, rays, *dem_arrs, max_steps=max_steps,
                step=self.cfg.step_m, min_hit_step=self.cfg.min_hit_step,
                pool=pool, seg_steps=seg_steps, lookahead=lookahead,
                dem_pack=self._dem_pack, pool2=pool2)
        else:
            pos, hit = march_rays(
                origins, rays, *dem_arrs, max_steps=max_steps,
                step=self.cfg.step_m, min_hit_step=self.cfg.min_hit_step,
                dem_pack=self._dem_pack)
        utm = self.dem.frame.uncenter(np.asarray(pos, np.float64))
        return utm, np.asarray(hit)

    def convert_boundary(self, json_data: dict):
        """ISAT segmentation JSON -> {(group, category): [utm rows]} +
        pixel dict, batched (main_v1.py:765-785 parity incl. the
        `geo_coord.all()` nonzero filter)."""
        import re

        keys, pix = [], []
        for obj in json_data.get("objects", []):
            group = obj.get("group")
            category = re.sub(r"[^a-zA-Z0-9]", "", str(obj.get("category")))
            for px, py in obj.get("segmentation", []):
                keys.append((group, category))
                pix.append((px, py))
        if not pix:
            return {}, {}
        utm, hit = self.pixel_to_geo(np.asarray(pix, np.float64))
        geo, pixels = {}, {}
        for k, p, u, h in zip(keys, pix, utm, hit):
            if not h or not u.all():
                continue
            geo.setdefault(k, []).append(u)
            pixels.setdefault(k, []).append(p)
        return geo, pixels
