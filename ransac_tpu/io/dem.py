"""DEM raster ingest and on-device sampling grids.

Replaces the reference's GDAL + scipy ``RegularGridInterpolator`` stack
(``/root/reference/main_v1.py:425-465``).  Two representations:

- ``DemLonLat``: the raster as shipped — a regular grid in lon/lat from the
  GeoTIFF geotransform (rows northing-down, gt[5] < 0).  Matches the
  reference's interpolator exactly (bilinear over (lat, lon)).
- ``DemUtm``: the device form — the same surface resampled ONCE at load
  onto a regular, scene-centered UTM grid.  The reference instead calls
  PROJ per 1-meter ray-march step (main_v1.py:642, hot loop #4); after this
  one-time warp the march needs only a bilinear gather, so thousands of
  rays advance per XLA step with zero geodesy in the loop.

GeoTIFF reading uses PIL tag parsing (GDAL/rasterio are not dependencies);
synthetic DEMs for tests come from ``synthetic_dem``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ransac_tpu.ops.geodesy import SceneFrame, utm_to_wgs84, wgs84_to_utm


@dataclass
class DemLonLat:
    data: np.ndarray      # [H, W] f32 elevations
    lon: np.ndarray       # [W] ascending
    lat: np.ndarray       # [H] ascending
    utm_x_range: tuple    # corner-derived UTM easting range (main_v1.py:435-452)
    utm_y_range: tuple

    @property
    def lon_range(self):
        return float(self.lon.min()), float(self.lon.max())

    @property
    def lat_range(self):
        return float(self.lat.min()), float(self.lat.max())

    def interpolate(self, lat, lon):
        """Bilinear elevation lookup, reference interpolator semantics
        ((lat, lon) order, main_v1.py:454)."""
        return _bilinear_np(self.data, self.lat, self.lon, lat, lon)


@dataclass
class DemUtm:
    """Regular scene-centered UTM elevation grid for in-jit sampling."""

    data: np.ndarray      # [H, W] f32; rows index northing ascending
    x0: float             # centered easting of col 0
    y0: float             # centered northing of row 0
    dx: float
    dy: float
    frame: SceneFrame

    def device_arrays(self):
        return (jnp.asarray(self.data), jnp.float32(self.x0),
                jnp.float32(self.y0), jnp.float32(self.dx),
                jnp.float32(self.dy))


def _bilinear_np(grid, rows_coord, cols_coord, r, c):
    r = np.asarray(r, np.float64)
    c = np.asarray(c, np.float64)
    ri = np.interp(r, rows_coord, np.arange(len(rows_coord)))
    ci = np.interp(c, cols_coord, np.arange(len(cols_coord)))
    r0 = np.clip(np.floor(ri).astype(int), 0, grid.shape[0] - 2)
    c0 = np.clip(np.floor(ci).astype(int), 0, grid.shape[1] - 2)
    fr = ri - r0
    fc = ci - c0
    g = grid
    return ((g[r0, c0] * (1 - fr) * (1 - fc))
            + g[r0 + 1, c0] * fr * (1 - fc)
            + g[r0, c0 + 1] * (1 - fr) * fc
            + g[r0 + 1, c0 + 1] * fr * fc)


def bilinear_sample(data: jnp.ndarray, x0, y0, dx, dy,
                    x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Jittable bilinear gather on a regular grid: elevation at centered-UTM
    (x, y).  Out-of-range queries clamp to the border (callers bound-check
    separately, mirroring main_v1.py:921-929)."""
    ci = (x - x0) / dx
    ri = (y - y0) / dy
    r0 = jnp.clip(jnp.floor(ri).astype(jnp.int32), 0, data.shape[0] - 2)
    c0 = jnp.clip(jnp.floor(ci).astype(jnp.int32), 0, data.shape[1] - 2)
    fr = jnp.clip(ri - r0, 0.0, 1.0)
    fc = jnp.clip(ci - c0, 0.0, 1.0)
    v00 = data[r0, c0]
    v10 = data[r0 + 1, c0]
    v01 = data[r0, c0 + 1]
    v11 = data[r0 + 1, c0 + 1]
    return (v00 * (1 - fr) * (1 - fc) + v10 * fr * (1 - fc)
            + v01 * (1 - fr) * fc + v11 * fr * fc)


def pack_bilinear(data) -> jnp.ndarray:
    """Quad-pack a [H, W] grid for one-gather bilinear sampling.

    Packs every 2x2 neighborhood needed by any (r0, c0) into one 16-byte
    row of a [4*Hp*Wp, 4] array — 4 parity planes indexed by
    (r0 & 1, c0 & 1) — so :func:`bilinear_sample_packed` fetches all four
    corners with ONE row gather instead of four scalar gathers (it was
    built where each gather moved a whole vector row; on the GPU one
    16-byte load per sample is not yet compared with four 4-byte loads).
    Memory cost: 4x the grid.
    """
    d = np.asarray(data, np.float32)
    h, w = d.shape
    hp, wp = (h + 1) // 2, (w + 1) // 2
    d = np.pad(d, ((0, 2 * hp + 2 - h), (0, 2 * wp + 2 - w)), mode="edge")
    planes = []
    for pr in (0, 1):
        for pc in (0, 1):
            q = np.stack(
                [d[pr:pr + 2 * hp:2, pc:pc + 2 * wp:2],
                 d[pr:pr + 2 * hp:2, pc + 1:pc + 1 + 2 * wp:2],
                 d[pr + 1:pr + 1 + 2 * hp:2, pc:pc + 2 * wp:2],
                 d[pr + 1:pr + 1 + 2 * hp:2, pc + 1:pc + 1 + 2 * wp:2]],
                axis=-1)
            planes.append(q.reshape(-1, 4))
    return jnp.asarray(np.concatenate(planes))


def bilinear_sample_packed(pack: jnp.ndarray, h: int, w: int, x0, y0,
                           dx, dy, x: jnp.ndarray, y: jnp.ndarray):
    """:func:`bilinear_sample` semantics via the quad-packed grid
    (one row gather per query instead of four scalar gathers).
    ``h, w`` are the original grid dims (static)."""
    hp, wp = (h + 1) // 2, (w + 1) // 2
    ci = (x - x0) / dx
    ri = (y - y0) / dy
    r0 = jnp.clip(jnp.floor(ri).astype(jnp.int32), 0, h - 2)
    c0 = jnp.clip(jnp.floor(ci).astype(jnp.int32), 0, w - 2)
    fr = jnp.clip(ri - r0, 0.0, 1.0)
    fc = jnp.clip(ci - c0, 0.0, 1.0)
    plane = (r0 & 1) * 2 + (c0 & 1)
    g = jnp.take(pack, plane * (hp * wp) + (r0 >> 1) * wp + (c0 >> 1),
                 axis=0)
    shape = fr.shape
    g = g.reshape(shape + (4,))
    v00, v01, v10, v11 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    return (v00 * (1 - fr) * (1 - fc) + v10 * fr * (1 - fc)
            + v01 * (1 - fr) * fc + v11 * fr * fc)


def in_bounds(dem: DemUtm, x, y, margin: float = 0.0):
    xmax = dem.x0 + dem.dx * (dem.data.shape[1] - 1)
    ymax = dem.y0 + dem.dy * (dem.data.shape[0] - 1)
    return ((x >= dem.x0 + margin) & (x <= xmax - margin)
            & (y >= dem.y0 + margin) & (y <= ymax - margin))


def load_geotiff(path: str, zone: int = 50,
                 nodata_fill: float = float("nan")) -> DemLonLat:
    """GeoTIFF -> DemLonLat via the dependency-free reader in
    :mod:`ransac_tpu.io.tiff` (tiled and strip layouts, Deflate/LZW/
    PackBits, predictors 2/3, BigTIFF, GDAL_NODATA, full
    ModelTransformation) — the raster feature set GDAL gives the
    reference for free (main_v1.py:425-433).  Falls back to PIL for
    TIFF variants outside that set (e.g. JPEG-compressed).

    Nodata cells become ``nodata_fill`` (default NaN: bilinear samples
    touching them go NaN, so rays never "hit" a nodata hole and the
    bounds checks mirroring main_v1.py:921-929 reject queries there).
    """
    from ransac_tpu.io import tiff as tifflib

    try:
        raw, tags = tifflib.read_tiff(path)
        gt = tifflib.geotransform(tags)
        nodata = tifflib.nodata_value(tags)
    except ValueError:
        raise
    except Exception:  # non-TIFF container / exotic codec: try PIL
        from PIL import Image

        im = Image.open(path)
        raw = np.asarray(im)
        t = im.tag_v2
        scale, tiepoint = t.get(33550), t.get(33922)
        if scale is None or tiepoint is None:
            m = t.get(34264)
            if m is None:
                raise ValueError(f"{path}: no geotransform tags")
            if abs(m[1]) > 1e-12 or abs(m[4]) > 1e-12:
                # Mirror the native reader: a rotated/sheared raster has
                # no axis-aligned (lon, lat) grid to interpolate on.
                raise ValueError(f"{path}: rotated rasters unsupported")
            gt = (m[3], m[0], m[1], m[7], m[4], m[5])
        else:
            gt = (tiepoint[3], scale[0], 0.0, tiepoint[4], 0.0, -scale[1])
        nodata = None
        nd = t.get(42113)
        if nd is not None:
            try:
                nodata = float(str(nd).strip())
            except ValueError:
                pass
    data = np.asarray(raw, dtype=np.float32)
    if nodata is not None:
        data = np.where(
            np.isclose(data, np.float32(nodata), rtol=1e-6, atol=0.0),
            np.float32(nodata_fill), data)
    lon0, dlon, _, lat0, _, dlat = gt
    h, w = data.shape[:2]
    lon = lon0 + np.arange(w) * dlon
    lat = lat0 + np.arange(h) * dlat
    return from_arrays(data, lon, lat, zone=zone)


def from_arrays(data: np.ndarray, lon: np.ndarray, lat: np.ndarray,
                zone: int = 50) -> DemLonLat:
    data = np.asarray(data, np.float32)
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    if lat[0] > lat[-1]:  # store ascending (north-up rasters)
        lat = lat[::-1]
        data = data[::-1]
    if lon.size > 1 and lon[0] > lon[-1]:  # west-east-flipped rasters
        lon = lon[::-1]
        data = data[:, ::-1]
    corners = [(lon.min(), lat.min()), (lon.min(), lat.max()),
               (lon.max(), lat.min()), (lon.max(), lat.max())]
    es, ns = zip(*[wgs84_to_utm(lo, la, zone) for lo, la in corners])
    return DemLonLat(
        data=data, lon=lon, lat=lat,
        utm_x_range=(min(es), max(es)), utm_y_range=(min(ns), max(ns)))


def resample_to_utm(dem: DemLonLat, frame: SceneFrame,
                    spacing_m: float = 10.0) -> DemUtm:
    """One-time warp onto a regular scene-centered UTM grid (host f64
    geodesy, bilinear resample)."""
    x_min = dem.utm_x_range[0] - frame.anchor[0]
    x_max = dem.utm_x_range[1] - frame.anchor[0]
    y_min = dem.utm_y_range[0] - frame.anchor[1]
    y_max = dem.utm_y_range[1] - frame.anchor[1]
    xs = np.arange(x_min, x_max + spacing_m, spacing_m)
    ys = np.arange(y_min, y_max + spacing_m, spacing_m)
    XX, YY = np.meshgrid(xs, ys)
    lon, lat = utm_to_wgs84(
        XX.ravel() + frame.anchor[0], YY.ravel() + frame.anchor[1],
        frame.zone, frame.northern)
    # Clamp to raster footprint (UTM bbox of a lon/lat rect overhangs it).
    lat = np.clip(lat, dem.lat.min(), dem.lat.max())
    lon = np.clip(lon, dem.lon.min(), dem.lon.max())
    z = dem.interpolate(lat, lon).reshape(YY.shape).astype(np.float32)
    return DemUtm(data=z, x0=float(xs[0]), y0=float(ys[0]),
                  dx=spacing_m, dy=spacing_m, frame=frame)


def polygon_interior_elevations(dem: DemUtm, polygon_xy: np.ndarray,
                                spacing_m: float | None = None):
    """Sample DEM elevations on a grid of points inside a polygon —
    the ``3D-1.py:44-121`` capability (polygon interior -> elevation
    samples feeding the terrain mesh).  polygon_xy is [V,2] centered-UTM;
    returns [M,3] (x, y, z) interior samples."""
    import jax.numpy as jnp

    poly = np.asarray(polygon_xy, np.float64)
    if spacing_m is None:
        spacing_m = max(dem.dx, dem.dy)
    x0, y0 = poly.min(0)
    x1, y1 = poly.max(0)
    xs = np.arange(x0, x1 + spacing_m, spacing_m)
    ys = np.arange(y0, y1 + spacing_m, spacing_m)
    XX, YY = np.meshgrid(xs, ys)
    pts = np.stack([XX.ravel(), YY.ravel()], 1)

    # Even-odd rule point-in-polygon (vectorized).
    inside = np.zeros(len(pts), bool)
    n = len(poly)
    for i in range(n):
        x1p, y1p = poly[i]
        x2p, y2p = poly[(i + 1) % n]
        cond = ((y1p > pts[:, 1]) != (y2p > pts[:, 1]))
        denom = np.where(y2p == y1p, 1e-30, y2p - y1p)
        x_int = x1p + (pts[:, 1] - y1p) * (x2p - x1p) / denom
        inside ^= cond & (pts[:, 0] < x_int)
    pts = pts[inside]
    if len(pts) == 0:
        return np.zeros((0, 3))
    z = np.asarray(bilinear_sample(
        jnp.asarray(dem.data), dem.x0, dem.y0, dem.dx, dem.dy,
        jnp.asarray(pts[:, 0], jnp.float32),
        jnp.asarray(pts[:, 1], jnp.float32)))
    return np.concatenate([pts, z[:, None]], axis=1)


def synthetic_dem(frame: SceneFrame, extent_m: float = 4000.0,
                  spacing_m: float = 10.0, base_z: float = 0.0,
                  terrain_fn=None) -> DemUtm:
    """Analytic terrain for tests/demos; defaults to a gentle paraboloid."""
    xs = np.arange(-extent_m, extent_m + spacing_m, spacing_m)
    ys = np.arange(-extent_m, extent_m + spacing_m, spacing_m)
    XX, YY = np.meshgrid(xs, ys)
    if terrain_fn is None:
        z = base_z + 100.0 * np.exp(-((XX / 1500.0) ** 2 + (YY / 1500.0) ** 2))
    else:
        z = terrain_fn(XX, YY)
    return DemUtm(data=z.astype(np.float32), x0=float(xs[0]), y0=float(ys[0]),
                  dx=spacing_m, dy=spacing_m, frame=frame)
