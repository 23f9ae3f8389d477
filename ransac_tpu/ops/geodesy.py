"""WGS84 <-> UTM geodesy as pure array math (Karney/Krüger series, order 6).

JAX replacement for ``pyproj.Transformer`` (PROJ's C transverse
Mercator), which the reference calls through ``GeoCoordTransformer``
(``/root/reference/main_v1.py:36-59``) — including *inside the ray-march
inner loop* (``main_v1.py:642``), one FFI call per 1-m step.  Re-implementing
the projection as jittable series math lets geodesy run inside ``jit``/
``vmap``, so an entire batch of rays can be marched on-device.

Algorithm: Karney, "Transverse Mercator with an accuracy of a few
nanometers" (J. Geodesy 2011) — conformal-latitude + 6th-order Krüger
series.  In float64 this agrees with PROJ to sub-millimeter; the 12
pyproj-produced UTM coordinates hard-coded in the reference
(``testpro-K.py:198-211``) are used as oracle values in
``tests/test_geodesy.py``.

Every function is written against a pluggable array namespace ``xp`` so the
same code runs as host-side numpy float64 (ingest/export boundary — the
canonical path) and as jittable jax.numpy (in-kernel compatibility path).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# WGS84 ellipsoid.
A_WGS84 = 6378137.0
F_WGS84 = 1.0 / 298.257223563
# UTM scale/offsets.
K0_UTM = 0.9996
FALSE_EASTING = 500_000.0
FALSE_NORTHING_SOUTH = 10_000_000.0

_N = F_WGS84 / (2.0 - F_WGS84)  # third flattening
_E2 = F_WGS84 * (2.0 - F_WGS84)  # eccentricity^2
_E = math.sqrt(_E2)

# Rectifying radius A = a/(1+n) * (1 + n^2/4 + n^4/64 + n^6/256).
_A_RECT = A_WGS84 / (1.0 + _N) * (
    1.0 + _N**2 / 4.0 + _N**4 / 64.0 + _N**6 / 256.0
)

# Krüger alpha (forward) / beta (inverse) series coefficients, order 6.
_ALPHA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 5.0 * _N**3 / 16.0 + 41.0 * _N**4 / 180.0
    - 127.0 * _N**5 / 288.0 + 7891.0 * _N**6 / 37800.0,
    13.0 * _N**2 / 48.0 - 3.0 * _N**3 / 5.0 + 557.0 * _N**4 / 1440.0
    + 281.0 * _N**5 / 630.0 - 1983433.0 * _N**6 / 1935360.0,
    61.0 * _N**3 / 240.0 - 103.0 * _N**4 / 140.0 + 15061.0 * _N**5 / 26880.0
    + 167603.0 * _N**6 / 181440.0,
    49561.0 * _N**4 / 161280.0 - 179.0 * _N**5 / 168.0
    + 6601661.0 * _N**6 / 7257600.0,
    34729.0 * _N**5 / 80640.0 - 3418889.0 * _N**6 / 1995840.0,
    212378941.0 * _N**6 / 319334400.0,
)
_BETA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 37.0 * _N**3 / 96.0 - _N**4 / 360.0
    - 81.0 * _N**5 / 512.0 + 96199.0 * _N**6 / 604800.0,
    _N**2 / 48.0 + _N**3 / 15.0 - 437.0 * _N**4 / 1440.0
    + 46.0 * _N**5 / 105.0 - 1118711.0 * _N**6 / 3870720.0,
    17.0 * _N**3 / 480.0 - 37.0 * _N**4 / 840.0 - 209.0 * _N**5 / 4480.0
    + 5569.0 * _N**6 / 90720.0,
    4397.0 * _N**4 / 161280.0 - 11.0 * _N**5 / 504.0
    - 830251.0 * _N**6 / 7257600.0,
    4583.0 * _N**5 / 161280.0 - 108847.0 * _N**6 / 3991680.0,
    20648693.0 * _N**6 / 638668800.0,
)


def utm_zone_lon0_deg(zone: int) -> float:
    """Central meridian of a UTM zone (zone 50 -> 117E; EPSG:32650 is the
    reference's CRS, main_v1.py:38)."""
    return float(zone) * 6.0 - 183.0


def _hyp(xp, x):
    return xp.sqrt(1.0 + x * x)


def _taupf(xp, tau):
    """tau' = conformal-latitude tangent from geodetic tangent tau."""
    tau1 = _hyp(xp, tau)
    sig = xp.sinh(_E * xp.arctanh(_E * tau / tau1))
    return tau * _hyp(xp, sig) - sig * tau1


def _tauf(xp, taup):
    """Invert _taupf by Newton iteration (5 steps, Karney's update)."""
    e2m = 1.0 - _E2
    tau = taup / e2m  # first guess
    for _ in range(5):
        taupa = _taupf(xp, tau)
        dtau = (
            (taup - taupa) * (1.0 + e2m * tau * tau)
            / (e2m * _hyp(xp, tau) * _hyp(xp, taupa))
        )
        tau = tau + dtau
    return tau


def _tm_forward(xp, lon_deg, lat_deg, lon0_deg):
    """Transverse Mercator forward: (lon, lat) degrees -> unscaled (x, y)
    in meters from the central meridian/equator."""
    lam = xp.radians(lon_deg - lon0_deg)
    phi = xp.radians(lat_deg)
    tau = xp.tan(phi)
    taup = _taupf(xp, tau)
    coslam = xp.cos(lam)
    xip = xp.arctan2(taup, coslam)
    etap = xp.arcsinh(xp.sin(lam) / xp.sqrt(taup * taup + coslam * coslam))
    xi = xip
    eta = etap
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * xp.sin(2.0 * j * xip) * xp.cosh(2.0 * j * etap)
        eta = eta + a * xp.cos(2.0 * j * xip) * xp.sinh(2.0 * j * etap)
    return _A_RECT * eta, _A_RECT * xi


def _tm_inverse(xp, x, y, lon0_deg):
    """Transverse Mercator inverse of ``_tm_forward``."""
    eta = x / _A_RECT
    xi = y / _A_RECT
    xip = xi
    etap = eta
    for j, b in enumerate(_BETA, start=1):
        xip = xip - b * xp.sin(2.0 * j * xi) * xp.cosh(2.0 * j * eta)
        etap = etap - b * xp.cos(2.0 * j * xi) * xp.sinh(2.0 * j * eta)
    sinh_etap = xp.sinh(etap)
    cos_xip = xp.cos(xip)
    lam = xp.arctan2(sinh_etap, cos_xip)
    taup = xp.sin(xip) / xp.sqrt(sinh_etap * sinh_etap + cos_xip * cos_xip)
    tau = _tauf(xp, taup)
    lat = xp.degrees(xp.arctan(tau))
    lon = lon0_deg + xp.degrees(lam)
    return lon, lat


def wgs84_to_utm(lon_deg, lat_deg, zone: int = 50, northern: bool = True,
                 xp=np):
    """(lon, lat) degrees -> (easting, northing) meters in the given UTM zone.

    Matches ``GeoCoordTransformer.wgs84_to_utm`` (main_v1.py:41-48,
    EPSG:4326 -> EPSG:32650 with always_xy) when zone=50, northern=True.
    """
    x, y = _tm_forward(xp, lon_deg, lat_deg, utm_zone_lon0_deg(zone))
    easting = K0_UTM * x + FALSE_EASTING
    northing = K0_UTM * y + (0.0 if northern else FALSE_NORTHING_SOUTH)
    return easting, northing


def utm_to_wgs84(easting, northing, zone: int = 50, northern: bool = True,
                 xp=np):
    """(easting, northing) meters -> (lon, lat) degrees.  Matches
    ``GeoCoordTransformer.utm_to_wgs84`` (main_v1.py:50-57)."""
    x = (easting - FALSE_EASTING) / K0_UTM
    y = (northing - (0.0 if northern else FALSE_NORTHING_SOUTH)) / K0_UTM
    return _tm_inverse(xp, x, y, utm_zone_lon0_deg(zone))


# Jittable flavors (device dtype; enable jax x64 for sub-mm parity).
wgs84_to_utm_jax = partial(wgs84_to_utm, xp=jnp)
utm_to_wgs84_jax = partial(utm_to_wgs84, xp=jnp)


@dataclass(frozen=True)
class SceneFrame:
    """Scene-centered UTM frame for device math.

    UTM magnitudes (E ~ 7.39e5, N ~ 2.889e6 for the reference's Kuliang scene,
    testpro-K.py:198-211) destroy float32 precision (~0.25 m ULP at 2.9e6),
    so all device arrays are expressed relative to a per-scene anchor held in
    float64 on host (SURVEY.md §7.1).
    """

    anchor: np.ndarray  # [3] float64 UTM (easting, northing, z)
    zone: int = 50
    northern: bool = True

    @staticmethod
    def from_points(pos_utm: np.ndarray, zone: int = 50,
                    northern: bool = True) -> "SceneFrame":
        anchor = np.asarray(pos_utm, dtype=np.float64).reshape(-1, 3).mean(0)
        return SceneFrame(anchor=anchor, zone=zone, northern=northern)

    def center(self, pos_utm: np.ndarray, dtype=np.float32) -> np.ndarray:
        p = np.asarray(pos_utm, dtype=np.float64) - self.anchor
        return p.astype(dtype)

    def uncenter(self, pos_local) -> np.ndarray:
        return np.asarray(pos_local, dtype=np.float64) + self.anchor

    def to_wgs84(self, pos_local) -> tuple[np.ndarray, np.ndarray]:
        p = self.uncenter(pos_local).reshape(-1, 3)
        lon, lat = utm_to_wgs84(p[:, 0], p[:, 1], self.zone, self.northern)
        return lon, lat


class GeoTransformer:
    """Drop-in functional equivalent of the reference's
    ``GeoCoordTransformer`` singleton (main_v1.py:36-59), minus PROJ."""

    def __init__(self, zone: int = 50, northern: bool = True):
        self.zone = zone
        self.northern = northern

    def wgs84_to_utm(self, lon, lat):
        e, n = wgs84_to_utm(lon, lat, self.zone, self.northern)
        if not (np.all(np.isfinite(e)) and np.all(np.isfinite(n))):
            raise ValueError("Invalid UTM coordinates")
        return e, n

    def utm_to_wgs84(self, easting, northing):
        lon, lat = utm_to_wgs84(easting, northing, self.zone, self.northern)
        if not (np.all(np.isfinite(lon)) and np.all(np.isfinite(lat))):
            raise ValueError("Invalid WGS84 coordinates")
        return lon, lat


def meridian_convergence_scale(lon_deg, lat_deg, zone: int = 50, xp=np):
    """Grid convergence gamma (radians) and point scale factor k — exposed
    for QA/analytics parity checks."""
    lon0 = utm_zone_lon0_deg(zone)
    lam = xp.radians(lon_deg - lon0)
    phi = xp.radians(lat_deg)
    # First-order closed forms — sufficient for analytics use.
    gamma = xp.arctan(xp.sin(phi) * xp.tan(lam))
    k = K0_UTM * (1.0 + (lam * xp.cos(phi)) ** 2 / 2.0 * (1.0 + _E2 / (1.0 - _E2) * xp.cos(phi) ** 2))
    return gamma, k
