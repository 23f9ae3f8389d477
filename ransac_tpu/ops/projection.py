"""Pinhole camera projection / unprojection kernels.

JAX replacement for ``cv2.projectPoints`` (``testpro-K.py:33``) and
the hand-rolled east-axis plane projection at the heart of the reference's
candidate scoring (``main_v1.py:306-311``).  Everything is batched and
differentiable: the same projection code serves RANSAC inlier scoring, PnP
refinement Jacobians, and bundle adjustment residuals.

Conventions: world-to-camera pose (R, t); x_cam = R @ X + t; pixel =
K @ x_cam / z.  Distortion follows OpenCV's (k1,k2,p1,p2,k3) model so
calibration parity holds.
"""

from __future__ import annotations

import jax.numpy as jnp

from ransac_tpu.ops.precision import einsum



def intrinsics_from_physical(
    focal_length_mm: float,
    sensor_width_mm: float,
    sensor_height_mm: float,
    width_px: float,
    height_px: float,
    cx: float,
    cy: float,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """K from physical film parameters — reference semantics
    (main_v1.py:869-883): fx = f/sensor_w * W, fy = f/sensor_h * H."""
    fx = focal_length_mm / sensor_width_mm * width_px
    fy = focal_length_mm / sensor_height_mm * height_px
    return jnp.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dtype)


def project_points(
    X: jnp.ndarray,
    R: jnp.ndarray,
    t: jnp.ndarray,
    K: jnp.ndarray,
    dist: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Project world points [...,N,3] with pose (R [...,3,3], t [...,3]).

    Returns (pixels [...,N,2], depth [...,N]).  Depth is the camera-frame z,
    used for cheirality masking; points behind the camera still produce
    finite pixels (guarded divide) so the caller can mask instead of branch.
    """
    Xc = einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = Xc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    xn = Xc[..., 0] * inv_z
    yn = Xc[..., 1] * inv_z
    if dist is not None:
        xn, yn = distort(xn, yn, dist)
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    u = fx[..., None] * xn + cx[..., None]
    v = fy[..., None] * yn + cy[..., None]
    return jnp.stack([u, v], axis=-1), z


def distort(xn, yn, dist):
    """OpenCV (k1,k2,p1,p2,k3) distortion on normalized coords."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    y = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return x, y


def undistort_normalized(xd, yd, dist, iters: int = 8):
    """Invert ``distort`` by fixed-point iteration (OpenCV's algorithm),
    shape-static for jit.  Replaces ``cv2.undistort``'s per-pixel remap."""
    x, y = xd, yd
    for _ in range(iters):
        k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def normalize_pixels(pixels: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Pixels [...,N,2] -> normalized camera coords (K^-1 applied)."""
    fx = K[..., 0, 0, None]
    fy = K[..., 1, 1, None]
    cx = K[..., 0, 2, None]
    cy = K[..., 1, 2, None]
    x = (pixels[..., 0] - cx) / fx
    y = (pixels[..., 1] - cy) / fy
    return jnp.stack([x, y], axis=-1)


def pixel_to_ray(
    pixels: jnp.ndarray, K: jnp.ndarray, R: jnp.ndarray,
    force_unit_z: bool = False,
) -> jnp.ndarray:
    """Batched camera ray directions in the world frame.

    Replaces the scalar ``pixel_to_ray`` (main_v1.py:547-574): normalize
    K^-1 [u,v,1], rotate by R^T, renormalize.  ``force_unit_z=True``
    reproduces the test_pro.py:565-596 variant that clamps the camera-frame
    z component to 1 before normalizing.
    """
    xn = normalize_pixels(pixels, K)
    ones = jnp.ones_like(xn[..., :1])
    cam = jnp.concatenate([xn, ones], axis=-1)
    if not force_unit_z:
        cam = cam / jnp.linalg.norm(cam, axis=-1, keepdims=True)
    world = einsum("...ji,...nj->...ni", R, cam)  # R^T @ cam
    return world / jnp.linalg.norm(world, axis=-1, keepdims=True)


def east_axis_plane_projection(
    pos3d: jnp.ndarray, camera_location: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's candidate-camera projection (main_v1.py:306-311).

    For each landmark, p = pos3d - camera_location in UTM (E, N, z); the
    pinhole optical axis is hard-fixed along +easting, and the projected
    plane coordinates are (dz/dE, dN/dE).  Returns (pos2 [...,N,2],
    d_east [...,N]) with d_east exposed for cheirality/degeneracy masking.
    Valid only for scenes viewed roughly from the west, exactly like the
    reference — the general path is P3P over free rotations.
    """
    p = pos3d - camera_location[..., None, :]
    d_east = p[..., 0]
    inv = 1.0 / jnp.where(jnp.abs(d_east) < 1e-12, 1e-12, d_east)
    pos2 = jnp.stack([p[..., 2] * inv, p[..., 1] * inv], axis=-1)
    return pos2, d_east


def camera_origin_from_pose(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """World-frame camera center: C = -R^T t (main_v1.py:910)."""
    return -einsum("...ji,...j->...i", R, t)


def clip_translation(t: jnp.ndarray, max_norm: float = 1e4) -> jnp.ndarray:
    """Clip a translation vector to ``max_norm`` (batched).

    Parity for the reference's ``check_translation_vector``
    (main_v1.py:515-520 — defined there but never called; provided here as
    a live, vmappable utility).
    """
    n = jnp.linalg.norm(t, axis=-1, keepdims=True)
    scale = jnp.where(n > max_norm, max_norm / jnp.where(n > 0, n, 1.0), 1.0)
    return t * scale


def translation_from_origin(R: jnp.ndarray, origin: jnp.ndarray) -> jnp.ndarray:
    """t = -R @ origin: rebuild the translation from a known camera center.

    Parity for the reference's ``recalculate_translation_vector``
    (main_v1.py:532-544 — dead code there); inverse of
    :func:`camera_origin_from_pose`.
    """
    return -einsum("...ij,...j->...i", R, origin)
