"""SO(3) operations: Rodrigues exp/log maps, quaternions.

JAX replacement for ``cv2.Rodrigues`` (called at
``/root/reference/main_v1.py:895`` and ``testpro-K.py:84,136,169``): a
closed-form, branch-free (``jnp.where``) exponential map that vmaps over
hypothesis tensors — every RANSAC hypothesis and every BA iterate goes
through these.

All functions take/return jnp arrays, are f32-safe (Taylor fallbacks near
theta=0), and are differentiable for LM/BA Jacobians.
"""

from __future__ import annotations

import jax.numpy as jnp

from ransac_tpu.ops.linalg import svd3x3
from ransac_tpu.ops.precision import mm

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: [3] -> [3,3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(rvec: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: rotation vector [...,3] -> rotation matrix [...,3,3].

    R = I + sin(t)/t K + (1-cos(t))/t^2 K^2, with 2nd-order Taylor
    coefficients below sqrt(eps) so gradients stay finite at t=0.
    """
    theta2 = jnp.sum(rvec * rvec, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS) - _EPS  # ~theta, smooth at 0
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    b = jnp.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2),
    )
    K = hat(rvec)
    KK = mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse Rodrigues: rotation matrix [...,3,3] -> rotation vector [...,3].

    Uses the quaternion route, which is numerically stable across the full
    angle range including near pi (where the direct acos/axis formula loses
    precision).
    """
    q = quat_from_matrix(R)
    return rvec_from_quat(q)


def quat_from_matrix(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0.

    Branch-free Shepperd's method: compute all four candidate columns and
    select the best-conditioned one with where-masks (vmappable).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q_i^2 values.
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 0.0))

    # Candidate quaternions (unnormalized), one per dominant component.
    cw = jnp.stack([qw2, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    cx = jnp.stack([m21 - m12, qx2, m01 + m10, m02 + m20], axis=-1)
    cy = jnp.stack([m02 - m20, m01 + m10, qy2, m12 + m21], axis=-1)
    cz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, qz2], axis=-1)

    mags = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = jnp.argmax(mags, axis=-1)
    cand = jnp.stack([cw, cx, cy, cz], axis=-2)  # [...,4,4]
    q = jnp.take_along_axis(cand, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: w >= 0.
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q


def rvec_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> rotation vector."""
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = jnp.linalg.norm(v, axis=-1)
    theta = 2.0 * jnp.arctan2(vnorm, w)
    small = vnorm < 1e-8
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-8), theta / jnp.where(small, 1.0, vnorm))
    return v * scale[..., None]


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = jnp.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = jnp.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return jnp.stack([row0, row1, row2], axis=-2)


def project_to_so3(M: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD — used after linear pose
    solves (DLT PnP, absolute orientation) to re-orthogonalize."""
    U, _, Vt = svd3x3(M)
    det = jnp.linalg.det(mm(U, Vt))
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    return mm(U * D[..., None, :], Vt)


def geodesic_distance(R1: jnp.ndarray, R2: jnp.ndarray) -> jnp.ndarray:
    """Angle (radians) between two rotations."""
    tr = jnp.trace(mm(jnp.swapaxes(R1, -1, -2), R2), axis1=-2, axis2=-1)
    return jnp.arccos(jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0))
