"""Small host-side (NumPy) 3D math helpers: quaternions and camera matrices.

Quaternions are stored as (w, x, y, z), unit-normalized. These helpers run at
scene-compile time and in the camera controller; the device-side (jnp) rotation
math lives in `raymarch_tpu_torch.ops.sdf`.
"""

from __future__ import annotations

import numpy as np

IDENTITY_QUAT = (1.0, 0.0, 0.0, 0.0)


def quat_normalize(q):
    q = np.asarray(q, dtype=np.float64)
    return q / np.linalg.norm(q)


def quat_multiply(q1, q2):
    """Hamilton product q1 * q2 (apply q2's rotation first, then q1's)."""
    w1, x1, y1, z1 = np.asarray(q1, dtype=np.float64)
    w2, x2, y2, z2 = np.asarray(q2, dtype=np.float64)
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_conjugate(q):
    w, x, y, z = np.asarray(q, dtype=np.float64)
    return np.array([w, -x, -y, -z])


def quat_to_matrix(q):
    """3x3 rotation matrix for unit quaternion q=(w,x,y,z)."""
    w, x, y, z = quat_normalize(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_rotate(q, v):
    return quat_to_matrix(q) @ np.asarray(v, dtype=np.float64)


def quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle / 2.0
    return np.concatenate([[np.cos(half)], np.sin(half) * axis])


def quat_from_euler(roll, pitch, yaw):
    """Intrinsic XYZ euler angles: R = Rz(yaw) @ Ry(pitch) @ Rx(roll).

    Matches nalgebra's `UnitQuaternion::from_euler_angles` convention used by
    the reference orbit camera (reference src/camera.rs:53).
    """
    qx = quat_from_axis_angle([1, 0, 0], roll)
    qy = quat_from_axis_angle([0, 1, 0], pitch)
    qz = quat_from_axis_angle([0, 0, 1], yaw)
    return quat_multiply(qz, quat_multiply(qy, qx))


def is_identity_quat(q, tol=1e-12):
    q = quat_normalize(q)
    if q[0] < 0:
        q = -q
    return bool(np.allclose(q, [1.0, 0.0, 0.0, 0.0], atol=tol))


def perspective_matrix(aspect: float, fovy: float, near: float, far: float):
    """Right-handed perspective projection mapping view space to NDC.

    Same convention as nalgebra `Perspective3` (reference
    src/ray_marching/renderer.rs:206-207): camera looks down -z in view space,
    NDC z in [-1, 1].
    """
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def view_matrix(position, rotation_quat):
    """World-to-view 4x4: rotation^{-1} . translate(-position).

    Mirrors reference `Camera::view` (src/camera.rs:10-12).
    """
    r_inv = quat_to_matrix(quat_conjugate(rotation_quat))
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r_inv
    m[:3, 3] = -r_inv @ np.asarray(position, dtype=np.float64)
    return m
