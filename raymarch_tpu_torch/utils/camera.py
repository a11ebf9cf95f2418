"""Camera model and orbit controller.

`Camera` mirrors the reference's `Camera { position, rotation }` with
`view() = rotation^-1 . translate(-position)` (reference src/camera.rs:3-13).
`OrbitCameraController` reproduces the reference's pitch/yaw/radius orbit rig
around a target with pan/orbit/dolly events and the same speed/clamp defaults
(reference src/camera.rs:21-85).

Camera state is numpy (position f32[3], rotation quat f32[4]), or tensors
for a pose being fitted; `cam_vec` packs it into the f32[8] tensor (pos3,
quat4, row_offset) that the kernels read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import math3d, profiling


@dataclasses.dataclass
class Camera:
    position: np.ndarray  # f32[3], world-space
    rotation: np.ndarray  # f32[4] unit quaternion (w,x,y,z), camera-to-world

    def view(self) -> np.ndarray:
        """World-to-view 4x4 (reference src/camera.rs:10-12)."""
        return math3d.view_matrix(np.asarray(self.position), np.asarray(self.rotation))

    @staticmethod
    def looking_at(position, target, up=(0.0, 1.0, 0.0)) -> "Camera":
        """Camera at `position` looking toward `target` (looks down -z)."""
        position = np.asarray(position, dtype=np.float64)
        fwd = np.asarray(target, dtype=np.float64) - position
        fwd /= np.linalg.norm(fwd)
        z = -fwd
        x = np.cross(np.asarray(up, dtype=np.float64), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        m = np.stack([x, y, z], axis=1)
        # Rotation matrix -> quaternion (Shepperd's method, w-branch first).
        t = np.trace(m)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            q = np.array(
                [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                 (m[1, 0] - m[0, 1]) / s]
            )
        else:
            i = int(np.argmax(np.diag(m)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
            q = np.zeros(4)
            q[0] = (m[k, j] - m[j, k]) / s
            q[1 + i] = 0.25 * s
            q[1 + j] = (m[j, i] + m[i, j]) / s
            q[1 + k] = (m[k, i] + m[i, k]) / s
        return Camera(
            position=np.asarray(position, dtype=np.float32),
            rotation=math3d.quat_normalize(q).astype(np.float32),
        )


@profiling.spanned("upload")
def cam_vec(camera: Camera, row_offset: float = 0.0, *, device) -> torch.Tensor:
    """f32[8] = (position xyz, rotation wxyz, row_offset) on `device`: the
    camera layout the kernels read. `row_offset` is the first image row of
    the rendered band (0 for a full frame).

    A camera whose position or rotation is a tensor (a pose being fitted)
    gives a tensor built by `torch.cat`, so gradients with respect to the
    vector reach those tensors; they must lie on `device` already."""
    if torch.is_tensor(camera.position) or torch.is_tensor(camera.rotation):
        device = torch.device(device)
        parts = []
        for name, x, n in (("position", camera.position, 3), ("rotation", camera.rotation, 4)):
            if torch.is_tensor(x) and x.device != device:
                raise ValueError(f"camera {name} is on {x.device}, expected {device}")
            parts.append(torch.as_tensor(x, dtype=torch.float32, device=device).reshape(n))
        parts.append(torch.full((1,), float(row_offset), dtype=torch.float32, device=device))
        return torch.cat(parts)
    v = np.concatenate(
        [
            np.asarray(camera.position, np.float32).reshape(3),
            np.asarray(camera.rotation, np.float32).reshape(4),
            np.asarray([row_offset], np.float32),
        ]
    )
    return profiling.uploaded(torch.as_tensor(v, device=device))


class OrbitCameraController:
    """Pitch/yaw/radius orbit rig (reference src/camera.rs:21-85)."""

    def __init__(self, target=(0.0, 0.0, 0.0), radius: float = 5.0):
        self.target = np.asarray(target, dtype=np.float64)
        self.pitch = 0.0
        self.yaw = 0.0
        self.radius = float(radius)
        self.pan_speed = 0.01
        self.yaw_speed = 0.01
        self.pitch_speed = 0.01
        self.dolly_speed = 0.01

    def _rotation(self) -> np.ndarray:
        # from_euler_angles(-pitch, -yaw, 0): roll about x = -pitch, pitch
        # about y = -yaw (reference src/camera.rs:52-54).
        return math3d.quat_from_euler(-self.pitch, -self.yaw, 0.0)

    def camera(self) -> Camera:
        rot = self._rotation()
        position = self.target + math3d.quat_rotate(rot, [0.0, 0.0, 1.0]) * self.radius
        return Camera(
            position=position.astype(np.float32),
            rotation=rot.astype(np.float32),
        )

    def pan(self, dx: float, dy: float) -> None:
        rot = self._rotation()
        right = math3d.quat_rotate(rot, [1.0, 0.0, 0.0])
        up = math3d.quat_rotate(rot, [0.0, 1.0, 0.0])
        self.target = self.target + (right * -dx + up * dy) * self.pan_speed

    def orbit(self, dx: float, dy: float) -> None:
        self.yaw += dx * self.yaw_speed
        self.pitch += dy * self.pitch_speed
        self.pitch = float(np.clip(self.pitch, -1.5, 1.5))

    def dolly(self, delta: float) -> None:
        self.radius += delta * self.dolly_speed * self.radius
        self.radius = max(self.radius, 0.1)
