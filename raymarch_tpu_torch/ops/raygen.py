"""Ray generation: perspective camera -> per-pixel (AA-subsampled) rays.

Reference semantics: fullscreen quad in screen space ([-1,1]^2, y up), each
fragment unprojects `(pt_screen, z=-1)` through `inv_proj` then `inv_view`,
ray origin is the camera position, AA offsets form a uniform
`aa_samples x aa_samples` sub-pixel grid (reference
src/ray_marching/ray_marching.wgsl:36-65 and renderer.rs:206-211).

- `camera_rays_np`: NumPy, via the explicit inverse-projection / inverse-view
  matrices (copied from `raymarch_tpu.ops.raygen`).
- `raygen_flat`: torch, matrix-free — directions come straight from
  `tan(fovy/2)` in view space rotated by the camera quaternion, computed
  from flat ray indices in pixel-major order.

Image convention: row 0 = top of image (screen y = +1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..utils import math3d
from .sdf import quat_rotate


def aa_offsets(n: int) -> np.ndarray:
    """Sub-pixel offsets in pixel units, (-0.5, 0.5) uniform grid
    (reference wgsl:46-52): [(i+0.5)/n - 0.5 for i in range(n)]."""
    return (np.arange(n) + 0.5) / n - 0.5


def camera_rays_np(camera, width: int, height: int, cfg: RenderConfig = DEFAULT_CONFIG):
    """NumPy spec-path raygen -> (origins[S,H,W,3], dirs[S,H,W,3]), S=aa^2."""
    n = cfg.aa_samples
    aspect = width / height
    inv_proj = np.linalg.inv(
        math3d.perspective_matrix(aspect, cfg.fovy, cfg.near, cfg.far)
    )
    inv_view = np.linalg.inv(camera.view())

    xs = 2.0 * (np.arange(width) + 0.5) / width - 1.0  # [W]
    ys = 1.0 - 2.0 * (np.arange(height) + 0.5) / height  # [H], row 0 = top
    off = aa_offsets(n)
    dx = off * 2.0 / width  # [n]
    dy = off * 2.0 / height

    # Screen points [S, H, W, 2].
    sx = xs[None, None, :] + dx.repeat(n)[:, None, None]
    sy = ys[None, :, None] + np.tile(dy, n)[:, None, None]
    sx, sy = np.broadcast_arrays(sx, sy)

    ndc = np.stack(
        [sx, sy, -np.ones_like(sx), np.ones_like(sx)], axis=-1
    )  # [S,H,W,4]
    pt_view = ndc @ inv_proj.T
    pt_view = pt_view / pt_view[..., 3:4]
    pt_world = pt_view @ inv_view.T

    ro = inv_view[:3, 3]
    d = pt_world[..., :3] - ro
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    origins = np.broadcast_to(ro, d.shape).astype(np.float32)
    return origins.copy(), d.astype(np.float32)


def _f32(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def raygen_flat(
    ray_idx: torch.Tensor,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
):
    """Rays from flat indices -> (origins[N,3], dirs[N,3]) f32 on
    `ray_idx.device`.

    Ray index order is PIXEL-MAJOR: r = (i*W + j)*S + s with S = aa^2 and
    s = a*aa_samples + b (a indexes x-offsets, b indexes y-offsets), so all
    AA samples of one pixel are adjacent.
    """
    dev = ray_idx.device
    n = cfg.aa_samples
    S = n * n
    r = ray_idx.to(torch.int64)
    p = r // S
    s = r - p * S
    i = p // width
    j = p - i * width
    a = s // n
    b = s - a * n

    fa = (a.to(torch.float32) + 0.5) / n - 0.5
    fb = (b.to(torch.float32) + 0.5) / n - 0.5
    x = 2.0 * (j.to(torch.float32) + 0.5) / width - 1.0 + fa * 2.0 / width
    y = 1.0 - 2.0 * (i.to(torch.float32) + 0.5) / height + fb * 2.0 / height

    t = math.tan(cfg.fovy / 2.0)
    aspect = width / height
    d_view = torch.stack([x * (t * aspect), y * t, -torch.ones_like(x)], dim=-1)
    d_view = d_view / torch.linalg.vector_norm(d_view, dim=-1, keepdim=True)
    rot = _f32(cam_rotation, dev)
    pos = _f32(cam_position, dev)
    d_world = quat_rotate(rot[None, :], d_view)
    origins = pos.expand_as(d_world)
    return origins, d_world
