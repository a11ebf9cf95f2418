"""Scene data on the device and the plain scene evaluator of the kernels.

The kernels' shared device function is `csrc/scene_eval.cuh`; this module
holds what surrounds it:

- `SceneBuffers` / `scene_buffers`: a scene's tape topology (fixed per
  `TapeSpec`) and its numeric arrays (uploaded per frame), as tensors on one
  device.
- `scene_plain`: the same distance in plain torch, per leaf in the f32 op
  order of `raymarch_tpu/ops/pallas_march.py:_leaf_distance_tile` (63-133),
  folded by `sdf._apply_static_tape` as the static branch of
  `_make_scene_eval` (685-707) does. It is the plain version of the kernels'
  scene function and is what the CPU path runs.
- `tet_taps_plain` (`_tet_taps`, 1049) and `compute_bound` (1217), the host
  scene bounding sphere behind `cfg.bound_accel`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import opcodes as oc
from .sdf import _apply_static_tape
from .tape import TapeArrays, TapeSpec

# Bit set in a row's kind when its leaf type carries rotations
# (csrc/scene_eval.cuh ROTATED_BIT).
ROTATED_BIT = 256
MAX_STACK = 32  # csrc/scene_eval.cuh MAX_STACK


def _leaf_static_rows(spec: TapeSpec):
    """Static (row, leaf_type, rotated) list covering every bank row."""
    rows = []
    for t, start, stop in spec.type_slices:
        for r in range(start, stop):
            rows.append((r, t, bool(spec.rotated_types[t])))
    return rows


@dataclasses.dataclass(frozen=True)
class SceneBuffers:
    """One scene on one device.

    tape:        i32[3, n_instr]: opcodes, leaf rows, stack slots of the
                 static tape (fixed per TapeSpec).
    row_kind:    i32[n_leaves]: leaf type | ROTATED_BIT (fixed per TapeSpec).
    leaf_params: f32[n_leaves, 16] (per frame).
    op_param:    f32[TapeSpec.n_instr] (per frame).
    """

    spec: TapeSpec
    tape: torch.Tensor
    row_kind: torch.Tensor
    leaf_params: torch.Tensor
    op_param: torch.Tensor

    @property
    def n_instr(self) -> int:
        return len(self.spec.static_tape)


def scene_topology(spec: TapeSpec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(tape, row_kind) tensors of a static spec on `device`."""
    if spec.static_tape is None:
        raise NotImplementedError(
            "dynamic tapes are not ported yet (ROADMAP §1.12 dynamic tape, "
            "tiered runtime and viewer); compile with static=True"
        )
    if spec.stack_depth > MAX_STACK:
        raise ValueError(
            f"stack depth {spec.stack_depth} exceeds the kernels' {MAX_STACK}"
        )
    n = len(spec.static_tape)
    tape = np.zeros((3, max(n, 1)), np.int32)
    if n:
        tape[:, :n] = np.asarray(spec.static_tape, np.int32).T
    kind = np.zeros(spec.n_leaves, np.int32)
    for r, t, rot in _leaf_static_rows(spec):
        kind[r] = t | (ROTATED_BIT if rot else 0)
    return (
        torch.as_tensor(tape, device=device),
        torch.as_tensor(kind, device=device),
    )


def scene_buffers(spec: TapeSpec, arrays: TapeArrays, device, topology=None) -> SceneBuffers:
    """Upload `arrays` for `spec` to `device`; `topology` reuses the
    (tape, row_kind) pair of an earlier `scene_topology` call."""
    tape, row_kind = topology if topology is not None else scene_topology(spec, device)
    lp = np.asarray(arrays.leaf_params, np.float32)
    opp = np.asarray(arrays.op_param, np.float32)
    if lp.shape != (spec.n_leaves, oc.LEAF_PARAM_WIDTH) or opp.shape != (spec.n_instr,):
        raise ValueError(
            f"arrays do not fit the spec: leaf_params {lp.shape}, op_param "
            f"{opp.shape} vs ({spec.n_leaves}, {oc.LEAF_PARAM_WIDTH}), ({spec.n_instr},)"
        )
    return SceneBuffers(
        spec=spec,
        tape=tape,
        row_kind=row_kind,
        leaf_params=torch.as_tensor(lp, device=device),
        op_param=torch.as_tensor(opp, device=device),
    )


def _leaf_distance_plain(P, ltype, rotated, px, py, pz):
    """Distance of one leaf (bank row P f32[16]) to points (px, py, pz); the
    f32 op order of pallas_march._leaf_distance_tile."""
    x = px - P[4]
    y = py - P[5]
    z = pz - P[6]
    if rotated:
        qw, qx, qy, qz = P[0], -P[1], -P[2], -P[3]
        tx = 2.0 * (qy * z - qz * y)
        ty = 2.0 * (qz * x - qx * z)
        tz = 2.0 * (qx * y - qy * x)
        x, y, z = (
            x + qw * tx + (qy * tz - qz * ty),
            y + qw * ty + (qz * tx - qx * tz),
            z + qw * tz + (qx * ty - qy * tx),
        )
    if ltype == oc.LEAF_SPHERE:
        return torch.sqrt(x * x + y * y + z * z + 1e-20) - P[7]
    if ltype == oc.LEAF_BOX:
        qx_ = torch.abs(x) - P[7]
        qy_ = torch.abs(y) - P[8]
        qz_ = torch.abs(z) - P[9]
        ox = torch.clamp_min(qx_, 0.0)
        oy = torch.clamp_min(qy_, 0.0)
        oz = torch.clamp_min(qz_, 0.0)
        outside = torch.sqrt(ox * ox + oy * oy + oz * oz + 1e-20)
        inside = torch.clamp_max(torch.maximum(qx_, torch.maximum(qy_, qz_)), 0.0)
        return outside + inside
    if ltype == oc.LEAF_PLANE:
        return px * P[7] + py * P[8] + pz * P[9] + P[10]
    if ltype == oc.LEAF_TORUS:
        ring = torch.sqrt(x * x + z * z + 1e-20) - P[7]
        return torch.sqrt(ring * ring + y * y + 1e-20) - P[8]
    if ltype == oc.LEAF_CYLINDER:
        qx = torch.sqrt(x * x + z * z + 1e-20) - P[7]
        qy = torch.abs(y) - P[8]
        ox_ = torch.clamp_min(qx, 0.0)
        oy_ = torch.clamp_min(qy, 0.0)
        return torch.sqrt(ox_ * ox_ + oy_ * oy_ + 1e-20) + torch.clamp_max(
            torch.maximum(qx, qy), 0.0
        )
    if ltype == oc.LEAF_CAPSULE:
        h = P[8]
        yy = y - torch.minimum(torch.maximum(y, -h), h)
        return torch.sqrt(x * x + yy * yy + z * z + 1e-20) - P[7]
    if ltype == oc.LEAF_CONE:
        h, r1, r2 = P[7], P[8], P[9]
        qx = torch.sqrt(x * x + z * z + 1e-20)
        k2x = r2 - r1
        k2y = 2.0 * h
        cax = qx - torch.minimum(qx, torch.where(y < 0.0, r1, r2))
        cay = torch.abs(y) - h
        denom = torch.clamp_min(k2x * k2x + k2y * k2y, 1e-20)
        tt = torch.clamp(((r2 - qx) * k2x + (h - y) * k2y) / denom, 0.0, 1.0)
        cbx = qx - r2 + k2x * tt
        cby = y - h + k2y * tt
        s = torch.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0)
        return s * torch.sqrt(
            torch.minimum(cax * cax + cay * cay, cbx * cbx + cby * cby) + 1e-20
        )
    raise ValueError(f"unknown leaf type {ltype}")


def scene_plain(scene: SceneBuffers, max_dist: float, px, py, pz):
    """Scene distance at points (px, py, pz) of any one shape, in plain
    torch: the plain version of `scene_distance` in csrc/scene_eval.cuh."""
    row_types = {r: (t, rot) for r, t, rot in _leaf_static_rows(scene.spec)}
    lp = scene.leaf_params

    def leaf_fn(row):
        t, rot = row_types[row]
        return _leaf_distance_plain(lp[row], t, rot, px, py, pz)

    return _apply_static_tape(scene.spec, scene.op_param, leaf_fn, max_dist, px)


_TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


def tet_taps_plain(scene_fn, px, py, pz, eps: float):
    """Tetrahedron normal-gradient taps (reference wgsl:135-144): the
    unnormalized sum over the 4 even-parity cube corners k of
    k * scene(p + k*eps), accumulated in the order of the kernels."""
    nx = px * 0.0
    ny = nx
    nz = nx
    for kx, ky, kz in _TAPS:
        dval = scene_fn(px + kx * eps, py + ky * eps, pz + kz * eps)
        nx = nx + kx * dval
        ny = ny + ky * dval
        nz = nz + kz * dval
    return nx, ny, nz


def compute_bound(spec: TapeSpec, arrays: TapeArrays) -> np.ndarray:
    """Conservative scene bounding sphere -> f32[8] = (cx,cy,cz,R,valid,0,0,0).

    Host numpy f32 over the leaf banks, recomputed per frame so numeric
    edits move it. Per-leaf conservative radius: sphere r; box |he|; torus
    R+r; cylinder |(r, h)|; capsule r+h; cone |(max r, h)|. Smooth/round/onion
    params can push the surface outward, so the sum of |op_param| is added.
    Planes are unbounded => valid=0 and the acceleration turns itself off.
    """
    f32 = np.float32
    pushed = None
    if spec.static_tape is not None:
        pushed = {arg for cop, arg, _ in spec.static_tape if cop == oc.COP_PUSH}
    rows = []
    has_plane = False
    for t, start, stop in spec.type_slices:
        for r in range(start, stop):
            if pushed is not None and r not in pushed:
                continue
            has_plane |= t == oc.LEAF_PLANE
            rows.append((r, t))
    if not rows or has_plane:
        return np.zeros(8, f32)

    lp = np.asarray(arrays.leaf_params, f32)
    idx = np.asarray([r for r, _ in rows])
    types = np.asarray([t for _, t in rows])
    centers = lp[idx, 4:7]
    p7, p8, p9 = lp[idx, 7], lp[idx, 8], lp[idx, 9]
    radii = np.select(
        [
            types == oc.LEAF_SPHERE,
            types == oc.LEAF_BOX,
            types == oc.LEAF_TORUS,
            types == oc.LEAF_CYLINDER,
            types == oc.LEAF_CAPSULE,
            types == oc.LEAF_CONE,
        ],
        [
            p7,
            np.sqrt(np.sum(lp[idx, 7:10] ** 2, axis=-1)),
            p7 + p8,
            np.sqrt(p7 * p7 + p8 * p8),
            p7 + p8,
            np.sqrt(np.maximum(p8, p9) ** 2 + p7 * p7),
        ],
        default=p7,
    ).astype(f32)
    center = centers.mean(axis=0, dtype=f32)
    expand = np.sum(np.abs(np.asarray(arrays.op_param, f32)), dtype=f32)
    spread = np.sqrt(np.sum((centers - center) ** 2, axis=-1, dtype=f32))
    radius = f32(np.max(spread + radii)) + expand + f32(0.05)
    out = np.zeros(8, f32)
    out[0:3] = center
    out[3] = radius
    out[4] = 1.0
    return out
