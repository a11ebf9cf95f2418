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
- `tet_taps_plain` (`_tet_taps`, 1049) and `compute_bound` /
  `compute_bound_torch` (1217), the scene bounding sphere behind
  `cfg.bound_accel`, computed in torch on the parameters' device.
"""

from __future__ import annotations

import dataclasses
import functools

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


def _device_array(name: str, x, device) -> torch.Tensor:
    """`x` as an f32 tensor on `device`: a numpy array (or list) is uploaded;
    a tensor must already lie on `device` and is used detached, with no
    host round trip."""
    if torch.is_tensor(x):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected torch.float32")
        return x.detach().contiguous()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def scene_buffers(spec: TapeSpec, arrays: TapeArrays, device, topology=None) -> SceneBuffers:
    """`arrays` for `spec` on `device`; `topology` reuses the (tape,
    row_kind) pair of an earlier `scene_topology` call. Parameters given as
    numpy arrays are uploaded; tensors must lie on `device` already."""
    device = torch.device(device)
    tape, row_kind = topology if topology is not None else scene_topology(spec, device)
    lp = _device_array("leaf_params", arrays.leaf_params, device)
    opp = _device_array("op_param", arrays.op_param, device)
    if tuple(lp.shape) != (spec.n_leaves, oc.LEAF_PARAM_WIDTH) or tuple(opp.shape) != (spec.n_instr,):
        raise ValueError(
            f"arrays do not fit the spec: leaf_params {tuple(lp.shape)}, op_param "
            f"{tuple(opp.shape)} vs ({spec.n_leaves}, {oc.LEAF_PARAM_WIDTH}), ({spec.n_instr},)"
        )
    return SceneBuffers(spec=spec, tape=tape, row_kind=row_kind, leaf_params=lp, op_param=opp)


class _SqrtRN(torch.autograd.Function):
    """f32 sqrt through f64: rounded to nearest (53 >= 2 * 24 + 2 bits, so
    the double rounding is exact), with torch's own backward formula."""

    @staticmethod
    def forward(ctx, x):
        r = torch.sqrt(x.double()).to(torch.float32)
        ctx.save_for_backward(r)
        return r

    @staticmethod
    def backward(ctx, g):
        (r,) = ctx.saved_tensors
        return g / (2.0 * r)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 square root rounded to nearest on every device, as the kernels'
    `sqrtf` and numpy's are. torch's CUDA sqrt is; its CPU sqrt is not (it
    misses on ~0.7% of random inputs), and the backward's replay at taps
    that straddle a crease turns such bits into percent-level gradient
    differences."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _SqrtRN.apply(x)
    return torch.sqrt(x.double()).to(torch.float32)


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
        return sqrt_rn(x * x + y * y + z * z + 1e-20) - P[7]
    if ltype == oc.LEAF_BOX:
        qx_ = torch.abs(x) - P[7]
        qy_ = torch.abs(y) - P[8]
        qz_ = torch.abs(z) - P[9]
        ox = torch.clamp_min(qx_, 0.0)
        oy = torch.clamp_min(qy_, 0.0)
        oz = torch.clamp_min(qz_, 0.0)
        outside = sqrt_rn(ox * ox + oy * oy + oz * oz + 1e-20)
        inside = torch.clamp_max(torch.maximum(qx_, torch.maximum(qy_, qz_)), 0.0)
        return outside + inside
    if ltype == oc.LEAF_PLANE:
        return px * P[7] + py * P[8] + pz * P[9] + P[10]
    if ltype == oc.LEAF_TORUS:
        ring = sqrt_rn(x * x + z * z + 1e-20) - P[7]
        return sqrt_rn(ring * ring + y * y + 1e-20) - P[8]
    if ltype == oc.LEAF_CYLINDER:
        qx = sqrt_rn(x * x + z * z + 1e-20) - P[7]
        qy = torch.abs(y) - P[8]
        ox_ = torch.clamp_min(qx, 0.0)
        oy_ = torch.clamp_min(qy, 0.0)
        return sqrt_rn(ox_ * ox_ + oy_ * oy_ + 1e-20) + torch.clamp_max(
            torch.maximum(qx, qy), 0.0
        )
    if ltype == oc.LEAF_CAPSULE:
        h = P[8]
        yy = y - torch.minimum(torch.maximum(y, -h), h)
        return sqrt_rn(x * x + yy * yy + z * z + 1e-20) - P[7]
    if ltype == oc.LEAF_CONE:
        h, r1, r2 = P[7], P[8], P[9]
        qx = sqrt_rn(x * x + z * z + 1e-20)
        k2x = r2 - r1
        k2y = 2.0 * h
        cax = qx - torch.minimum(qx, torch.where(y < 0.0, r1, r2))
        cay = torch.abs(y) - h
        denom = torch.clamp_min(k2x * k2x + k2y * k2y, 1e-20)
        tt = torch.clamp(((r2 - qx) * k2x + (h - y) * k2y) / denom, 0.0, 1.0)
        cbx = qx - r2 + k2x * tt
        cby = y - h + k2y * tt
        s = torch.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0)
        return s * sqrt_rn(
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


@functools.lru_cache(maxsize=None)
def _bound_rows(spec: TapeSpec):
    """(rows, types) of the leaves the bound covers, or None when it is
    invalid (no leaf, or a plane: unbounded)."""
    pushed = None
    if spec.static_tape is not None:
        pushed = {arg for cop, arg, _ in spec.static_tape if cop == oc.COP_PUSH}
    rows = []
    for t, start, stop in spec.type_slices:
        for r in range(start, stop):
            if pushed is not None and r not in pushed:
                continue
            if t == oc.LEAF_PLANE:
                return None
            rows.append((r, t))
    if not rows:
        return None
    return tuple(r for r, _ in rows), tuple(t for _, t in rows)


@functools.lru_cache(maxsize=None)
def _bound_index(spec: TapeSpec, device: torch.device):
    """`_bound_rows` as tensors on `device` (rows i64[n], types i32[n, 1]),
    uploaded once per (spec, device) rather than every frame."""
    got = _bound_rows(spec)
    if got is None:
        return None
    rows, types = got
    return (torch.as_tensor(rows, dtype=torch.int64, device=device),
            torch.as_tensor(types, dtype=torch.int32, device=device)[:, None])


def compute_bound_torch(spec: TapeSpec, leaf_params: torch.Tensor, op_param: torch.Tensor) -> torch.Tensor:
    """Conservative scene bounding sphere -> f32[8] = (cx,cy,cz,R,valid,0,0,0)
    on the parameters' device, from tensors, with no host synchronisation.

    Recomputed per frame from the current parameters, so numeric edits (and
    fit steps) move it. Per-leaf conservative radius: sphere r; box |he|;
    torus R+r; cylinder |(r, h)|; capsule r+h; cone |(max r, h)|.
    Smooth/round/onion params can push the surface outward, so the sum of
    |op_param| is added. Planes are unbounded => valid=0 and the
    acceleration turns itself off. The bound carries no gradient.

    Sums over leaves and instructions run in f64 and round once to f32, and
    3-vectors add in index order, so the numbers do not depend on a
    library's reduction order: `compute_bound` computes the same in numpy.
    """
    dev = leaf_params.device
    got = _bound_index(spec, dev)
    if got is None:
        return torch.zeros(8, dtype=torch.float32, device=dev)
    rows, types = got
    lp = leaf_params.detach()[rows]
    centers = lp[:, 4:7]
    p7, p8, p9 = lp[:, 7:8], lp[:, 8:9], lp[:, 9:10]
    pm = torch.maximum(p8, p9)
    choices = (
        (oc.LEAF_BOX, torch.sqrt(p7 * p7 + p8 * p8 + p9 * p9)),
        (oc.LEAF_TORUS, p7 + p8),
        (oc.LEAF_CYLINDER, torch.sqrt(p7 * p7 + p8 * p8)),
        (oc.LEAF_CAPSULE, p7 + p8),
        (oc.LEAF_CONE, torch.sqrt(pm * pm + p7 * p7)),
    )
    radii = p7  # spheres, and the default
    for t, r in choices:
        radii = torch.where(types == t, r, radii)
    n = torch.full((), centers.shape[0], dtype=torch.float64, device=dev)
    center = (torch.sum(centers.double(), dim=0) / n).float()
    expand = torch.sum(torch.abs(op_param.detach()).double()).float()
    dc = centers - center
    spread = torch.sqrt(dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1] + dc[:, 2] * dc[:, 2])
    radius = torch.max(spread + radii[:, 0]) + expand + 0.05
    one = torch.ones(1, dtype=torch.float32, device=dev)
    return torch.cat([center, radius[None], one, torch.zeros(3, dtype=torch.float32, device=dev)])


def compute_bound(spec: TapeSpec, arrays: TapeArrays) -> np.ndarray:
    """The bound of `compute_bound_torch` in host numpy f32 -> f32[8]. On CPU
    tensors the torch form gives these numbers bit for bit (a frame rendered
    from numpy parameters and one rendered from tensors start their marches
    at the same t)."""
    f32 = np.float32
    got = _bound_rows(spec)
    if got is None:
        return np.zeros(8, f32)
    idx, types = (np.asarray(v) for v in got)
    lp = np.asarray(arrays.leaf_params, f32)
    centers = lp[idx, 4:7]
    p7, p8, p9 = lp[idx, 7], lp[idx, 8], lp[idx, 9]
    pm = np.maximum(p8, p9)
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
            np.sqrt(p7 * p7 + p8 * p8 + p9 * p9),
            p7 + p8,
            np.sqrt(p7 * p7 + p8 * p8),
            p7 + p8,
            np.sqrt(pm * pm + p7 * p7),
        ],
        default=p7,
    ).astype(f32)
    center = (centers.astype(np.float64).sum(axis=0) / len(idx)).astype(f32)
    expand = f32(np.abs(np.asarray(arrays.op_param, f32)).astype(np.float64).sum())
    dc = centers - center
    spread = np.sqrt(dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1] + dc[:, 2] * dc[:, 2])
    radius = f32(np.max(spread + radii)) + expand + f32(0.05)
    out = np.zeros(8, f32)
    out[0:3] = center
    out[3] = radius
    out[4] = 1.0
    return out
