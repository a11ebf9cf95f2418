"""Scene data on the device and the plain scene evaluator of the kernels.

The kernels' shared device function is `csrc/scene_eval.cuh`; this module
holds what surrounds it:

- `SceneBuffers` / `scene_buffers`: a scene's tape topology (fixed per
  `TapeSpec`; a dynamic spec's tape comes with each frame's arrays), its
  packed scene words (`pack_words`: what K1/K2 and the backwards read, one
  16-byte word per instruction) and its numeric arrays (uploaded per
  frame), as tensors on one device. `stack_route` picks K1/K2's value-stack
  route from the spec's stack depth; `scene_words_plain` is the plain
  version of their evaluator, reading exactly the packed words on that
  route.
- `scene_plain`: the same distance in plain torch, per leaf in the f32 op
  order of `raymarch_tpu/ops/pallas_march.py:_leaf_distance_tile` (63-133),
  folded by `sdf._apply_static_tape` as the static branch of
  `_make_scene_eval` (685-707) does, or by the stack machine of
  `sdf._apply_dynamic_tape` (a dynamic tape). It is the plain version of
  the kernels' scene function and is what the CPU path runs.
- `tet_taps_plain` (`_tet_taps`, 1049) and `compute_bound` /
  `compute_bound_torch` (1217), the scene bounding sphere behind
  `cfg.bound_accel`, computed in torch on the parameters' device.
- The segmented compact plan (`build_compact_plan`, 249-438, with
  `_pack_seg_entry`, `_lin_subtree`, `_split_sensitive`, copied), its
  device form (`PlanBuffers`), and `scene_compact_plain`, the plain version
  of `compact_fold` in csrc/scene_eval.cuh (the O(active)
  evaluator `_make_scene_eval_compact`, 493-660, over per-tile lists).
- The flat march kernels K5, K6 and K7 (csrc/march.cuh, over the packed
  words as K1/K2): their wrappers (`ray_march`, `image_march`,
  `image_render`, and `image_pixels`, K7's build that takes each pixel's
  AA mean), plain versions and the reference's factories
  (`make_pallas_ray_march`, `make_pallas_image_march`, `make_march_pallas`,
  `make_pallas_image_render`), with `make_pallas_pixel_render` for the
  "pallas_full" frame.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..utils import profiling
from . import opcodes as oc
from .sdf import _apply_dynamic_tape, _apply_static_tape, _static_tree
from .tape import TapeArrays, TapeSpec

# Bit set in a row's kind when its leaf type carries rotations
# (csrc/scene_eval.cuh ROTATED_BIT).
ROTATED_BIT = 256
MAX_STACK = 32  # csrc/scene_eval.cuh MAX_STACK
# The value stack's routes of K1/K2 (csrc/scene_eval.cuh REG_STACK,
# STK_SMEM): the slot below the stack's top in a register (stack depth <=
# REG_STACK), or the slots below the top in shared memory.
REG_STACK = 2
STK_SMEM = 0


def _leaf_static_rows(spec: TapeSpec):
    """Static (row, leaf_type, rotated) list covering every bank row."""
    rows = []
    for t, start, stop in spec.type_slices:
        for r in range(start, stop):
            rows.append((r, t, bool(spec.rotated_types[t])))
    return rows


@functools.lru_cache(maxsize=64)
def row_kinds(spec: TapeSpec) -> np.ndarray:
    """i32[n_leaves] (read-only): each bank row's leaf type | ROTATED_BIT
    (the bucket's padding rows too)."""
    kind = np.zeros(spec.n_leaves, np.int32)
    for r, t, rot in _leaf_static_rows(spec):
        kind[r] = t | (ROTATED_BIT if rot else 0)
    kind.setflags(write=False)
    return kind


def pack_words(ops, arg, slot, row_kind, push_slot=None):
    """The packed tape i32[n, 4] (csrc/scene_eval.cuh SceneWords, the
    backwards' BwdTape): per instruction op | slot << 8, the leaf row of a
    PUSH (else 0), that row's kind (else 0) and `push_slot` (the backwards'
    gradient slot of the row; 0 in a forward tape). numpy columns give a
    numpy array; tensors give a tensor on their device, with no host read."""
    if torch.is_tensor(ops):
        ops, arg, slot = (c.to(torch.int32) for c in (ops, arg, slot))
        push = ops == oc.COP_PUSH
        rows = torch.where(push, arg, 0)
        kind = torch.where(push, row_kind[rows.long()], 0)
        last = torch.zeros_like(ops) if push_slot is None else push_slot.to(torch.int32)
        return torch.stack([ops | (slot << 8), rows, kind, last], dim=1).contiguous()
    ops, arg, slot = (np.asarray(c, np.int32) for c in (ops, arg, slot))
    push = ops == oc.COP_PUSH
    rows = np.where(push, arg, 0).astype(np.int32)
    kind = np.where(push, np.asarray(row_kind, np.int32)[rows], 0)
    last = np.zeros_like(ops) if push_slot is None else np.asarray(push_slot, np.int32)
    return np.stack([ops | (slot << 8), rows, kind, last], axis=1).astype(np.int32)


def stack_route(spec: TapeSpec) -> int:
    """K1/K2's value-stack route for `spec`'s stack depth (the dynamic
    tape's bucket depth for a dynamic spec): REG_STACK (depth <= 2: the
    slot below the top in a register) or STK_SMEM (deeper: the slots below
    the top in shared memory, 4 * (depth - 1) bytes a thread, four times
    that for the colour walk). Shared memory beat registers selected by the
    slot at depths 4 and 8 on the H100, the register beat shared memory by
    2-4% at depth 2 (PERF.md §6).

    A dynamic spec's frame tapes must keep every slot below
    `spec.stack_depth`: the kernels size the route's slots by it.
    `scene_buffers` checks a tape given as numpy arrays and raises; a tape
    given as tensors is not read to the host, so that is the caller's
    contract (any tape compiled for the spec keeps it)."""
    return REG_STACK if spec.stack_depth <= REG_STACK else STK_SMEM


def route_name(route: int) -> str:
    return "shared memory" if route == STK_SMEM else "a register"


@dataclasses.dataclass(frozen=True)
class SceneBuffers:
    """One scene on one device.

    tape:        i32[3, n_instr]: opcodes, leaf rows, stack slots: of the
                 static tape (fixed per TapeSpec), or of a dynamic spec the
                 frame's `tape_ops`, `tape_arg`, `out_slot` (per frame).
    row_kind:    i32[n_leaves]: leaf type | ROTATED_BIT (fixed per TapeSpec).
    leaf_params: f32[n_leaves, 16] (per frame).
    op_param:    f32[TapeSpec.n_instr] (per frame).
    words:       i32[n_instr, 4]: the tape packed by `pack_words` (per
                 TapeSpec, or per frame for a dynamic spec); what K1/K2
                 and K5-K7 read, on the stack route `route`. None where no
                 such kernel runs.
    """

    spec: TapeSpec
    tape: torch.Tensor
    row_kind: torch.Tensor
    leaf_params: torch.Tensor
    op_param: torch.Tensor
    words: torch.Tensor | None = None

    @property
    def dynamic(self) -> bool:
        return self.spec.static_tape is None

    @property
    def n_instr(self) -> int:
        """Instructions the kernels run: the static tape's, or a dynamic
        tape's whole bucket (NOP padding included)."""
        return self.spec.n_instr if self.dynamic else len(self.spec.static_tape)

    @property
    def route(self) -> int:
        """The value stack's route of the kernels that read `words`
        (`stack_route`)."""
        return stack_route(self.spec)


def scene_topology(spec: TapeSpec, device) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
    """(tape, row_kind, words) tensors of a spec on `device`. A dynamic
    spec has no fixed tape or words (None: they come with each frame's
    arrays); its row kinds cover every row of `spec.type_slices`, the
    bucket's padding rows too."""
    if spec.stack_depth > MAX_STACK:
        raise ValueError(
            f"stack depth {spec.stack_depth} exceeds the kernels' {MAX_STACK}"
        )
    kind = np.array(row_kinds(spec))  # a writable copy of the cached array
    if spec.static_tape is None:
        return None, torch.as_tensor(kind, device=device), None
    n = len(spec.static_tape)
    tape = np.zeros((3, max(n, 1)), np.int32)
    if n:
        tape[:, :n] = np.asarray(spec.static_tape, np.int32).T
    return (
        torch.as_tensor(tape, device=device),
        torch.as_tensor(kind, device=device),
        torch.as_tensor(pack_words(*tape, kind), device=device),
    )


def _dynamic_tape(spec: TapeSpec, arrays: TapeArrays, device, row_kind: torch.Tensor):
    """The frame's dynamic tape i32[3, n_instr] (opcodes, leaf rows, stack
    slots) and its packed words i32[n_instr, 4] on `device`: numpy arrays
    are packed on the host and uploaded in one buffer, after checking that
    no slot passes the spec's stack depth (`stack_route`); tensors must lie
    on `device` already and are stacked and packed there, with no host
    read."""
    cols = (arrays.tape_ops, arrays.tape_arg, arrays.out_slot)
    n = spec.n_instr
    if any(torch.is_tensor(c) for c in cols):
        for c in cols:
            if not torch.is_tensor(c) or c.device != device:
                raise ValueError(f"the dynamic tape's arrays must all be tensors on {device}")
        tape = torch.stack([c.to(torch.int32) for c in cols])
        if tuple(tape.shape) != (3, n):
            raise ValueError(f"the dynamic tape has shape {tuple(tape.shape)}, expected (3, {n})")
        return tape, pack_words(*tape, row_kind)
    tape = np.stack([np.asarray(c, np.int32) for c in cols])
    if tape.shape != (3, n):
        raise ValueError(f"the dynamic tape has shape {tape.shape}, expected (3, {n})")
    deepest = int(tape[2][tape[0] != oc.COP_NOP].max(initial=0))
    if deepest >= spec.stack_depth:
        raise ValueError(f"the dynamic tape writes stack slot {deepest}, past the spec's depth {spec.stack_depth}")
    # The words first, so that they start 16-byte aligned.
    words = pack_words(*tape, row_kinds(spec))
    buf = profiling.uploaded(torch.as_tensor(np.concatenate([words.ravel(), tape.ravel()]), device=device))
    return buf[4 * n:].view(3, n), buf[: 4 * n].view(n, 4)


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
    return profiling.uploaded(torch.as_tensor(np.asarray(x, np.float32), device=device))


def scene_buffers(spec: TapeSpec, arrays: TapeArrays, device, topology=None) -> SceneBuffers:
    """`arrays` for `spec` on `device`; `topology` reuses the (tape,
    row_kind) pair of an earlier `scene_topology` call. Parameters given as
    numpy arrays are uploaded; tensors must lie on `device` already."""
    device = torch.device(device)
    tape, row_kind, words = topology if topology is not None else scene_topology(spec, device)
    if spec.static_tape is None:
        tape, words = _dynamic_tape(spec, arrays, device, row_kind)
    lp = _device_array("leaf_params", arrays.leaf_params, device)
    opp = _device_array("op_param", arrays.op_param, device)
    if tuple(lp.shape) != (spec.n_leaves, oc.LEAF_PARAM_WIDTH) or tuple(opp.shape) != (spec.n_instr,):
        raise ValueError(
            f"arrays do not fit the spec: leaf_params {tuple(lp.shape)}, op_param "
            f"{tuple(opp.shape)} vs ({spec.n_leaves}, {oc.LEAF_PARAM_WIDTH}), ({spec.n_instr},)"
        )
    return SceneBuffers(spec=spec, tape=tape, row_kind=row_kind, leaf_params=lp, op_param=opp, words=words)


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


def scene_plain(scene: SceneBuffers, max_dist: float, px, py, pz, cull=None):
    """Scene distance at points (px, py, pz) of any one shape, in plain
    torch: the plain version of `words_distance` in csrc/scene_eval.cuh.
    `cull(row)` (a bool tensor like the points) gates leaves as the tile
    mask of the kernel's gated tape does (`sdf._apply_static_tape`). A
    dynamic scene runs its tape (read to the host) on the reference's stack
    machine (`sdf._apply_dynamic_tape`, gated the same way), the plain
    version of the kernels' DYN interpreter."""
    row_types = {r: (t, rot) for r, t, rot in _leaf_static_rows(scene.spec)}
    lp = scene.leaf_params

    def leaf_fn(row):
        t, rot = row_types.get(row, (oc.LEAF_SPHERE, False))
        return _leaf_distance_plain(lp[row], t, rot, px, py, pz)

    if scene.dynamic:
        return _apply_dynamic_tape(_host_tape(scene), scene.op_param, leaf_fn, max_dist, px,
                                   scene.spec.stack_depth, cull=cull)
    return _apply_static_tape(scene.spec, scene.op_param, leaf_fn, max_dist, px, cull=cull)


def _host_tape(scene: SceneBuffers) -> list:
    """A dynamic scene's tape as host tuples (op, arg, slot)."""
    return [tuple(c) for c in scene.tape.T.tolist()]


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


# --- segmented O(active) compaction plan (pallas_march.py:136-446) ---------
#
# The static tape is segmented into maximal subtrees expressible as a
# left fold acc_0 = FAR; acc_{j+1} = step(acc_j, leaf(row_j), mode_j, k_j)
# with step one of: mode 0 min(acc, d); mode 1 smooth_min(acc, d, k);
# mode 2 max(acc, -d); mode 3 smooth_max(acc, -d, k). Skipping a culled
# item leaves every later step bitwise unchanged (|FAR -+ acc| >= k), which
# is what makes per-tile compacted item lists exact. The residual combine
# structure around the segments is left to the gated tape in the port.

_SEG_PLAIN, _SEG_SMOOTH, _SEG_SUB, _SEG_SSUB = 0, 1, 2, 3


def _pack_seg_entry(row: int, tsel: int, mode: int, sid: int, kidx: int) -> int:
    """List-entry packing: row | tsel<<10 | mode<<13 | sid<<15 | (kidx+1)<<18.
    kidx = -1 marks "no op_param" (hard modes). `sid` is the segment id
    within one stream group; build_compact_plan chunks streams into groups
    of <= 8 segments so that sids are unique in a group (culling can make
    any two of a group's segments adjacent in a compacted list)."""
    if not (0 <= row < 1024 and 0 <= tsel < 8 and 0 <= mode < 4
            and 0 <= sid < 8 and -1 <= kidx < (1 << 13) - 1):
        raise ValueError(f"entry out of range: {(row, tsel, mode, sid, kidx)}")
    return (
        row | (tsel << 10) | (mode << 13) | (sid << 15) | ((kidx + 1) << 18)
    )


def _lin_subtree(node):
    """Try to linearize a static-tree node into fold items.

    Returns (items, sensitive) with items = [(row, kidx, mode)], or None
    when the subtree has no exact fold."""
    kind, i, payload, _rows = node
    if kind == "leaf":
        return [(payload, -1, _SEG_PLAIN)], False
    if kind == oc.COP_UNION:
        la = _lin_subtree(payload[0])
        lb = _lin_subtree(payload[1])
        if la is None or lb is None:
            return None
        ia, sa = la
        ib, sb = lb
        if sa and sb:
            return None
        if sb:
            ia, ib, sa = ib, ia, sb
        return ia + ib, sa
    if kind == oc.COP_SMOOTH_UNION:
        b = payload[1]
        if b[0] != "leaf":
            return None
        la = _lin_subtree(payload[0])
        if la is None:
            return None
        return la[0] + [(b[2], i, _SEG_SMOOTH)], True
    if kind == oc.COP_SUBTRACTION:
        lb = _lin_subtree(payload[1])
        if lb is None or lb[1]:  # right side must be plain-union items
            return None
        la = _lin_subtree(payload[0])
        if la is None:
            return None
        return la[0] + [(r, -1, _SEG_SUB) for (r, _k, _m) in lb[0]], True
    if kind == oc.COP_SMOOTH_SUBTRACTION:
        b = payload[1]
        if b[0] != "leaf":
            return None
        la = _lin_subtree(payload[0])
        if la is None:
            return None
        return la[0] + [(b[2], i, _SEG_SSUB)], True
    return None


def _split_sensitive(items):
    """items -> (plain_prefix, sensitive_middle, plain_suffix)."""
    sens = [j for j, (_r, _k, m) in enumerate(items) if m != _SEG_PLAIN]
    if not sens:
        return items, [], []
    return items[: sens[0]], items[sens[0] : sens[-1] + 1], items[sens[-1] + 1 :]


@functools.lru_cache(maxsize=None)
def build_compact_plan(spec: TapeSpec):
    """Static analysis: tape -> compact plan dict, or None.

    Plan layout (all leaf/row/op content static; only the per-tile active
    sets are run-time data):
      pool     - group indices of the global free pool: every root-level
                 hard-union operand that folds to plain items, plus the
                 plain suffixes of sensitive root operands.
      seg1     - single sensitive root operand: its plain prefix as free
                 groups + one ordered group.
      stream   - >= 2 sensitive root operands: sid-tagged ordered groups of
                 <= 8 segments each; a segment's fold is flushed into the
                 running min at each sid change.
      residual_ops - root operands with no exact fold (intersections,
                 round/onion, double-sensitive unions); in the port such a
                 plan takes the gated tape.

    Returns None when the scene has no static tape or segmentation covers
    too few leaves to pay for itself.
    """
    if not spec.static_tape:
        return None
    root = _static_tree(spec)
    if root is None:
        return None

    row_types = {r: (t, rot) for r, t, rot in _leaf_static_rows(spec)}
    groups: list[dict] = []
    segments: list[tuple[int, ...]] = []  # iso segments (group idx tuples)
    offset = 0

    def add_free_groups(items):
        nonlocal offset
        idxs = []
        by_type: dict[int, list[int]] = {}
        for row, _k, _m in items:
            by_type.setdefault(row_types[row][0], []).append(row)
        for t in sorted(by_type):
            rows = tuple(by_type[t])
            groups.append(
                dict(
                    ordered=False,
                    rows=rows,
                    entries=rows,
                    offset=offset,
                    count_idx=len(groups),
                    ltype=t,
                    rotated=bool(spec.rotated_types[t]),
                    types=(),
                    stream=False,
                )
            )
            idxs.append(len(groups) - 1)
            offset += len(rows)
        return idxs

    def add_ordered_group(tagged_items, stream):
        """tagged_items = [(row, kidx, mode, sid)] in fold order."""
        nonlocal offset
        types: list[int] = []
        rows, entries = [], []
        for row, kidx, mode, sid in tagged_items:
            t, _rot = row_types[row]
            if t not in types:
                types.append(t)
            rows.append(row)
            entries.append(
                _pack_seg_entry(row, types.index(t), mode, sid % 8, kidx)
            )
        groups.append(
            dict(
                ordered=True,
                rows=tuple(rows),
                entries=tuple(entries),
                offset=offset,
                count_idx=len(groups),
                ltype=-1,
                rotated=False,
                types=tuple((t, bool(spec.rotated_types[t])) for t in types),
                stream=stream,
            )
        )
        offset += len(tagged_items)
        return len(groups) - 1

    def walk(node):
        """Residual-subtree walk: foldable subtrees become iso segments."""
        kind, i, payload, _rows = node
        if kind == "leaf":
            return ("leaf", payload)
        r = _lin_subtree(node)
        if r is not None and len(r[0]) >= 2:
            pre, mid, suf = _split_sensitive(r[0])
            idxs = add_free_groups(pre)
            if mid:
                idxs.append(
                    add_ordered_group(
                        [(ro, k, m, 0) for (ro, k, m) in mid], stream=False
                    )
                )
            idxs += add_free_groups(suf)
            segments.append(tuple(idxs))
            return ("seg", len(segments) - 1)
        if kind in (oc.COP_ROUND, oc.COP_ONION):
            return (kind, i, (walk(payload[0]),))
        return (kind, i, (walk(payload[0]), walk(payload[1])))

    def flatten_union(node):
        if node[0] == oc.COP_UNION:
            return flatten_union(node[2][0]) + flatten_union(node[2][1])
        return [node]

    # Root-level hard-union flatten + operand classification.
    plain_items: list = []
    sensitive: list = []  # per sensitive operand: its prefix+ordered items
    residual_nodes: list = []
    for nd in flatten_union(root):
        r = _lin_subtree(nd)
        if r is None:
            residual_nodes.append(nd)
            continue
        items, sens = r
        if not sens:
            plain_items += items
            continue
        pre, mid, suf = _split_sensitive(items)
        plain_items += suf  # commutes out through the root min
        sensitive.append(pre + mid)

    pool = tuple(add_free_groups(plain_items))
    seg1 = None
    stream: tuple = ()
    if len(sensitive) == 1:
        pre, mid, _ = _split_sensitive(sensitive[0])
        idxs = add_free_groups(pre)
        idxs.append(
            add_ordered_group(
                [(ro, k, m, 0) for (ro, k, m) in mid], stream=False
            )
        )
        seg1 = tuple(idxs)
    elif len(sensitive) > 1:
        # Chunks of <= 8 segments, so that every segment in a group has a
        # unique 3-bit sid (see _pack_seg_entry).
        stream_idxs = []
        for c0 in range(0, len(sensitive), 8):
            chunk = sensitive[c0 : c0 + 8]
            tagged = [
                (ro, k, m, si)
                for si, items in enumerate(chunk)
                for (ro, k, m) in items
            ]
            stream_idxs.append(add_ordered_group(tagged, stream=True))
        stream = tuple(stream_idxs)

    residual_ops = tuple(walk(nd) for nd in residual_nodes)

    seg_leaves = offset
    n_pushed = sum(
        1 for (cop, _a, _s) in spec.static_tape if cop == oc.COP_PUSH
    )
    # Worth compacting only when segments carry the bulk of the leaves.
    if seg_leaves < max(2, n_pushed // 2):
        return None

    return dict(
        groups=tuple(groups),
        segments=tuple(segments),
        pool=pool,
        seg1=seg1,
        stream=stream,
        residual_ops=residual_ops,
        n_items=offset,
        n_counts=len(groups),
    )


def compactable_spec(spec: TapeSpec) -> bool:
    """True when the static tape admits a useful segmented compact plan
    (see build_compact_plan), the O(active) evaluation path."""
    return build_compact_plan(spec) is not None


@functools.lru_cache(maxsize=None)
def plan_program(spec: TapeSpec, device: torch.device):
    """The compact plan of `spec` as the kernels read it: i32[n_prog, 4]
    rows (offset, count index, source 0 pool / 1 seg1 / 2 stream, ordered)
    in evaluation order, on `device`; None without a plan."""
    plan = build_compact_plan(spec)
    if plan is None:
        return None
    rows = []
    for source, gis in ((0, plan["pool"]), (1, plan["seg1"] or ()), (2, plan["stream"])):
        for gi in gis:
            g = plan["groups"][gi]
            rows.append((g["offset"], g["count_idx"], source, int(g["ordered"])))
    return torch.as_tensor(np.asarray(rows, np.int32).reshape(-1, 4), device=device)


def fold_step_plain(opp, acc, e: int, dv):
    """One ordered fold step of entry `e` (scene_eval.cuh fold_step)."""
    mode = (e >> 13) & 3
    if mode == _SEG_PLAIN:
        return torch.minimum(acc, dv)
    if mode == _SEG_SUB:
        return torch.maximum(acc, -dv)
    kk = torch.clamp_min(opp[max((e >> 18) - 1, 0)], 1e-8)
    is_sub = mode == _SEG_SSUB
    hard = torch.maximum(acc, -dv) if is_sub else torch.minimum(acc, dv)
    diff = acc + dv if is_sub else acc - dv
    h = torch.clamp_min(kk - torch.abs(diff), 0.0) / kk
    corr = h * h * kk * 0.25
    return hard + corr if is_sub else hard - corr


def leaf_rgb_plain(P, default_rgb):
    """A leaf's albedo: its own where its material flag is set, else the
    config default (pallas_march.py:886-891)."""
    fl = P[oc.LEAF_MAT_FLAG]
    return tuple(fl * P[oc.LEAF_ALBEDO + c] + (1.0 - fl) * default_rgb[c] for c in range(3))


def scene_color_plain(scene: SceneBuffers, max_dist: float, default_rgb, px, py, pz, cull=None):
    """(distance, (r, g, b)) at points (px, py, pz) through the whole static
    tape with materials: the plain version of `words_color` in
    csrc/scene_eval.cuh (`sdf._apply_static_tape_color`, gated per leaf by
    `cull(row)` as `scene_plain` is)."""
    from .sdf import _apply_dynamic_tape_color, _apply_static_tape_color

    row_types = {r: (t, rot) for r, t, rot in _leaf_static_rows(scene.spec)}
    lp = scene.leaf_params

    def leaf_fn(row):
        t, rot = row_types.get(row, (oc.LEAF_SPHERE, False))
        return _leaf_distance_plain(lp[row], t, rot, px, py, pz), leaf_rgb_plain(lp[row], default_rgb)

    if scene.dynamic:
        d, rgb = _apply_dynamic_tape_color(_host_tape(scene), scene.op_param, leaf_fn, max_dist, px,
                                           default_rgb, scene.spec.stack_depth, cull=cull)
    else:
        d, rgb = _apply_static_tape_color(scene.spec, scene.op_param, leaf_fn, max_dist, px, default_rgb,
                                          cull=cull)
    return d, tuple(px * 0.0 + c for c in rgb)


def scene_words_plain(scene: SceneBuffers, max_dist: float, px, py, pz, cull=None, default_rgb=None):
    """The plain version of K1/K2's evaluator (csrc/scene_eval.cuh
    words_distance, and with `default_rgb` words_color -> (d, (r, g, b))):
    it reads the scene's packed words (to the host) and keeps the value
    stack as the kernels do on the spec's route (`stack_route`): the top,
    and below it one slot (depth - 1 on the shared-memory route). A
    PUSH at slot s spills the top to slot s - 1, a binary op at slot s reads
    slot s and the top, a unary op the top alone; a slot past the route's
    raises, where the kernel would have none. A dynamic tape starts its top
    at max_dist and skips NOPs. `cull(row)` gates leaves as `scene_plain`'s
    does. Held equal to `sdf._apply_static_tape` / `_apply_dynamic_tape` and
    their colour forms."""
    from .culling import FAR
    from .sdf import _combine_static, _mat_weight_smooth

    route = stack_route(scene.spec)
    below = [None] * (scene.spec.stack_depth - 1 if route == STK_SMEM else REG_STACK - 1)
    lp = scene.leaf_params
    colour = default_rgb is not None
    base = px * 0.0 + max_dist
    top = (base, tuple(base * 0.0 + c for c in default_rgb) if colour else None)
    for i, (w0, row, kind, _) in enumerate(scene.words.tolist()):
        op, s = w0 & 0xFF, w0 >> 8
        if op == oc.COP_NOP:  # skipped (a dynamic tape's padding)
            continue
        if op == oc.COP_PUSH:
            d = _leaf_distance_plain(lp[row], kind & (ROTATED_BIT - 1), bool(kind & ROTATED_BIT), px, py, pz)
            rgb = leaf_rgb_plain(lp[row], default_rgb) if colour else None
            if cull is not None:
                on = cull(row)
                d = torch.where(on, d, FAR)
                rgb = tuple(torch.where(on, c, dc) for c, dc in zip(rgb, default_rgb)) if colour else None
            if s > 0:
                if s - 1 >= len(below):
                    raise ValueError(f"slot {s - 1} is past the {len(below)} slots of the stack's route")
                below[s - 1] = top
            top = (d, rgb)
            continue
        kp = scene.op_param[i]
        b, cb = top
        if op in (oc.COP_ROUND, oc.COP_ONION):
            top = ((b if op == oc.COP_ROUND else torch.abs(b)) - kp, cb)
            continue
        a, ca = below[s]
        d = _combine_static(op, a, b, kp)
        if not colour:
            top = (d, None)
            continue
        if op == oc.COP_UNION:
            w = torch.where(a <= b, 1.0, 0.0)
        elif op == oc.COP_INTERSECTION:
            w = torch.where(a >= b, 1.0, 0.0)
        elif op == oc.COP_SUBTRACTION:
            w = torch.where(a >= -b, 1.0, 0.0)
        elif op == oc.COP_SMOOTH_UNION:
            w = _mat_weight_smooth(a, b, kp)
        elif op == oc.COP_SMOOTH_INTERSECTION:
            w = _mat_weight_smooth(b, a, kp)
        else:
            w = _mat_weight_smooth(-b, a, kp)
        top = (d, tuple(w * x + (1.0 - w) * y for x, y in zip(ca, cb)))
    return (top[0], tuple(px * 0.0 + c for c in top[1])) if colour else top[0]


def _fold_smooth(e: int) -> bool:
    """True when ordered entry `e` folds by a smooth step (fold_step_plain)."""
    return ((e >> 13) & 3) in (_SEG_SMOOTH, _SEG_SSUB)


@dataclasses.dataclass
class FoldWork:
    """The list items of one `scene_compact_plain` evaluation, for a roofline
    count of the compact backward: per item its leaf row, whether it folds by
    a smooth step, where it is active, and its leaf value. The fold reads each
    leaf value as a leaf of autograd, so `reached` can tell which of them the
    distance's cotangent reaches: the pool's or a free prefix's winner, and
    the items of the winning ordered source that its steps pass it to."""

    items: list = dataclasses.field(default_factory=list)

    def leaf(self, row: int, smooth: bool, active, dv):
        dv = dv.detach().requires_grad_(True)
        self.items.append((row, smooth, active, dv))
        return dv

    def reached(self, d):
        """Per item, a bool tensor like the points: True where the cotangent
        of the distance `d` reaches the item's leaf value."""
        if not self.items:
            return []
        gs = torch.autograd.grad(d.sum(), [it[3] for it in self.items], allow_unused=True)
        return [torch.zeros(it[3].shape, dtype=torch.bool, device=it[3].device) if g is None else g != 0
                for it, g in zip(self.items, gs)]


def _pool_leaves(scene: SceneBuffers, plan, px, py, pz):
    """(row, leaf params, distance) of each pool item in list order."""
    row_types = {r: (t, rot) for r, t, rot in _leaf_static_rows(scene.spec)}
    for gi in plan["pool"]:
        for row in plan["groups"][gi]["rows"]:
            t, rot = row_types[row]
            P = scene.leaf_params[row]
            yield row, P, _leaf_distance_plain(P, t, rot, px, py, pz)


def pool_fold_plain(scene: SceneBuffers, plan, active, px, py, pz, work: FoldWork | None = None):
    """The pool fold of a compact plan with its winner chosen explicitly:
    items in list order, each taking the running value only when it is
    active and strictly below it (pallas_grad.py:391-420). The value is the
    min over the point's active pool items (FAR when none); under autograd
    its gradient reaches the winner leaf alone, which is the compact
    backward's winner-masked transpose. `work`, when given, records the
    items."""
    from .culling import FAR

    acc = px * 0.0 + FAR
    for row, _P, dv in _pool_leaves(scene, plan, px, py, pz):
        if work is not None:
            dv = work.leaf(row, False, active(row), dv)
        acc = torch.where(active(row) & (dv < acc), dv, acc)
    return acc


def pool_albedo_plain(scene: SceneBuffers, plan, active, default_rgb, px, py, pz):
    """(r, g, b) of the winner of `pool_fold_plain` at each point: its
    albedo (`leaf_rgb_plain`), the default where no item is active."""
    from .culling import FAR

    acc = px * 0.0 + FAR
    rgb = tuple(px * 0.0 + c for c in default_rgb)
    for row, P, dv in _pool_leaves(scene, plan, px, py, pz):
        win = active(row) & (dv < acc)
        acc = torch.where(win, dv, acc)
        rgb = tuple(torch.where(win, c, r) for c, r in zip(leaf_rgb_plain(P, default_rgb), rgb))
    return rgb


def scene_compact_plain(scene: SceneBuffers, plan, active, px, py, pz, work: FoldWork | None = None):
    """Scene distance through a compact plan with per-point active sets, in
    plain torch: the plain version of `compact_fold`
    (csrc/scene_eval.cuh). `active(row)` is a bool tensor that broadcasts
    against the points: True where the leaf is in the point's tile list.
    Items are visited in plan order and a culled item is skipped, which is
    what the kernel's loop over the tile's stable-compacted list does. A
    plan with residual subtrees takes the gated tape instead.

    Every choice between values is an explicit strict `<` in order (the
    compact backward's tie rule, pallas_grad.py:491-505, 683-712): the pool
    winner in list order, a stream group's winning segment in segment
    order, and the winning source in the order pool, seg1 chain, stream
    groups. The values are those of the kernel's min folds; under autograd
    each point's gradient reaches its winning source alone. `work`, when
    given, records the items (FoldWork)."""
    from .culling import FAR

    if plan["residual_ops"]:
        raise ValueError("a plan with residual subtrees takes the gated tape")
    row_types = {r: (t, rot) for r, t, rot in _leaf_static_rows(scene.spec)}
    lp, opp = scene.leaf_params, scene.op_param
    groups = plan["groups"]

    def leaf(row, smooth):
        t, rot = row_types[row]
        dv = _leaf_distance_plain(lp[row], t, rot, px, py, pz)
        return dv if work is None else work.leaf(row, smooth, active(row), dv)

    far = px * 0.0 + FAR
    d = pool_fold_plain(scene, plan, active, px, py, pz, work)
    if plan["seg1"] is not None:
        acc = far
        for gi in plan["seg1"]:
            g = groups[gi]
            for e in g["entries"]:
                row = e & 1023
                if g["ordered"]:
                    step = fold_step_plain(opp, acc, e, leaf(row, _fold_smooth(e)))
                else:
                    step = torch.minimum(acc, leaf(row, False))
                acc = torch.where(active(row), step, acc)
        d = torch.where(acc < d, acc, d)
    for gi in plan["stream"]:
        best, acc_seg = far, far
        prev = torch.full(px.shape, -1, dtype=torch.int32, device=px.device)
        for e in groups[gi]["entries"]:
            row, sid = e & 1023, (e >> 15) & 7
            a = active(row)
            new_seg = a & (prev != sid)
            best = torch.where(new_seg & (acc_seg < best), acc_seg, best)
            acc_seg = torch.where(new_seg, far, acc_seg)
            acc_seg = torch.where(a, fold_step_plain(opp, acc_seg, e, leaf(row, _fold_smooth(e))), acc_seg)
            prev = torch.where(a, sid, prev)
        best = torch.where(acc_seg < best, acc_seg, best)
        d = torch.where(best < d, best, d)
    return d


# --- the flat march kernels K5, K6, K7 (csrc/march.cuh) ---------------------
#
# `ray_march` (K5, pallas_march.py:1297), `image_march` (K6, 1390),
# `image_render` (K7, 1566) and `image_pixels` (K7's pixel build: the AA
# mean of each pixel inside the kernel) launch csrc/march.cuh's one kernel
# template on a CUDA tensor and run their plain versions on a CPU tensor;
# the factories below (`make_pallas_ray_march`, `make_pallas_image_march`,
# `make_march_pallas`, `make_pallas_image_render`,
# `make_pallas_pixel_render`) take the reference's arguments and return its
# call forms. The kernels read the scene's packed words on its stack route
# (`SceneBuffers.words`, `.route`), as K1/K2 do; the host constants are
# those of the prepass renderer (`cuda_prepass.PrepassParams`, no prepass).

# The pixel build's blocks hold whole pixels (csrc/march.cuh
# pixel_threads): at most PIXEL_MAX_THREADS threads, so aa_samples <= 32,
# and at most SMEM_MAX bytes of dynamic shared memory a block (the H100's
# opt-in limit).
MARCH_THREADS = 128
PIXEL_MAX_THREADS = 1024
SMEM_MAX = 227 * 1024


def march_tile_plain(scene_fn, p, bound, ox, oy, oz, dx, dy, dz, work=None, leaves=None):
    """Exact sphere tracing of rays (ox.., dx..) -> (t, hit, steps), f32,
    in plain torch: the Pallas `_march_tile` (pallas_march.py:1088-1214), the
    plain version of march.cu's `march_ray`. Every ray starts at t = 0.
    With `p.use_bound` a valid scene bounding sphere gives only a miss test
    (a ray that misses it or leaves it behind the origin takes no step) and
    the exit cap t_exit + min_dist, so hit and t are those without the
    bound and only steps drop; the reference's kernel starts at the sphere's
    entry instead (1117-1131), which moves a grazing ray's samples and can
    stop it on another surface. A ray escapes on d > max_dist or t > t_cap,
    a hit wins on the boundary, and steps counts the iterations in which the
    ray was live. With relax > 1 the over-relaxed steps and their fallback
    (1133-1176): hit and escape are tested only at samples that did not
    overshoot, and a stepped-back sample counts. `work` counts the scene and
    leaf evaluations."""
    from .cuda_prepass import _INF_CAP, _bound_clip

    zero = dx * 0.0
    t, live, t_cap = zero, zero + 1.0, zero + _INF_CAP
    if p.use_bound:
        live, _, t_cap = _bound_clip(bound, ox, oy, oz, dx, dy, dz, live, t, t_cap, p.min_dist)
    relax = p.relax > 1.0
    hit = steps = prev_r = step_len = zero
    omega = zero + p.relax
    for _ in range(p.max_iter):
        if not bool(live.any()):
            break
        if work is not None:
            work.add(live, leaves)
        d = scene_fn(ox + dx * t, oy + dy * t, oz + dz * t)
        ok, new_step = live, d
        if relax:
            fail = torch.where((omega > 1.0) & (d + prev_r < step_len), live, 0.0)
            ok = live - fail
            new_step = torch.where(fail > 0.0, p.relax_back * step_len, omega * d)
            omega = torch.where(fail > 0.0, 1.0, omega)
        hit_now = torch.where(d < p.min_dist, ok, 0.0)
        escaped = torch.where((d > p.max_dist) | (t > t_cap), ok, 0.0)
        escaped = escaped - escaped * hit_now
        steps = steps + live
        live = live - hit_now - escaped
        t = t + new_step * live
        prev_r, step_len = d, new_step
        hit = hit + hit_now
    return t, hit, steps


def _flat_rays(p, cam):
    """The AA rays of a p.rows x p.width image from `cam`, flat in pixel-major
    order (r = (i * W + j) * S + s): the kernels' raygen (`aa_screen`, the
    view ray of `_view_dirs`), which rounds like pallas_march.py:1408-1435."""
    from .cuda_prepass import _origin, _view_dirs, aa_screen

    x, y = (v.reshape(-1) for v in aa_screen(p, cam))
    dx, dy, dz = _view_dirs(x, y, cam, p)
    return (*_origin(cam, dx), dx, dy, dz)


def _scene_fn(scene: SceneBuffers, p):
    return lambda px, py, pz: scene_plain(scene, p.max_dist, px, py, pz)


def _leaves(scene: SceneBuffers, work):
    from .cuda_prepass import leaves_per_point

    return leaves_per_point(scene, None) if work is not None else None


def ray_march_plain(scene: SceneBuffers, bound, p, origins, dirs, work=None):
    """Plain version of K5 -> (t, hit f32[N], steps i32[N])."""
    o = origins.unbind(-1)
    d = dirs.unbind(-1)
    leaves = _leaves(scene, work)
    t, hit, steps = march_tile_plain(_scene_fn(scene, p), p, bound, *o, *d, work, leaves)
    return t, hit, steps.to(torch.int32)


def image_march_plain(scene: SceneBuffers, cam, bound, p, work=None):
    """Plain version of K6 -> (t, hit f32[N], steps i32[N]) over the N =
    aa^2 * H * W AA rays of the image, in pixel-major order."""
    leaves = _leaves(scene, work)
    t, hit, steps = march_tile_plain(_scene_fn(scene, p), p, bound, *_flat_rays(p, cam), work, leaves)
    return t, hit, steps.to(torch.int32)


def image_render_plain(scene: SceneBuffers, cam, bound, p, work=None):
    """Plain version of K7 -> (r, g, b) f32[N] per AA sample, gamma-
    corrected, in the f32 op order of pallas_march.py:1617-1667: the march,
    the surface point o + d * t * hit, 4-tap normals, Lambert against the
    fixed light, the albedo (per hit on a painted scene), the floor on a
    miss, sqrt gamma."""
    from .cuda_prepass import floor_plain

    ox, oy, oz, dx, dy, dz = _flat_rays(p, cam)
    scene_fn = _scene_fn(scene, p)
    leaves = _leaves(scene, work)
    t, hit, _ = march_tile_plain(scene_fn, p, bound, ox, oy, oz, dx, dy, dz, work, leaves)
    if work is not None:
        work.add(hit, leaves, points_per=4)  # the normal taps of hit rays
        work.hits = work.hits + hit.sum()
    px = ox + dx * t * hit
    py = oy + dy * t * hit
    pz = oz + dz * t * hit
    nx, ny, nz = tet_taps_plain(scene_fn, px, py, pz, p.eps)
    ninv = 1.0 / sqrt_rn(nx * nx + ny * ny + nz * nz + 1e-20)
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    tlx = px - p.light[0]
    tly = py - p.light[1]
    tlz = pz - p.light[2]
    linv = 1.0 / sqrt_rn(tlx * tlx + tly * tly + tlz * tlz + 1e-20)
    diff = torch.clamp_min(nx * tlx * linv + ny * tly * linv + nz * tlz * linv, p.ambient)
    alb = p.albedo
    if scene.spec.has_materials:
        alb = scene_color_plain(scene, p.max_dist, p.albedo, px, py, pz)[1]
    fcol = floor_plain(p, ox, oy, oz, dx, dy, dz)
    miss = 1.0 - hit
    return tuple(sqrt_rn(torch.clamp_min(hit * (alb[c] * diff) + miss * fcol[c], 0.0) + 1e-12)
                 for c in range(3))


def image_pixels_plain(scene: SceneBuffers, cam, bound, p, work=None):
    """Plain version of K7's pixel build -> the image f32[rows, W, 3]: the
    mean of each pixel's S gamma-corrected samples of `image_render_plain`,
    as make_renderer(backend="pallas_full") takes it (the reference's
    stack and mean, raymarch_tpu/ops/march.py:488-507)."""
    rgb = image_render_plain(scene, cam, bound, p, work)
    return torch.stack(rgb, dim=-1).reshape(p.rows, p.width, p.naa * p.naa, 3).mean(dim=2)


def pixel_threads(s: int) -> int:
    """Threads a block of the pixel build for `s` samples a pixel
    (csrc/march.cuh pixel_threads): whole pixels, one when s > 128."""
    return s if s >= MARCH_THREADS else (MARCH_THREADS // s) * s


def pixel_smem(spec: TapeSpec, s: int) -> int:
    """Dynamic shared memory of a block of the pixel build (csrc/march.cuh
    stack_smem_bytes + march_sum_bytes): the stack columns on the
    shared-memory route (four stacks for a painted scene's colour walk),
    and three floats a thread where s does not divide 32."""
    n = pixel_threads(s)
    stack = (spec.stack_depth - 1) * n * 4 * (4 if spec.has_materials else 1) if stack_route(spec) == STK_SMEM else 0
    return stack + (3 * n * 4 if 32 % s else 0)


def _check_flat(scene: SceneBuffers, cam, bound, n: int):
    from .cuda_prepass import _check

    dev = bound.device
    spec = scene.spec
    _check("bound", bound, torch.float32, (8,), dev)
    if cam is not None:
        _check("cam", cam, torch.float32, (8,), dev)
    _check("tape", scene.tape, torch.int32, (3, max(scene.n_instr, 1)), dev)
    _check("row_kind", scene.row_kind, torch.int32, (spec.n_leaves,), dev)
    _check("leaf_params", scene.leaf_params, torch.float32, (spec.n_leaves, oc.LEAF_PARAM_WIDTH), dev)
    _check("op_param", scene.op_param, torch.float32, (spec.n_instr,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if n >= 2**31:
        raise ValueError(f"{n} rays exceed the launch's int32 count")
    return dev


def _march_launch(scene: SceneBuffers, cam, bound, p, origins, dirs, n: int, out: int):
    """One launch of csrc/march.cuh's kernel -> its outputs: (t, hit,
    steps), (r, g, b) per AA ray, or (out 2) the image f32[rows, W, 3]."""
    from .. import _build
    from .cuda_prepass import _CParams, _raise_on, _words_ptrs

    dev = bound.device
    lib = _build.load()
    if out == 2:
        o = [torch.empty((p.rows, p.width, 3), dtype=torch.float32, device=dev)]
    else:
        o = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(2 if out == 0 else 3)]
    steps = torch.empty(n, dtype=torch.int32, device=dev) if out == 0 else None
    cp_ = _CParams.of(p)
    ptrs, _rows = _words_ptrs(scene)  # the rows are held until the launch is queued
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_march_launch(
            *ptrs, int(scene.spec.has_materials),
            None if origins is None else origins.data_ptr(), None if dirs is None else dirs.data_ptr(),
            None if cam is None else cam.data_ptr(), bound.data_ptr(), ctypes.addressof(cp_), n, out,
            o[0].data_ptr(), o[1].data_ptr() if out < 2 else None, o[2].data_ptr() if out == 1 else None,
            None if steps is None else steps.data_ptr(), stream,
        )
    _raise_on(err, "march_kernel")
    if out == 2:
        return o[0]
    return (o[0], o[1], steps) if out == 0 else tuple(o)


@profiling.spanned("launch.ray_march")
def ray_march(scene: SceneBuffers, bound, p, origins, dirs):
    """K5: march explicit rays origins, dirs f32[N, 3] -> (t, hit f32[N],
    steps i32[N]) on the inputs' device."""
    from .cuda_prepass import _check

    n = origins.shape[0] if origins.dim() == 2 else -1
    dev = _check_flat(scene, None, bound, max(n, 0))
    _check("origins", origins, torch.float32, (n, 3), dev)
    _check("dirs", dirs, torch.float32, (n, 3), dev)
    if dev.type == "cpu":
        return ray_march_plain(scene, bound, p, origins, dirs)
    out = _march_launch(scene, None, bound, p, origins, dirs, n, 0)
    ray_march.launches += 1
    return out


@profiling.spanned("launch.image_march")
def image_march(scene: SceneBuffers, cam, bound, p):
    """K6: march the N = aa^2 * H * W AA rays of the image from `cam` ->
    (t, hit f32[N], steps i32[N]), pixel-major."""
    n = p.naa * p.naa * p.rows * p.width
    dev = _check_flat(scene, cam, bound, n)
    if dev.type == "cpu":
        return image_march_plain(scene, cam, bound, p)
    out = _march_launch(scene, cam, bound, p, None, None, n, 0)
    image_march.launches += 1
    return out


@profiling.spanned("launch.image_render")
def image_render(scene: SceneBuffers, cam, bound, p):
    """K7: render the N AA rays of the image from `cam` -> gamma-corrected
    (r, g, b) f32[N], pixel-major; the caller takes the AA mean."""
    n = p.naa * p.naa * p.rows * p.width
    dev = _check_flat(scene, cam, bound, n)
    if dev.type == "cpu":
        return image_render_plain(scene, cam, bound, p)
    out = _march_launch(scene, cam, bound, p, None, None, n, 1)
    image_render.launches += 1
    return out


@profiling.spanned("launch.image_pixels")
def image_pixels(scene: SceneBuffers, cam, bound, p):
    """K7's pixel build: render the image from `cam` -> f32[rows, W, 3],
    each pixel the mean of its S = aa^2 gamma-corrected samples, reduced
    inside the kernel. Raises on an AA grid or stack the build does not
    take (more than PIXEL_MAX_THREADS samples a pixel, or more than
    SMEM_MAX bytes of shared memory a block); it has no other build to
    fall back to."""
    s = p.naa * p.naa
    n = s * p.rows * p.width
    dev = _check_flat(scene, cam, bound, n)
    if s > PIXEL_MAX_THREADS:
        raise ValueError(f"aa_samples {p.naa}: {s} samples a pixel exceed the pixel build's {PIXEL_MAX_THREADS}")
    smem = pixel_smem(scene.spec, s)
    if smem > SMEM_MAX:
        raise ValueError(f"aa_samples {p.naa} at stack depth {scene.spec.stack_depth}: the pixel build's block "
                         f"needs {smem} bytes of shared memory, over {SMEM_MAX}")
    if dev.type == "cpu":
        return image_pixels_plain(scene, cam, bound, p)
    out = _march_launch(scene, cam, bound, p, None, None, n, 2)
    image_pixels.launches += 1
    return out


ray_march.launches = 0
image_march.launches = 0
image_render.launches = 0
image_pixels.launches = 0
for _fn in (ray_march, image_march, image_render, image_pixels):
    profiling.count_launches("cuda_march", _fn, ("launches",))


def reset_launch_counts():
    ray_march.launches = 0
    image_march.launches = 0
    image_render.launches = 0
    image_pixels.launches = 0


class FlatMarch:
    """The state of one flat-march factory: spec, constants and the tape
    topology on one device (uploaded once), and `scene_args` per frame."""

    def __init__(self, spec: TapeSpec, cfg, width: int, height: int, device):
        from .cuda_prepass import PrepassParams

        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.params = PrepassParams.make(cfg, width, height, no_prepass=True)
        self.topology = scene_topology(spec, device)

    def scene_args(self, arrays: TapeArrays, cam_vec=None):
        from .cuda_prepass import frame_args

        return frame_args(self.spec, self.params, self.topology, self.device, arrays, cam_vec)

    def rays(self, x):
        """Origins or dirs as a contiguous f32[N, 3] tensor on the device,
        detached (numpy is uploaded)."""
        if torch.is_tensor(x):
            if x.device != self.device:
                raise ValueError(f"rays are on {x.device}, expected {self.device}")
            return x.detach().to(torch.float32).contiguous()
        return profiling.uploaded(torch.as_tensor(np.asarray(x, np.float32), device=self.device))


@functools.lru_cache(maxsize=None)
def _flat(spec, cfg, width, height, device):
    return FlatMarch(spec, cfg, width, height, device)


def make_pallas_ray_march(spec: TapeSpec, cfg, interpret: bool = False, bm=None, *, device="cuda"):
    """March explicit rays (pallas_march.py:1276): `march(arrays,
    origins[N,3], dirs[N,3]) -> (t[N], hit[N], steps i32[N])` through K5 on
    `device` ("cuda" by default; "cpu" runs the plain version). Static and
    dynamic tapes. `interpret` and `bm` have no effect."""
    from .cuda_prepass import resolve_device

    del interpret, bm
    fm = _flat(spec, cfg, 1, 1, resolve_device(device))

    def march(arrays: TapeArrays, origins, dirs):
        scene, _, bound = fm.scene_args(arrays)
        return ray_march(scene, bound, fm.params, fm.rays(origins), fm.rays(dirs))

    march.flat = fm
    return march


def make_pallas_image_march(spec: TapeSpec, cfg, width: int, height: int, interpret: bool = False, bm=None,
                            *, device="cuda"):
    """March every AA ray of a width x height image with in-kernel raygen
    (pallas_march.py:1369): `march_image(arrays, cam_vec f32[8]) -> (t[N],
    hit[N], steps i32[N])`, N = aa^2 * H * W in pixel-major order, through
    K6. Static and dynamic tapes. `interpret` and `bm` have no effect."""
    from .cuda_prepass import resolve_device

    del interpret, bm
    fm = _flat(spec, cfg, int(width), int(height), resolve_device(device))

    def march_image(arrays: TapeArrays, cam_vec):
        scene, cam, bound = fm.scene_args(arrays, cam_vec)
        return image_march(scene, cam, bound, fm.params)

    march_image.flat = fm
    return march_image


def make_pallas_image_render(spec: TapeSpec, cfg, width: int, height: int, interpret: bool = False, bm=None,
                             *, device="cuda"):
    """The fused flat renderer (pallas_march.py:1528): `render_rgb(arrays,
    cam_vec f32[8]) -> (r, g, b)` f32[N] per AA sample in pixel-major order,
    through K7; the caller takes the AA mean. `interpret` and `bm` have no
    effect."""
    from .cuda_prepass import resolve_device

    del interpret, bm
    fm = _flat(spec, cfg, int(width), int(height), resolve_device(device))

    def render_rgb(arrays: TapeArrays, cam_vec):
        scene, cam, bound = fm.scene_args(arrays, cam_vec)
        return image_render(scene, cam, bound, fm.params)

    render_rgb.flat = fm
    return render_rgb


def make_pallas_pixel_render(spec: TapeSpec, cfg, width: int, height: int, *, device="cuda"):
    """The pallas_full frame through K7's pixel build: `render(arrays,
    cam_vec f32[8]) -> f32[H, W, 3]`, each pixel the mean of its AA
    samples' gamma-corrected colours, the image that
    `make_pallas_image_render` followed by the reference's stack and mean
    gives (raymarch_tpu/ops/march.py:488-507)."""
    from .cuda_prepass import resolve_device

    fm = _flat(spec, cfg, int(width), int(height), resolve_device(device))

    def render(arrays: TapeArrays, cam_vec):
        scene, cam, bound = fm.scene_args(arrays, cam_vec)
        return image_pixels(scene, cam, bound, fm.params)

    render.flat = fm
    return render


def make_march_pallas(spec: TapeSpec, cfg, interpret: bool = False, *, device="cuda"):
    """The drop-in replacement of `march.make_march` with the K5 forward
    (pallas_march.py:1495-1526): `march(origins, dirs, arrays) -> (t, hit,
    steps)`, differentiable with respect to the rays, `arrays.leaf_params`
    and `arrays.op_param` through the implicit-function VJP of
    `march.make_march` over `sdf.make_scene_fn`'s scene at the hit points."""
    from .march import implicit_march
    from .sdf import make_scene_fn

    raw = make_pallas_ray_march(spec, cfg, interpret, device=device)
    return implicit_march(lambda o, d, a: raw(a, o, d), make_scene_fn(spec, cfg), cfg)
