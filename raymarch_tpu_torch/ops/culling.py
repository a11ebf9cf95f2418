"""Per-tile leaf culling in torch: conservative cone/sphere active-leaf masks
and the per-tile compacted item lists of a compact plan.

Port of `raymarch_tpu/ops/culling.py`. None of it is a kernel in the
reference (it is jnp outside any Pallas call), so here it is torch ops on
the renderer's device, run once per frame.

- Every fine (or coarse) list tile is a rectangle of pixels, so all of its
  rays lie inside one circular view cone (apex = camera, axis = the tile
  centre's direction, half-angle = the largest angle to the rectangle's
  corners, plus the coarse pass's cone angle for the coarse tiles).
- Every leaf gets a conservative bounding sphere, inflated by the blend
  radii that can reach it (`_pairwise_path_ksum`), `min_dist`, the normal
  taps (8 * normal_eps) and a small absolute margin.
- A leaf whose inflated sphere misses a tile's cone is culled there: its
  distance is `FAR` (> max_dist). The lemma of the reference's module
  docstring makes this exact for hits, shading and gradients: a culled leaf
  has d >= sum k + min_dist on every ray of the tile, and for every combine
  op combine(d, b) < min_dist <=> combine(FAR, b) < min_dist, with equal
  values there.

One fault of the reference is repaired here (ROADMAP §3.2): in
`_pairwise_path_ksum` a sibling subtree that holds an unbounded (plane)
leaf always interacts, so a smooth blend with a plane keeps its k in the
inflation of every leaf under it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import RenderConfig
from . import opcodes as oc
from .cuda_march import sqrt_rn
from .sdf import _static_tree
from .tape import TapeArrays, TapeSpec

# Distance substituted for culled leaves. Must exceed max_dist so a tile in
# which every leaf is culled escapes on its first march step, and must be
# large enough that smooth blends against it vanish (FAR - d >> k always).
FAR = 1.0e4

# Safety margins (see module docstring).
_ANGLE_MARGIN = 1e-4  # radians, absorbs f32 trig slop
_RADIUS_MARGIN = 1e-3


def _leaf_types(spec: TapeSpec) -> np.ndarray:
    types = np.zeros(spec.n_leaves, np.int32)
    for t, start, stop in spec.type_slices:
        types[start:stop] = t
    return types


@functools.lru_cache(maxsize=None)
def _leaf_path_data(spec: TapeSpec):
    """Static per-leaf root-path data for the pairwise blend inflation (see
    `_pairwise_path_ksum`). None for a dynamic tape or paths longer than
    256, else a dict of numpy arrays:
      path_op   [L, P] int32 - instr index of the t-th op on leaf l's path
                (bottom-up, leaf to root; -1 padding)
      path_side [L, P] int8  - operand side leaf l sits on (0 left, 1 right)
      path_un   [L, P] bool  - unary op (round/onion)
      sib_mask  [I, 2, L] bool - per (op, side): leaf rows of that operand
      sub_ops   [I, 2, I] bool - ops inside that operand subtree
      sib_plane [I, 2] bool - that operand holds a plane (unbounded) leaf
    """
    if spec.static_tape is None:
        return None
    root = _static_tree(spec)
    if root is None:
        return None
    L, I = spec.n_leaves, spec.n_instr
    planes = _leaf_types(spec) == oc.LEAF_PLANE
    paths: dict[int, list] = {}
    sib_mask = np.zeros((I, 2, L), bool)
    sub_ops = np.zeros((I, 2, I), bool)
    sib_plane = np.zeros((I, 2), bool)

    def subtree_ops(node, out):
        kind, i, payload, _rows = node
        if kind == "leaf":
            return
        out[i] = True
        for c in payload:
            subtree_ops(c, out)

    def walk(node, path):
        # path: list of (op_idx, side, unary) from the root to here.
        kind, i, payload, rows = node
        if kind == "leaf":
            paths[payload] = list(reversed(path))  # bottom-up
            return
        if kind in (oc.COP_ROUND, oc.COP_ONION):
            walk(payload[0], path + [(i, 0, True)])
            return
        for side, child in enumerate(payload):
            for r in child[3]:
                sib_mask[i, side, r] = True
                sib_plane[i, side] |= bool(planes[r])
            subtree_ops(child, sub_ops[i, side])
            walk(child, path + [(i, side, False)])

    walk(root, [])
    P = max((len(p) for p in paths.values()), default=0)
    if P == 0 or P > 256:
        return None
    path_op = np.full((L, P), -1, np.int32)
    path_side = np.zeros((L, P), np.int8)
    path_un = np.zeros((L, P), bool)
    for leaf, p in paths.items():
        for t, (op, side, un) in enumerate(p):
            path_op[leaf, t] = op
            path_side[leaf, t] = side
            path_un[leaf, t] = un
    return dict(
        path_op=path_op, path_side=path_side, path_un=path_un,
        sib_mask=sib_mask, sub_ops=sub_ops, sib_plane=sib_plane,
    )


@functools.lru_cache(maxsize=None)
def _leaf_op_incidence(spec: TapeSpec):
    """Static f32[n_leaves, n_instr] incidence: op i lies on the path from
    leaf row r to the tape root, so a culled leaf's FAR flows only through
    those ops and its inflation is the sum of their |op_param|. None for a
    dynamic tape (callers take the global sum)."""
    if spec.static_tape is None:
        return None
    root = _static_tree(spec)
    if root is None:
        return None
    M = np.zeros((spec.n_leaves, spec.n_instr), np.float32)

    def walk(node, path):
        kind, i, payload, _rows = node
        if kind == "leaf":
            M[payload, path] = 1.0
            return
        if kind in (oc.COP_ROUND, oc.COP_ONION):
            walk(payload[0], path + [i])
            return
        for c in payload:
            walk(c, path + [i])

    walk(root, [])
    return M


@functools.lru_cache(maxsize=None)
def _device_path_data(spec: TapeSpec, device: torch.device):
    """`_leaf_path_data` as tensors on `device`, uploaded once."""
    pd = _leaf_path_data(spec)
    if pd is None:
        return None
    return {
        "sib_mask": torch.as_tensor(pd["sib_mask"], dtype=torch.float32, device=device),
        "sub_ops": torch.as_tensor(pd["sub_ops"], dtype=torch.float32, device=device),
        "sib_plane": torch.as_tensor(pd["sib_plane"], device=device),
        "path_op": torch.as_tensor(pd["path_op"], dtype=torch.int64, device=device),
        "path_side": torch.as_tensor(pd["path_side"], dtype=torch.int64, device=device),
        "path_un": torch.as_tensor(pd["path_un"], device=device),
    }


def _pairwise_path_ksum(spec, centers, geo_r, opp_abs, cfg):
    """Spatially gated per-leaf blend inflation: leaf i's bound inflates by
    |k_m| only for path ops m whose sibling subtree can band-interact with
    i (culling.py:178-240 of the reference). The sibling's enclosing sphere
    is built from its leaf centres and radii plus its own inner slack; if it
    stays farther than geo_r_i + rho_i + k_m + its reach + 2 (min_dist +
    taps) from leaf i, op m behaves exactly hard with respect to the
    substitution. Unary round/onion always count. A sibling that holds a
    plane has no enclosing sphere and always counts (the repair of
    ROADMAP §3.2; the reference enters a plane's centre as a point).

    Returns f32[n_leaves] rho, or None (dynamic tape / deep-path cap)."""
    pd = _device_path_data(spec, centers.device)
    if pd is None:
        return None
    P = pd["path_op"].shape[1]
    sm = pd["sib_mask"]  # [I,2,L]
    cnt = torch.clamp_min(torch.sum(sm, dim=-1), 1.0)  # [I,2]
    cc = torch.einsum("isl,lc->isc", sm, centers) / cnt[:, :, None]
    d2cc = torch.sqrt(
        torch.sum((centers[None, None, :, :] - cc[:, :, None, :]) ** 2, dim=-1) + 1e-20
    )  # [I,2,L]
    rad = torch.amax(sm * (d2cc + geo_r[None, None, :]), dim=-1)  # [I,2]
    slack = torch.einsum("isj,j->is", pd["sub_ops"], opp_abs)  # [I,2]
    L0 = cfg.min_dist + 8.0 * cfg.normal_eps + _RADIUS_MARGIN
    path_op, path_side, path_un = pd["path_op"], pd["path_side"], pd["path_un"]
    rho = torch.zeros(centers.shape[0], dtype=torch.float32, device=centers.device)
    for t in range(P):
        opix = path_op[:, t]
        valid = opix >= 0
        o = torch.clamp_min(opix, 0)
        k_t = torch.where(valid, opp_abs[o], 0.0)
        sib = 1 - path_side[:, t]
        sc = cc[o, sib]  # [L,3]
        sr = rad[o, sib] + slack[o, sib]
        dist = torch.sqrt(torch.sum((centers - sc) ** 2, dim=-1) + 1e-20)
        reach = geo_r + rho + k_t + sr + 2.0 * L0
        inter = (dist <= reach) | path_un[:, t] | pd["sib_plane"][o, sib]
        rho = rho + torch.where(valid & inter, k_t, 0.0)
    return rho


@functools.lru_cache(maxsize=None)
def _device_types(spec: TapeSpec, device: torch.device):
    return torch.as_tensor(_leaf_types(spec), device=device)


def leaf_bound_spheres(spec: TapeSpec, arrays: TapeArrays, cfg: RenderConfig, soft: bool = False):
    """Conservative inflated bounding spheres for every leaf bank row ->
    f32[n_leaves, 5] rows (cx, cy, cz, r_inflated, bounded) on the
    parameters' device; bounded = 0 marks planes (always active). The
    per-type radii are those of `cuda_march.compute_bound`; the blend
    inflation is per leaf (`_pairwise_path_ksum`, else the path sum, else
    the global sum). `arrays.leaf_params` and `arrays.op_param` are tensors.

    `soft=True` (coverage rendering) adds `soft_cull_log_alpha *
    coverage_beta` to every leaf's expansion (reference culling.py:243-297):
    a culled leaf then lies at least min_dist + log_alpha * beta from every
    ray of its tile, so wherever dropping it could raise the scene min the
    coverage alpha = exp(-(s_min - min_dist) / beta) is below exp(-log_alpha)
    (at the default 104, an f32 zero). At beta = 0.02 the default adds 2.08
    world units to each bound, so a soft frame culls far less than a hard
    one."""
    lp = arrays.leaf_params.detach()
    opp = arrays.op_param.detach()
    types = _device_types(spec, lp.device)
    p7, p8, p9 = lp[:, 7], lp[:, 8], lp[:, 9]
    r_sphere = p7
    r_box = torch.sqrt(torch.sum(lp[:, 7:10] ** 2, dim=-1))
    r_torus = p7 + p8
    r_cyl = torch.sqrt(p7**2 + p8**2)
    r_cap = p7 + p8
    r_cone = torch.sqrt(torch.maximum(p8, p9) ** 2 + p7**2)
    radii = r_sphere
    for t, r in (
        (oc.LEAF_BOX, r_box),
        (oc.LEAF_TORUS, r_torus),
        (oc.LEAF_CYLINDER, r_cyl),
        (oc.LEAF_CAPSULE, r_cap),
        (oc.LEAF_CONE, r_cone),
    ):
        radii = torch.where(types == t, r, radii)
    opp_abs = torch.abs(opp)
    ksum = _pairwise_path_ksum(spec, lp[:, 4:7], torch.abs(radii), opp_abs, cfg)
    if ksum is None:
        M = _leaf_op_incidence(spec)
        ksum = torch.sum(opp_abs) if M is None else torch.as_tensor(M, device=lp.device) @ opp_abs
    expand = ksum + cfg.min_dist + 8.0 * cfg.normal_eps + _RADIUS_MARGIN
    if soft:
        expand = expand + cfg.soft_cull_log_alpha * cfg.coverage_beta
    bounded = torch.where(types == oc.LEAF_PLANE, 0.0, 1.0)
    return torch.cat(
        [lp[:, 4:7], (torch.abs(radii) + expand)[:, None], bounded[:, None]], dim=-1
    ).to(torch.float32)


def _tile_axes_and_angles(cfg: RenderConfig, width: int, height: int, n_ty: int, n_tx: int,
                          tile_h: float, tile_w: float, cam_vec, extra_angle: float = 0.0):
    """Per-tile world-space cone (axis f32[T, 3], half-angle f32[T]) for a
    grid of n_ty x n_tx tiles of tile_h x tile_w pixels; tile (ty, tx)
    covers pixel rows [ty*tile_h, (ty+1)*tile_h] (+ the band's first row
    cam_vec[7]) and columns [tx*tile_w, (tx+1)*tile_w]. Every AA ray of a
    pixel lies inside the pixel's square, so the corner rays bound every ray
    of the tile; the half-angle is the largest corner angle plus
    `extra_angle` (the coarse pass's per-ray cones) plus a margin."""
    tanf = math.tan(cfg.fovy / 2.0)
    aspect = width / height
    cam = cam_vec.detach()
    dev = cam.device
    i0 = cam[7]

    ty = torch.arange(n_ty, dtype=torch.float32, device=dev)[:, None]
    tx = torch.arange(n_tx, dtype=torch.float32, device=dev)[None, :]
    rows_lo = ty * tile_h + i0
    rows_hi = rows_lo + tile_h
    cols_lo = tx * tile_w
    cols_hi = cols_lo + tile_w

    def view_dir(prow, pcol):
        x = 2.0 * pcol / width - 1.0
        y = 1.0 - 2.0 * prow / height
        vx, vy = torch.broadcast_tensors(x * (tanf * aspect), y * tanf)
        vz = torch.full_like(vx, -1.0)
        inv = 1.0 / sqrt_rn(vx * vx + vy * vy + 1.0)
        return vx * inv, vy * inv, vz * inv

    cx, cy, cz = view_dir((rows_lo + rows_hi) * 0.5, (cols_lo + cols_hi) * 0.5)
    cos_min = torch.ones_like(cx)
    for pr, pc in ((rows_lo, cols_lo), (rows_lo, cols_hi), (rows_hi, cols_lo), (rows_hi, cols_hi)):
        kx, ky, kz = view_dir(pr, pc)
        cos_min = torch.minimum(cos_min, cx * kx + cy * ky + cz * kz)
    theta = torch.arccos(torch.clamp(cos_min, -1.0, 1.0)) + extra_angle + _ANGLE_MARGIN

    qw, qx, qy, qz = cam[3], cam[4], cam[5], cam[6]
    tx_ = 2.0 * (qy * cz - qz * cy)
    ty_ = 2.0 * (qz * cx - qx * cz)
    tz_ = 2.0 * (qx * cy - qy * cx)
    ax = cx + qw * tx_ + (qy * tz_ - qz * ty_)
    ay = cy + qw * ty_ + (qz * tx_ - qx * tz_)
    az = cz + qw * tz_ + (qx * ty_ - qy * tx_)
    axes = torch.stack([ax, ay, az], dim=-1).reshape(-1, 3)
    return axes, theta.reshape(-1)


def pack_mask_bits(active: torch.Tensor) -> torch.Tensor:
    """active bool[T, L] -> i32[T, ceil(L/32)] bitmask (leaf l = bit l%32 of
    word l//32), the bit pattern of a u32 word, so bit 31 survives."""
    t, l = active.shape
    words = (l + 31) // 32
    a = torch.zeros((t, words * 32), dtype=torch.int64, device=active.device)
    a[:, :l] = active.to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=active.device),
        torch.arange(32, dtype=torch.int64, device=active.device),
    )
    packed = torch.sum(a.reshape(t, words, 32) * weights, dim=-1)
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32)


def tile_leaf_masks(bounds, cam_vec, cfg: RenderConfig, width: int, height: int, n_ty: int,
                    n_tx: int, tile_h: float, tile_w: float, extra_angle: float = 0.0):
    """Packed per-tile active-leaf bitmasks i32[n_ty*n_tx, ceil(L/32)]. A
    leaf is active for a tile iff its inflated bounding sphere meets the
    tile's view cone (or it is unbounded): with v = centre - apex, iff
    |v| <= r or angle(v, axis) <= theta + asin(min(r/|v|, 1))."""
    axes, theta = _tile_axes_and_angles(
        cfg, width, height, n_ty, n_tx, tile_h, tile_w, cam_vec, extra_angle
    )
    o = cam_vec.detach()[0:3]
    c = bounds[:, 0:3]
    r = bounds[:, 3]
    unbounded = bounds[:, 4] < 0.5
    v = c - o[None, :]  # [L,3]
    dist = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-20)  # [L]
    vdot = (axes[:, None, 0] * v[None, :, 0] + axes[:, None, 1] * v[None, :, 1]
            + axes[:, None, 2] * v[None, :, 2])  # [T,L]
    beta = torch.arccos(torch.clamp(vdot / dist[None, :], -1.0, 1.0))
    alpha = torch.arcsin(torch.clamp(r / dist, 0.0, 1.0))[None, :]
    inside = (dist <= r)[None, :]
    active = (beta <= theta[:, None] + alpha) | inside | unbounded[None, :]
    return pack_mask_bits(active)


@functools.lru_cache(maxsize=None)
def _pushed_rows(spec: TapeSpec) -> np.ndarray:
    """Static bool[n_leaves]: rows referenced by a COP_PUSH. Bank padding
    rows carry zero params (a phantom radius-0 sphere at the origin) whose
    bounds can test active, so compaction never emits them. A dynamic
    tape's pushes are per-frame data: every row may be pushed, and the tape
    reads the bit of the rows it does push."""
    if spec.static_tape is None:
        return np.ones(spec.n_leaves, bool)
    pushed = np.zeros(spec.n_leaves, bool)
    for cop, arg, _slot in spec.static_tape or ():
        if cop == oc.COP_PUSH:
            pushed[arg] = True
    return pushed


@functools.lru_cache(maxsize=None)
def _device_pushed(spec: TapeSpec, device: torch.device):
    return torch.as_tensor(_pushed_rows(spec), device=device)


def _active_from_mask(spec: TapeSpec, mask_bits: torch.Tensor) -> torch.Tensor:
    """Unpack tile bitmasks to bool[T, n_leaves], padding rows forced off."""
    t = mask_bits.shape[0]
    words = mask_bits.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=mask_bits.device)
    bits = torch.bitwise_right_shift(words[:, :, None], shifts[None, None, :]) & 1
    active = bits.reshape(t, -1)[:, : spec.n_leaves] > 0
    return active & _device_pushed(spec, mask_bits.device)[None, :]


@functools.lru_cache(maxsize=None)
def _device_plan_index(plan_key, device: torch.device):
    """Per group: (rows i64[G], entries i32[G]) on `device`, uploaded once."""
    return tuple(
        (torch.as_tensor(rows, dtype=torch.int64, device=device),
         torch.as_tensor(entries, dtype=torch.int32, device=device))
        for rows, entries in plan_key
    )


def compact_plan_rows(spec: TapeSpec, plan, mask_bits: torch.Tensor):
    """Per-tile compacted active-item lists of a compact plan
    (`cuda_march.build_compact_plan`) -> (entries i32[T, plan n_items],
    counts i32[T, plan n_counts]). Group g's columns [offset, offset+len)
    hold its packed entries with the tile's active items first in their
    original order (a stable compaction: the ordered folds rely on it), and
    counts[:, g] how many are active."""
    active = _active_from_mask(spec, mask_bits)
    key = tuple((g["rows"], g["entries"]) for g in plan["groups"])
    lists, counts = [], []
    for rows, ent in _device_plan_index(key, mask_bits.device):
        a = active[:, rows]  # [T, G]
        order = torch.argsort(torch.logical_not(a).to(torch.int8), dim=1, stable=True)
        lists.append(ent[order])
        counts.append(torch.sum(a, dim=1, dtype=torch.int32))
    return (
        torch.cat(lists, dim=1).contiguous(),
        torch.stack(counts, dim=1).to(torch.int32).contiguous(),
    )
