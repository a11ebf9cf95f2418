"""Cone-prepass forward renderer: two CUDA kernels and their plain versions.

Port of the main path of `raymarch_tpu/ops/pallas_prepass.py`
(`make_pallas_image_render_aa` with prepass_block=1, aa_packed=True):

1. **Coarse pass** (`coarse`; kernel `coarse_kernel` in csrc/prepass.cu,
   replacing the Pallas `coarse_kernel`, pallas_prepass.py:885). One cone
   ray per pixel centre, stopped at `d < min_dist + omega*t` and stepped by
   `(d - omega*t)/(1+omega)`: every AA ray of the pixel is un-crossed up to
   the stop distance, so it becomes the pixel's safe start `t0`; `status` is
   1 where the cone stopped near a surface, 0 where it escaped (a miss).
2. **Fine pass** (`fine`; kernel `fine_kernel`, replacing
   `fine_packed_kernel`, pallas_prepass.py:1521). Every AA ray sphere-traces
   from its pixel's t0, hit rays take tetrahedron normals and Lambert
   shading (with the albedo the static tape carries to the hit point on a
   painted scene), misses the analytic checker floor, then sqrt gamma and
   the AA mean: f32[rows, W, 3].

Each wrapper takes tensors on one device. On the CPU it runs its plain
version (`coarse_plain`, `fine_plain`: vectorised torch over all rays, a
masked loop of at most max_iter steps, the same formulas); on a CUDA device
it launches the kernel, or raises. It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..config import RenderConfig
from . import opcodes as oc
from .cuda_march import (
    SceneBuffers,
    build_compact_plan,
    compute_bound,
    compute_bound_torch,
    plan_program,
    scene_buffers,
    scene_color_plain,
    scene_compact_plain,
    scene_plain,
    scene_topology,
    sqrt_rn,
    tet_taps_plain,
)
from .tape import TapeArrays, TapeSpec

_INF_CAP = 3.0e38


def cone_omega(cfg: RenderConfig, width: int, height: int, block: int = 1) -> float:
    """Max angular deviation (radians, conservative) of any AA sample ray in a
    `block x block` pixel tile from the tile-center ray. Pixel centers sit at
    most (block-1)/2 pixels from the tile center and sub-pixel offsets add
    0.5 - 0.5/n (ops.raygen.aa_offsets), bounded together by block/2. View-
    plane points sit at |p| >= 1 (z=-1 plane) so the chord bound |offset|
    bounds the angle; a 1.5x safety factor absorbs the chord-vs-angle slack."""
    tanf = math.tan(cfg.fovy / 2.0)
    aspect = width / height
    pw = 2.0 * tanf * aspect / width
    ph = 2.0 * tanf / height
    n = cfg.aa_samples
    if block == 1:
        off = max(0.5 - 0.5 / n, 0.0)
    else:
        off = block / 2.0
    return 1.5 * off * math.sqrt(pw * pw + ph * ph)


def _f32(v: float) -> float:
    """A Python constant rounded to f32, as JAX's weak typing rounds it."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class PrepassParams:
    """Host constants of one renderer (cfg, width, height). Floats are
    already rounded to f32, so the kernels and the plain versions read the
    same values."""

    width: int
    height: int
    rows: int
    naa: int
    max_iter: int
    use_bound: bool
    no_prepass: bool
    min_dist: float
    max_dist: float
    omega: float
    inv1w: float
    tan_aspect: float
    tanf: float
    c2w: float
    c2h: float
    eps: float
    light: tuple
    albedo: tuple
    floor_base: tuple
    floor_y: float
    floor_checker: float
    ambient: float
    inv_s: float
    relax: float
    relax_back: float

    @staticmethod
    def make(cfg: RenderConfig, width: int, height: int, no_prepass: bool = False):
        tanf = math.tan(cfg.fovy / 2.0)
        omega = cone_omega(cfg, width, height, 1)
        naa = cfg.aa_samples
        return PrepassParams(
            width=width,
            height=height,
            rows=height,
            naa=naa,
            max_iter=int(cfg.max_iter),
            use_bound=bool(cfg.bound_accel),
            no_prepass=bool(no_prepass),
            min_dist=_f32(cfg.min_dist),
            max_dist=_f32(cfg.max_dist),
            omega=_f32(omega),
            inv1w=_f32(1.0 / (1.0 + omega)),
            tan_aspect=_f32(tanf * (width / height)),
            tanf=_f32(tanf),
            c2w=_f32(2.0 / width),
            c2h=_f32(2.0 / height),
            eps=_f32(cfg.normal_eps),
            light=tuple(_f32(v) for v in cfg.light_position),
            albedo=tuple(_f32(v) for v in cfg.albedo),
            floor_base=tuple(_f32(v) for v in cfg.floor_base),
            floor_y=_f32(cfg.floor_y),
            floor_checker=_f32(cfg.floor_checker),
            ambient=_f32(cfg.ambient),
            inv_s=_f32(1.0 / (naa * naa)),
            relax=_f32(max(cfg.relax, 1.0)),
            relax_back=_f32(1.0 - cfg.relax),
        )


class _CParams(ctypes.Structure):
    """ctypes mirror of `RenderParams` in csrc/prepass.cu, field by field."""

    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("rows", ctypes.c_int32),
        ("naa", ctypes.c_int32),
        ("max_iter", ctypes.c_int32),
        ("use_bound", ctypes.c_int32),
        ("no_prepass", ctypes.c_int32),
        ("min_dist", ctypes.c_float),
        ("max_dist", ctypes.c_float),
        ("omega", ctypes.c_float),
        ("inv1w", ctypes.c_float),
        ("tan_aspect", ctypes.c_float),
        ("tanf", ctypes.c_float),
        ("c2w", ctypes.c_float),
        ("c2h", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("light", ctypes.c_float * 3),
        ("albedo", ctypes.c_float * 3),
        ("floor_base", ctypes.c_float * 3),
        ("floor_y", ctypes.c_float),
        ("floor_checker", ctypes.c_float),
        ("ambient", ctypes.c_float),
        ("inv_s", ctypes.c_float),
        ("relax", ctypes.c_float),
        ("relax_back", ctypes.c_float),
    ]

    @staticmethod
    def of(p: PrepassParams) -> "_CParams":
        c = _CParams()
        for name, _ in _CParams._fields_:
            v = getattr(p, name)
            if isinstance(v, tuple):
                getattr(c, name)[:] = v
            else:
                setattr(c, name, v)
        return c


# Side, in pixels, of the square tiles that carry one culling mask and one
# compacted item list each: the coarse kernel's tiles and the fine kernel's
# (and the backward's, which reads the fine lists). The reference sizes its
# list tiles to the TPU's 1 MB of scalar memory; here lists live in device
# memory, so both are small squares: 1080p has 68 x 120 of them.
COARSE_TILE = 16
FINE_TILE = 16


@dataclasses.dataclass(frozen=True)
class TileCull:
    """One frame's leaf culling on one kernel's tile grid, on the device.

    masks:  i32[T, ceil(L/32)], the packed active-leaf bits of each tile
            (culling.tile_leaf_masks), T = n_ty * n_tx.
    lists, counts: the compact plan's per-tile item lists and active counts
            (culling.compact_plan_rows), or None: then the kernels run the
            gated tape, the run-time tape with FAR for each culled leaf.
    prog:   the plan's groups in evaluation order (cuda_march.plan_program),
            or None with the gated tape.
    """

    tile: int
    n_tx: int
    masks: torch.Tensor
    lists: torch.Tensor | None = None
    counts: torch.Tensor | None = None
    prog: torch.Tensor | None = None

    @property
    def compact(self) -> bool:
        return self.lists is not None

    def tile_index(self, i, j):
        """Tile of (band row i, column j) tensors, as csrc tile_of."""
        return torch.div(i, self.tile, rounding_mode="floor") * self.n_tx + torch.div(
            j, self.tile, rounding_mode="floor"
        )


class _CCull(ctypes.Structure):
    """ctypes mirror of `CullView` in csrc/scene_eval.cuh, field by field."""

    _fields_ = [
        ("lists", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("masks", ctypes.c_void_p),
        ("prog", ctypes.c_void_p),
        ("mode", ctypes.c_int32),
        ("tile", ctypes.c_int32),
        ("n_tx", ctypes.c_int32),
        ("n_items", ctypes.c_int32),
        ("n_counts", ctypes.c_int32),
        ("n_words", ctypes.c_int32),
        ("n_prog", ctypes.c_int32),
    ]

    @staticmethod
    def of(c: TileCull | None) -> "_CCull":
        v = _CCull()
        if c is None:
            return v  # mode 0: no culling
        v.masks = c.masks.data_ptr()
        v.n_words = c.masks.shape[1]
        v.tile = c.tile
        v.n_tx = c.n_tx
        if c.compact:
            v.mode = 1
            v.lists = c.lists.data_ptr()
            v.counts = c.counts.data_ptr()
            v.prog = c.prog.data_ptr()
            v.n_items = c.lists.shape[1]
            v.n_counts = c.counts.shape[1]
            v.n_prog = c.prog.shape[0]
        else:
            v.mode = 2
        return v


# --------------------------------------------------------------------------
# Plain versions (any device; the wrappers use them on the CPU)


def _view_dirs(x, y, cam, p: PrepassParams):
    """Screen point -> world ray direction (pallas_prepass._view_dirs)."""
    vx = x * p.tan_aspect
    vy = y * p.tanf
    vz = torch.full_like(x, -1.0)
    # 1 / sqrt, as the kernels compute it (torch.rsqrt is approximate on CUDA).
    inv_norm = 1.0 / sqrt_rn(vx * vx + vy * vy + vz * vz)
    vx = vx * inv_norm
    vy = vy * inv_norm
    vz = vz * inv_norm
    qw, qx, qy, qz = cam[3], cam[4], cam[5], cam[6]
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    dx = vx + qw * tx + (qy * tz - qz * ty)
    dy = vy + qw * ty + (qz * tx - qx * tz)
    dz = vz + qw * tz + (qx * ty - qy * tx)
    return dx, dy, dz


def _bound_clip(bound, ox, oy, oz, dx, dy, dz, live_init, t_init, t_cap, min_dist):
    """Clip rays against the scene bounding sphere -> (live, t0, t_cap)
    (pallas_prepass._bound_clip)."""
    bcx, bcy, bcz, br, bvalid = bound[0], bound[1], bound[2], bound[3], bound[4]
    ocx = ox - bcx
    ocy = oy - bcy
    ocz = oz - bcz
    bq = dx * ocx + dy * ocy + dz * ocz
    c2 = ocx * ocx + ocy * ocy + ocz * ocz - br * br
    disc = bq * bq - c2
    sq = sqrt_rn(torch.clamp_min(disc, 0.0))
    t_enter = -bq - sq
    t_exit = -bq + sq
    hit_bound = torch.where((disc > 0.0) & (t_exit > 0.0), live_init, 0.0)
    use = bvalid > 0.0
    live = torch.where(use, hit_bound, live_init)
    t0 = torch.where(use, torch.clamp_min(t_enter, 0.0) * hit_bound, t_init)
    cap = torch.where(use, t_exit + min_dist, t_cap)
    return live, t0, cap


def _origin(cam, like):
    return cam[0].expand_as(like), cam[1].expand_as(like), cam[2].expand_as(like)


def div_rn(x: torch.Tensor, d) -> torch.Tensor:
    """x / d rounded to nearest on every device, as the kernels divide.
    torch's CUDA division by a Python number multiplies by the number's
    rounded reciprocal instead, which moves a ray by an ulp (and a replayed
    hit point off the kernel's); a 0-d tensor divisor takes true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def tile_active(spec: TapeSpec, cull: TileCull, tid):
    """`active(row)` -> bool tensor like `tid` (each point's tile): True
    where bit `row` of the tile's leaf mask is set. Memoised per row."""
    from .culling import _active_from_mask

    act_cols = _active_from_mask(spec, cull.masks).T.contiguous()  # [L, T]
    memo = {}

    def active(row):
        if row not in memo:
            memo[row] = act_cols[row][tid]
        return memo[row]

    return active


def scene_fn_plain(scene: SceneBuffers, max_dist: float, cull: TileCull | None, tid=None):
    """The plain scene function of one pass -> f(px, py, pz). Without
    `cull` it is `scene_plain`. With it, `tid` holds each point's tile
    (broadcasting against the points) and the leaf rows of that tile's mask
    are active: a compact plan folds them in plan order
    (`scene_compact_plain`), else the gated tape substitutes FAR for the
    others (`sdf._apply_static_tape` with `cull`)."""
    if cull is None:
        return lambda px, py, pz: scene_plain(scene, max_dist, px, py, pz)
    active = tile_active(scene.spec, cull, tid)
    if cull.compact:
        plan = build_compact_plan(scene.spec)
        return lambda px, py, pz: scene_compact_plain(scene, plan, active, px, py, pz)
    return lambda px, py, pz: scene_plain(scene, max_dist, px, py, pz, cull=active)


def albedo_fn_plain(scene: SceneBuffers, p: PrepassParams, cull: TileCull | None, tid=None):
    """The fine pass's albedo at hit points -> f(px, py, pz) -> (r, g, b),
    or None for a material-free scene (every hit shades with cfg.albedo).
    The static tape with materials (`scene_color_plain`), gated by the
    tile's leaf mask under culling in either mode, as the fine kernel's
    `scene_color` is."""
    if not scene.spec.has_materials:
        return None
    active = None if cull is None else tile_active(scene.spec, cull, tid)
    return lambda px, py, pz: scene_color_plain(scene, p.max_dist, p.albedo, px, py, pz, cull=active)[1]


@dataclasses.dataclass
class WorkCount:
    """The work of one pass as its plain version counts it, for a roofline
    bound: scene evaluations at points (march steps of live rays, the normal
    taps of hit rays), the leaf evaluations they take (per point, the
    leaves its tile keeps; every pushed leaf unculled) and the hit rays.
    Sums are 0-d tensors on the pass's device (no host sync per step)."""

    points: torch.Tensor | float = 0.0
    leaf_evals: torch.Tensor | float = 0.0
    hits: torch.Tensor | float = 0.0

    def add(self, live, leaves, points_per=1):
        self.points = self.points + points_per * live.sum()
        self.leaf_evals = self.leaf_evals + points_per * (live * leaves).sum()


def leaves_per_point(scene: SceneBuffers, cull: TileCull | None, tid=None):
    """Leaves one scene evaluation takes at a point of tile `tid`: the
    tile's list counts (compact), its active pushed leaves (gated tape), or
    every pushed leaf (unculled)."""
    if cull is None:
        return sum(1 for c, _a, _s in scene.spec.static_tape if c == oc.COP_PUSH)
    if cull.compact:
        return cull.counts.sum(dim=1)[tid].to(torch.float32)
    from .culling import _active_from_mask

    return _active_from_mask(scene.spec, cull.masks).sum(dim=1)[tid].to(torch.float32)


def _band_ij(p: PrepassParams, dev, naa_axis: bool):
    i = torch.arange(p.rows, device=dev)[:, None]
    j = torch.arange(p.width, device=dev)[None, :]
    if naa_axis:
        return i[:, :, None], j[:, :, None]
    return i, j


def coarse_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, cull: TileCull | None = None,
                 work: WorkCount | None = None):
    """Plain version of the coarse kernel -> (t0, status) f32[rows, W].
    `work`, when given, counts the pass's scene and leaf evaluations."""
    dev = cam.device
    i = torch.arange(p.rows, device=dev, dtype=torch.float32)[:, None]
    j = torch.arange(p.width, device=dev, dtype=torch.float32)[None, :]
    x = div_rn(2.0 * (j + 0.5), p.width) - 1.0
    y = 1.0 - div_rn(2.0 * ((i + 0.5) + cam[7]), p.height)
    x, y = (v.contiguous() for v in torch.broadcast_tensors(x, y))
    dx, dy, dz = _view_dirs(x, y, cam, p)
    ox, oy, oz = _origin(cam, dx)
    tid = cull.tile_index(*_band_ij(p, dev, False)) if cull is not None else None
    scene_fn = scene_fn_plain(scene, p.max_dist, cull, tid)

    zero = torch.zeros_like(dx)
    t = zero
    live = zero + 1.0
    t_cap = zero + _INF_CAP
    if p.use_bound:
        live, t, t_cap = _bound_clip(
            bound, ox, oy, oz, dx, dy, dz, live, t, t_cap, p.min_dist
        )
    near = zero
    leaves = leaves_per_point(scene, cull, tid) if work is not None else None
    for _ in range(p.max_iter):
        if not bool(live.any()):
            break
        if work is not None:
            work.add(live, leaves)
        d = scene_fn(ox + dx * t, oy + dy * t, oz + dz * t)
        slack = d - p.omega * t
        near_now = torch.where(slack < p.min_dist, live, 0.0)
        escaped = torch.where((d > p.max_dist) | (t > t_cap), live, 0.0)
        escaped = escaped - escaped * near_now
        advance = live - near_now - escaped
        t = t + slack * p.inv1w * advance
        live = live - near_now - escaped
        near = near + near_now
    return t, near


def aa_screen(p: PrepassParams, cam, i0: int = 0, n_rows: int | None = None):
    """Screen coordinates (x, y) f32[n_rows, W, S] of the AA rays of band
    rows [i0, i0 + n_rows), lane order pixel-major with the sample fastest
    (the kernels' q = j*S + s), in the f32 op order of pallas_prepass.py:
    1553-1562."""
    dev = cam.device
    naa = p.naa
    S = naa * naa
    n_rows = p.rows - i0 if n_rows is None else n_rows
    i = torch.arange(i0, i0 + n_rows, device=dev, dtype=torch.float32)[:, None, None]
    j = torch.arange(p.width, device=dev, dtype=torch.float32)[None, :, None]
    s = torch.arange(S, device=dev)
    a = s // naa
    b = s - a * naa
    fa = (div_rn(a.to(torch.float32) + 0.5, naa) - 0.5)[None, None, :]
    fb = (div_rn(b.to(torch.float32) + 0.5, naa) - 0.5)[None, None, :]
    x = div_rn(2.0 * (j + 0.5), p.width) - 1.0 + fa * p.c2w
    y = 1.0 - div_rn(2.0 * (i + 0.5 + cam[7]), p.height) + fb * p.c2h
    return tuple(v.contiguous() for v in torch.broadcast_tensors(x, y))


def fine_res_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, t0=None, status=None,
                   cull: TileCull | None = None, work: WorkCount | None = None):
    """Plain version of the fine kernel with residuals -> (image f32[rows,
    W, 3], t, hit f32[rows, W, S]): each AA ray's march end and hit flag.
    `cull` is the fine grid's TileCull of a culled frame; `work`, when
    given, counts the pass's scene and leaf evaluations."""
    x, y = aa_screen(p, cam)
    dx, dy, dz = _view_dirs(x, y, cam, p)
    ox, oy, oz = _origin(cam, dx)
    tid = cull.tile_index(*_band_ij(p, cam.device, True)) if cull is not None else None
    scene_fn = scene_fn_plain(scene, p.max_dist, cull, tid)

    zero = torch.zeros_like(dx)
    if p.no_prepass:
        t = zero
        live = zero + 1.0
    else:
        t = zero + t0[:, :, None]
        live = zero + status[:, :, None]
    t_cap = zero + _INF_CAP
    if p.use_bound:
        _, _, t_cap = _bound_clip(
            bound, ox, oy, oz, dx, dy, dz, live, t, t_cap, p.min_dist
        )
    leaves = leaves_per_point(scene, cull, tid) if work is not None else None
    if p.relax > 1.0:
        t, hit = _relaxed_march_plain(scene_fn, p, ox, oy, oz, dx, dy, dz, t, live, t_cap,
                                      work, leaves)
    else:
        hit = zero
        for _ in range(p.max_iter):
            if not bool(live.any()):
                break
            if work is not None:
                work.add(live, leaves)
            d = scene_fn(ox + dx * t, oy + dy * t, oz + dz * t)
            hit_now = torch.where(d < p.min_dist, live, 0.0)
            escaped = torch.where((d > p.max_dist) | (t > t_cap), live, 0.0)
            escaped = escaped - escaped * hit_now
            advance = live - hit_now - escaped
            t = t + d * advance
            live = live - hit_now - escaped
            hit = hit + hit_now
    if work is not None:
        work.add(hit, leaves, points_per=4)  # the normal taps of hit rays
        work.hits = work.hits + hit.sum()
    cols = shade_plain(scene, p, ox, oy, oz, dx, dy, dz, t, hit, scene_fn, albedo_fn_plain(scene, p, cull, tid))
    img = torch.stack([torch.sum(c, dim=-1) * p.inv_s for c in cols], dim=-1)
    return img, t, hit


def _relaxed_march_plain(scene_fn, p: PrepassParams, ox, oy, oz, dx, dy, dz, t, live, t_cap,
                         work=None, leaves=None):
    """The relax > 1 branch of the fine march (pallas_prepass.py:491-525):
    step omega*d; when consecutive safe spheres stop overlapping (d +
    prev_r < step) the relaxed step overshot, so step back by (1 - relax)
    * step and drop that ray to omega = 1. Hit and escape are tested only
    at samples that did not overshoot; exit_check_every does not apply."""
    zero = torch.zeros_like(t)
    prev_r = zero
    step_len = zero
    omega = zero + p.relax
    hit = zero
    for _ in range(p.max_iter):
        if not bool(live.any()):
            break
        if work is not None:
            work.add(live, leaves)
        d = scene_fn(ox + dx * t, oy + dy * t, oz + dz * t)
        fail = torch.where((omega > 1.0) & (d + prev_r < step_len), live, 0.0)
        ok = live - fail
        new_step = torch.where(fail > 0.0, p.relax_back * step_len, omega * d)
        omega = torch.where(fail > 0.0, 1.0, omega)
        hit_now = torch.where(d < p.min_dist, ok, 0.0)
        escaped = torch.where((d > p.max_dist) | (t > t_cap), ok, 0.0)
        escaped = escaped - escaped * hit_now
        live = live - hit_now - escaped
        t = t + new_step * live
        prev_r = d
        step_len = new_step
        hit = hit + hit_now
    return t, hit


def shade_plain(scene: SceneBuffers, p: PrepassParams, ox, oy, oz, dx, dy, dz, t, hit, scene_fn=None,
                albedo_fn=None):
    """Per-ray gamma-corrected colour (r, g, b) of the fine pass at the
    march result (t, hit): tetrahedron normal, Lambert against the point
    light, the checker floor on a miss (pallas_grad.py:1600-1651 is the same
    chain). Differentiable in the scene, the ray and t. `scene_fn` is the
    pass's scene function (default: the whole tape, `scene_plain`);
    `albedo_fn(px, py, pz)` gives the albedo at the hit points of a
    painted scene (default: cfg.albedo everywhere)."""
    if scene_fn is None:
        scene_fn = scene_fn_plain(scene, p.max_dist, None)
    px = ox + dx * t * hit
    py = oy + dy * t * hit
    pz = oz + dz * t * hit
    nx, ny, nz = tet_taps_plain(scene_fn, px, py, pz, p.eps)
    ninv = 1.0 / sqrt_rn(nx * nx + ny * ny + nz * nz + 1e-20)
    tlx = px - p.light[0]
    tly = py - p.light[1]
    tlz = pz - p.light[2]
    linv = 1.0 / sqrt_rn(tlx * tlx + tly * tly + tlz * tlz + 1e-20)
    diff = (nx * tlx + ny * tly + nz * tlz) * (ninv * linv)
    diff = torch.clamp_min(diff, p.ambient)
    # A miss takes diff = 0 (shade_miss): select, never multiply by hit = 0.
    diff = torch.where(hit > 0.0, diff, 0.0)
    alb = p.albedo if albedo_fn is None else albedo_fn(px, py, pz)

    dy_ok = torch.where(torch.abs(dy) > 1e-8, 1.0, 0.0)
    dy_safe = torch.where(torch.abs(dy) > 1e-8, dy, 1e-8)
    ft = (p.floor_y - oy) / dy_safe
    fx = torch.clamp(ox + dx * ft, -1e7, 1e7)
    fz = torch.clamp(oz + dz * ft, -1e7, 1e7)
    ipx = torch.round(fx + 0.5).to(torch.int32)  # half to even, as jnp.round
    ipz = torch.round(fz + 0.5).to(torch.int32)
    parity = torch.bitwise_and(torch.bitwise_xor(ipx, ipz), 1).to(torch.float32)
    on_floor = torch.where(ft > 0.0, dy_ok, 0.0)
    miss = 1.0 - hit
    cols = []
    for c in range(3):
        fcol = (p.floor_base[c] + p.floor_checker * parity) * on_floor
        cols.append(
            sqrt_rn(torch.clamp_min(hit * (alb[c] * diff) + miss * fcol, 0.0) + 1e-12)
        )
    return cols


def fine_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, t0=None, status=None,
               cull: TileCull | None = None, work: WorkCount | None = None):
    """Plain version of the fine kernel -> image f32[rows, W, 3]."""
    return fine_res_plain(scene, cam, bound, p, t0, status, cull, work)[0]


# --------------------------------------------------------------------------
# Wrappers: plain on the CPU, the CUDA kernel on a CUDA device


def _check(name, x, dtype, shape, device):
    if not torch.is_tensor(x):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_scene(scene: SceneBuffers, cam, bound, p: PrepassParams):
    dev = cam.device
    spec = scene.spec
    _check("cam", cam, torch.float32, (8,), dev)
    _check("bound", bound, torch.float32, (8,), dev)
    _check("tape", scene.tape, torch.int32, (3, max(scene.n_instr, 1)), dev)
    _check("row_kind", scene.row_kind, torch.int32, (spec.n_leaves,), dev)
    _check("leaf_params", scene.leaf_params, torch.float32, (spec.n_leaves, 16), dev)
    _check("op_param", scene.op_param, torch.float32, (spec.n_instr,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        S = p.naa * p.naa
        if 32 % S:
            raise NotImplementedError(
                f"the fine kernel reduces the AA mean within a warp: "
                f"aa_samples^2 = {S} must divide 32"
            )
        if p.rows > 65535:
            raise ValueError(f"{p.rows} rows exceed the launch grid")
    return dev


def _scene_ptrs(scene: SceneBuffers):
    return (
        scene.leaf_params.data_ptr(),
        scene.row_kind.data_ptr(),
        scene.tape.data_ptr(),
        scene.n_instr,
        scene.op_param.data_ptr(),
    )


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def _check_cull(cull: TileCull | None, spec: TapeSpec, p: PrepassParams, dev):
    if cull is None:
        return
    n_ty = -(-p.rows // cull.tile)
    n_tx = -(-p.width // cull.tile)
    if cull.n_tx != n_tx:
        raise ValueError(f"cull grid has {cull.n_tx} tiles per row, expected {n_tx}")
    _check("masks", cull.masks, torch.int32, (n_ty * n_tx, (spec.n_leaves + 31) // 32), dev)
    if cull.compact:
        plan = build_compact_plan(spec)
        if plan is None or plan["residual_ops"]:
            raise ValueError("item lists given for a scene that takes the gated tape")
        _check("lists", cull.lists, torch.int32, (n_ty * n_tx, plan["n_items"]), dev)
        _check("counts", cull.counts, torch.int32, (n_ty * n_tx, plan["n_counts"]), dev)
        _check("prog", cull.prog, torch.int32, None, dev)


def coarse(scene: SceneBuffers, cam, bound, p: PrepassParams, cull: TileCull | None = None):
    """Coarse pass -> (t0, status) f32[rows, W] on the inputs' device.
    `cull` is the coarse grid's TileCull of a culled frame."""
    dev = _check_scene(scene, cam, bound, p)
    _check_cull(cull, scene.spec, p, dev)
    if dev.type == "cpu":
        return coarse_plain(scene, cam, bound, p, cull)
    from .. import _build

    lib = _build.load()
    t0 = torch.empty((p.rows, p.width), dtype=torch.float32, device=dev)
    status = torch.empty_like(t0)
    cp = _CParams.of(p)
    cc = _CCull.of(cull)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_coarse_launch(
            *_scene_ptrs(scene), cam.data_ptr(), bound.data_ptr(),
            ctypes.addressof(cp), ctypes.addressof(cc), t0.data_ptr(), status.data_ptr(), stream,
        )
    _raise_on(err, "coarse_kernel")
    coarse.launches += 1
    return t0, status


coarse.launches = 0


def _fine_launch(scene: SceneBuffers, cam, bound, p: PrepassParams, t0, status, residuals: bool, cull):
    dev = _check_scene(scene, cam, bound, p)
    _check_cull(cull, scene.spec, p, dev)
    if not p.no_prepass:
        _check("t0", t0, torch.float32, (p.rows, p.width), dev)
        _check("status", status, torch.float32, (p.rows, p.width), dev)
    if dev.type == "cpu":
        out = fine_res_plain(scene, cam, bound, p, t0, status, cull)
        return out if residuals else out[0]
    from .. import _build

    lib = _build.load()
    img = torch.empty((p.rows, p.width, 3), dtype=torch.float32, device=dev)
    t = hit = None
    if residuals:
        t = torch.empty((p.rows, p.width, p.naa * p.naa), dtype=torch.float32, device=dev)
        hit = torch.empty_like(t)
    cp = _CParams.of(p)
    cc = _CCull.of(cull)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_fine_launch(
            *_scene_ptrs(scene), cam.data_ptr(), bound.data_ptr(),
            ctypes.addressof(cp), ctypes.addressof(cc),
            None if p.no_prepass else t0.data_ptr(),
            None if p.no_prepass else status.data_ptr(),
            img.data_ptr(),
            t.data_ptr() if residuals else None,
            hit.data_ptr() if residuals else None,
            int(scene.spec.has_materials),
            stream,
        )
    _raise_on(err, "fine_kernel")
    if residuals:
        fine_res.launches += 1
        return img, t, hit
    fine.launches += 1
    return img


def fine(scene: SceneBuffers, cam, bound, p: PrepassParams, t0=None, status=None,
         cull: TileCull | None = None):
    """Fine pass -> image f32[rows, W, 3] on the inputs' device. `t0` and
    `status` are the coarse planes (None with `p.no_prepass`); `cull` is the
    fine grid's TileCull of a culled frame."""
    return _fine_launch(scene, cam, bound, p, t0, status, False, cull)


def fine_res(scene: SceneBuffers, cam, bound, p: PrepassParams, t0=None, status=None,
             cull: TileCull | None = None):
    """Fine pass that also keeps its residuals -> (image f32[rows, W, 3], t,
    hit f32[rows, W, S]), the counterpart of the Pallas fine kernel with
    `emit_th=True` (pallas_prepass.py:1850-1862). The image is the one
    `fine` gives; t and hit are each AA ray's march end and hit flag, in
    the lane order of the kernel (pixel-major, sample fastest)."""
    return _fine_launch(scene, cam, bound, p, t0, status, True, cull)


fine.launches = 0
fine_res.launches = 0


def reset_launch_counts():
    coarse.launches = 0
    fine.launches = 0
    fine_res.launches = 0


# --------------------------------------------------------------------------
# Renderer


class PrepassRenderer:
    """`renderer(arrays, cam_vec) -> image f32[H, W, 3]` on one device.

    Built once per (spec, cfg, width, height, device, no_prepass); a scene
    edit that keeps the TapeSpec uploads new arrays and reuses it. The tape
    topology (and with `cfg.leaf_cull` the compact plan) is uploaded once,
    at construction; the culling masks and lists are built on the device
    once per frame (`cull_args`) and shared by both kernels.
    """

    def __init__(self, spec, cfg, width, height, device, no_prepass):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.params = PrepassParams.make(cfg, width, height, no_prepass)
        self.topology = scene_topology(spec, device)
        plan = build_compact_plan(spec) if cfg.leaf_cull else None
        # A plan with residual subtrees takes the gated tape (culling.py's
        # lemma makes the FAR substitution exact), as does a scene with no
        # plan; the reference unrolls the residual tree around its lists.
        self.compact = plan is not None and not plan["residual_ops"]
        self.plan = plan
        self.prog = plan_program(spec, device) if self.compact else None

    def scene_args(self, arrays: TapeArrays, cam_vec):
        """(SceneBuffers, cam f32[8], bound f32[8]) for one frame, all on
        this renderer's device. Parameters and camera given as tensors must
        lie there already and are used detached. The bound comes from the
        current parameters: tensors get it computed on the device, with no
        host round trip; numpy parameters get the numpy form (the same
        bits) and one small upload, which costs the host less than the
        torch form's launches."""
        scene = scene_buffers(self.spec, arrays, self.device, self.topology)
        if not self.params.use_bound:
            bound = torch.zeros(8, dtype=torch.float32, device=self.device)
        elif torch.is_tensor(arrays.leaf_params) or torch.is_tensor(arrays.op_param):
            bound = compute_bound_torch(self.spec, scene.leaf_params, scene.op_param)
        else:
            bound = torch.as_tensor(compute_bound(self.spec, arrays), device=self.device)
        cam = torch.as_tensor(cam_vec, dtype=torch.float32).detach()
        if cam.device != self.device:
            raise ValueError(f"cam_vec is on {cam.device}, expected {self.device}")
        return scene, cam, bound

    def _grid_cull(self, bounds, cam, tile: int, extra_angle: float) -> TileCull:
        from .culling import compact_plan_rows, tile_leaf_masks

        p = self.params
        n_ty, n_tx = -(-p.rows // tile), -(-p.width // tile)
        masks = tile_leaf_masks(bounds, cam, self.cfg, p.width, p.height, n_ty, n_tx,
                                float(tile), float(tile), extra_angle=extra_angle)
        if not self.compact:
            return TileCull(tile, n_tx, masks)
        lists, counts = compact_plan_rows(self.spec, self.plan, masks)
        return TileCull(tile, n_tx, masks, lists, counts, self.prog)

    def cull_args(self, scene: SceneBuffers, cam):
        """(coarse TileCull or None, fine TileCull) of one frame, or (None,
        None) without `cfg.leaf_cull`. The coarse tiles' cones widen by the
        prepass cone angle omega, so that they hold every centre ray's cone
        (pallas_prepass.py:1308-1314, 1343-1347)."""
        if not self.cfg.leaf_cull:
            return None, None
        from .culling import leaf_bound_spheres

        p = self.params
        omega = cone_omega(self.cfg, p.width, p.height, 1)
        bounds = leaf_bound_spheres(self.spec, scene, self.cfg)
        coarse_cull = None if p.no_prepass else self._grid_cull(bounds, cam, COARSE_TILE, omega)
        return coarse_cull, self._grid_cull(bounds, cam, FINE_TILE, 0.0)

    def coarse(self, arrays, cam_vec):
        scene, cam, bound = self.scene_args(arrays, cam_vec)
        return coarse(scene, cam, bound, self.params, self.cull_args(scene, cam)[0])

    def fine(self, arrays, cam_vec, pre):
        scene, cam, bound = self.scene_args(arrays, cam_vec)
        return fine(scene, cam, bound, self.params, *pre, cull=self.cull_args(scene, cam)[1])

    def __call__(self, arrays: TapeArrays, cam_vec):
        scene, cam, bound = self.scene_args(arrays, cam_vec)
        cc, fc = self.cull_args(scene, cam)
        pre = () if self.params.no_prepass else coarse(scene, cam, bound, self.params, cc)
        return fine(scene, cam, bound, self.params, *pre, cull=fc)

    def render_plain(self, arrays: TapeArrays, cam_vec):
        """The same frame through the plain versions, on this device."""
        scene, cam, bound = self.scene_args(arrays, cam_vec)
        cc, fc = self.cull_args(scene, cam)
        pre = () if self.params.no_prepass else coarse_plain(scene, cam, bound, self.params, cc)
        return fine_plain(scene, cam, bound, self.params, *pre, cull=fc)


def _not_ported(option: str, item: str):
    raise NotImplementedError(f"{option} is not ported yet (ROADMAP: {item})")


def resolve_device(device) -> torch.device:
    """"cpu" or "cuda[:n]" -> a torch.device with the CUDA index filled in;
    raises for CUDA without a GPU and for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} was asked for, but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev


def make_pallas_image_render_aa(
    spec: TapeSpec,
    cfg: RenderConfig,
    width: int,
    height: int,
    *,
    device,
    prepass_block: int = 1,
    band_rows=None,
    prepass_chain: bool = False,
    n_intervals: int = 0,
    no_prepass: bool = False,
    aa_packed: bool = True,
    soft: bool = False,
    march_only: bool = False,
) -> PrepassRenderer:
    """Cone-prepass forward renderer (the port's counterpart of
    `raymarch_tpu.ops.pallas_prepass.make_pallas_image_render_aa`), cached
    per (spec, cfg, width, height, device, no_prepass).

    Takes the main path's options: prepass_block=1, aa_packed=True, a
    static tape (painted or not), n_intervals=0, with or without
    `cfg.leaf_cull` (per-tile culling: compacted item lists for a compact
    plan, else the gated tape) and `cfg.relax > 1` (relaxed fine march);
    and `no_prepass=True`, the strict-reference path (every AA ray marches
    from t=0). Every other option raises NotImplementedError naming its
    ROADMAP item.
    """
    if prepass_block != 1:
        _not_ported("prepass_block > 1", "§1.9 many-primitive forward")
    if prepass_chain:
        _not_ported("prepass_chain", "§1.13 remaining surfaces, K3 coarse_px_kernel")
    if band_rows is not None:
        _not_ported("band_rows", "§1.11 multi-device")
    if n_intervals:
        _not_ported("n_intervals", "§1.8 forward variants on the main kernels")
    if soft:
        _not_ported("soft", "§1.10 many-primitive backward and soft coverage")
    if march_only:
        _not_ported("march_only", "§1.13 remaining surfaces")
    if not aa_packed or cfg.aa_shared_normals:
        _not_ported("the unpacked fine pass (aa_shared_normals)", "§1.13 remaining surfaces, K4 fine_kernel")
    if spec.static_tape is None:
        _not_ported("a dynamic tape", "§1.12 dynamic tape, tiered runtime and viewer")
    return _cached_renderer(spec, cfg, int(width), int(height), resolve_device(device), bool(no_prepass))


@functools.lru_cache(maxsize=None)
def _cached_renderer(spec, cfg, width, height, device, no_prepass):
    return PrepassRenderer(spec, cfg, width, height, device, no_prepass)
