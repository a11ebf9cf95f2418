"""Cone-prepass forward renderer: four CUDA kernels and their plain versions.

Port of `raymarch_tpu/ops/pallas_prepass.py:make_pallas_image_render_aa`,
for a band of `rows` image rows starting at cam[7]:

1. **Coarse pass** (`coarse`; kernel `coarse_kernel` in csrc/prepass.cu,
   replacing the Pallas `coarse_kernel`, pallas_prepass.py:885). One cone
   ray per B x B pixel block (B = prepass_block; its centre at pixel
   coordinate (b + 0.5) * B), stopped at `d < min_dist + omega*t` and
   stepped by `(d - omega*t)/(1+omega)`, omega the block's cone angle:
   every AA ray of the block is un-crossed up to the stop distance, so it
   becomes the block's safe start `t0`; `status` is 1 where the cone
   stopped near a surface, 0 where it escaped (a miss). With n_intervals
   = ni > 0 the centre ray scans the whole scene instead and records up to
   ni near intervals (`coarse_interval_plain`): 2*ni planes, starts then
   ends, 3.0e38 for "no interval".
2. **Chained pixel pass** (`coarse_px`; kernel `coarse_px_kernel`,
   replacing `coarse_px_kernel`, pallas_prepass.py:969), with
   prepass_chain=True and B > 1: one cone ray per pixel at the pixel cone
   angle, started at its block's t0 (dead where the block's cone missed),
   over the whole tape (un-culled, as the reference's).
3. **Fine pass** (`fine`; kernel `fine_kernel`, replacing
   `fine_packed_kernel`, pallas_prepass.py:1521). Every AA ray sphere-traces
   from its pixel's t0 (read at block (i // B, j // B) of block planes), or
   through its block's near intervals, jumping the gaps between them; hit
   rays take tetrahedron normals and Lambert shading (with the albedo the
   static tape carries to the hit point on a painted scene), misses the
   analytic checker floor, then sqrt gamma and the AA mean: f32[rows, W, 3].
   In soft-coverage mode (`soft=True`, no prepass) every AA ray marches
   from t = 0 and also keeps its closest approach (s_min, t_min); the hit
   mask becomes the coverage alpha = exp(-max(s_min - min_dist, 0) / beta),
   and a ray that missed shades the surface term at its closest approach
   (`_fine_march_tile_soft` and the soft branch of `fine_packed_kernel`,
   pallas_prepass.py:380-476, 1696-1760). Its builds (csrc/fine_soft.cu)
   round like `fine_res_plain`, with no FMA contraction. Its march-only
   build (`fine_march`, csrc/fine_march.cu) writes each AA ray's (t, hit)
   and nothing else: the reference's `march_only` launch (1827) behind
   `make_pallas_image_march_fast`.
4. **Unpacked fine pass** (`fine_unpacked`; kernel `fine_unpacked_kernel`
   in csrc/fine_unpacked.cu, replacing the Pallas `fine_kernel`,
   pallas_prepass.py:1010, launched at 1504). The same AA rays, march and
   shading as the fine pass, in one thread per pixel that walks its S
   samples in order: it takes any aa_samples and `cfg.aa_shared_normals`
   (the first sample to hit a pixel computes the 4-tap normal, the later
   ones reuse it), which the AA-packed layout cannot.

A dynamic tape (`compile_scene(scene)`) runs on the DYN builds of every
kernel above: the coarse, chained pixel and hard fine kernels
(csrc/prepass_dyn.cu), the soft fine builds (csrc/fine_soft.cu), the
march-only builds (csrc/fine_march.cu) and K4 (csrc/fine_unpacked.cu): the
frame's tape is uploaded with its arrays, and the plain versions run it on
the reference's stack machine (`sdf._apply_dynamic_tape`, gated by the tile
masks under culling). `n_intervals` takes any count: up to MAX_NI the
interval builds keep a block's intervals in registers, above it their
builds in csrc/intervals_wide.cu read them in place from the planes.

Each wrapper takes tensors on one device. On the CPU it runs its plain
version (`coarse_plain`, `coarse_px_plain`, `fine_plain`: vectorised torch
over all rays, a masked loop of at most the kernel's step budget, the same
formulas); on a CUDA device it launches the kernel, or raises. It never
falls back from one to the other.
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

# The reference's "+inf" (pallas_prepass.py:188): a finite f32, compared with
# `< 9.0e37`, so that planes multiplied by 0/1 masks stay finite.
_INF_CAP = 3.0e38
_INF_TEST = 9.0e37
# Most near intervals a kernel build keeps in registers (csrc MAX_NI); more
# take the builds that read them in place (csrc/intervals_wide.cu).
MAX_NI = 4


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
    block: int
    ni: int
    chain: int
    brows: int
    bcols: int
    omega_px: float
    inv1w_px: float
    soft: bool
    beta_inv: float  # f32(1 / coverage_beta)
    soft_infl: float  # f32(min_dist + soft_cull_log_alpha * coverage_beta): the soft bound's inflation
    soft_gate: float  # f32(1e-4 * min(1, coverage_beta)): the soft backward's per-ray work gate
    unpacked: bool = False  # the fine pass is K4 (`fine_unpacked`), one thread per pixel
    shared_normals: bool = False  # K4 shares each pixel's first hit normal (cfg.aa_shared_normals)

    @property
    def plane_block(self) -> int:
        """Pixel size of the prepass planes the fine pass reads: B for the
        coarse kernel's block planes, 1 after the chained pixel pass."""
        return 1 if self.chain else self.block

    @property
    def plane_shape(self) -> tuple:
        return (self.rows, self.width) if self.chain else (self.brows, self.bcols)

    @staticmethod
    def make(cfg: RenderConfig, width: int, height: int, no_prepass: bool = False, block: int = 1,
             n_intervals: int = 0, chain: bool = False, band_rows: int | None = None, soft: bool = False,
             unpacked: bool = False):
        tanf = math.tan(cfg.fovy / 2.0)
        omega = cone_omega(cfg, width, height, block)
        omega_px = cone_omega(cfg, width, height, 1)
        naa = cfg.aa_samples
        rows = height if band_rows is None else band_rows
        return PrepassParams(
            width=width,
            height=height,
            rows=rows,
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
            block=block,
            ni=n_intervals,
            chain=int(chain and block > 1),
            brows=-(-rows // block),
            bcols=-(-width // block),
            omega_px=_f32(omega_px),
            inv1w_px=_f32(1.0 / (1.0 + omega_px)),
            soft=bool(soft),
            beta_inv=_f32(1.0 / cfg.coverage_beta),
            soft_infl=_f32(cfg.min_dist + cfg.soft_cull_log_alpha * cfg.coverage_beta),
            soft_gate=_f32(1e-4 * min(1.0, float(cfg.coverage_beta))),
            unpacked=bool(unpacked),
            shared_normals=bool(unpacked and cfg.aa_shared_normals),
        )


class _CParams(ctypes.Structure):
    """ctypes mirror of `RenderParams` in csrc/render_common.cuh, field by field."""

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

    @classmethod
    def of(cls, p: PrepassParams):
        c = cls()
        for name, _ in cls._fields_:
            v = getattr(p, name)
            if isinstance(v, tuple):
                getattr(c, name)[:] = v
            else:
                setattr(c, name, v)
        return c


class _CBlockParams(ctypes.Structure):
    """ctypes mirror of `BlockParams` in csrc/render_common.cuh, the
    PrepassParams fields after `relax_back`."""

    _fields_ = [
        ("block", ctypes.c_int32),
        ("ni", ctypes.c_int32),
        ("chain", ctypes.c_int32),
        ("brows", ctypes.c_int32),
        ("bcols", ctypes.c_int32),
        ("omega_px", ctypes.c_float),
        ("inv1w_px", ctypes.c_float),
    ]

    of = classmethod(_CParams.of.__func__)


class _CSoftParams(ctypes.Structure):
    """ctypes mirror of `SoftParams` in csrc/fine.cuh: the soft fine
    pass's closest-approach outputs (null: not kept) and its constants."""

    _fields_ = [
        ("s_min_out", ctypes.c_void_p),
        ("t_min_out", ctypes.c_void_p),
        ("beta_inv", ctypes.c_float),
        ("infl", ctypes.c_float),
    ]


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
    every pushed leaf (unculled; a dynamic tape's read from its tape)."""
    if cull is None:
        ops = scene.tape[0].tolist() if scene.dynamic else [c for c, _a, _s in scene.spec.static_tape]
        return sum(1 for c in ops if c == oc.COP_PUSH)
    if cull.compact:
        return cull.counts.sum(dim=1)[tid].to(torch.float32)
    from .culling import _active_from_mask

    active = _active_from_mask(scene.spec, cull.masks)
    if scene.dynamic:  # the rows this frame's tape pushes
        pushed = torch.zeros(scene.spec.n_leaves, dtype=torch.bool, device=active.device)
        pushed[scene.tape[1][scene.tape[0] == oc.COP_PUSH].long()] = True
        active = active & pushed[None, :]
    return active.sum(dim=1)[tid].to(torch.float32)


def _band_ij(p: PrepassParams, dev):
    """Band row and column indices, shaped to broadcast against [rows, W, S]."""
    return torch.arange(p.rows, device=dev)[:, None, None], torch.arange(p.width, device=dev)[None, :, None]


def _cone_march_plain(scene_fn, p: PrepassParams, omega: float, inv1w: float, ox, oy, oz, dx, dy, dz, t,
                      live, t_cap, work=None, leaves=None):
    """The cone march of centre rays from (t, live) -> (t0, status)
    (pallas_prepass._cone_march_tile, 130-185)."""
    near = torch.zeros_like(t)
    for _ in range(p.max_iter):
        if not bool(live.any()):
            break
        if work is not None:
            work.add(live, leaves)
        d = scene_fn(ox + dx * t, oy + dy * t, oz + dz * t)
        slack = d - omega * t
        near_now = torch.where(slack < p.min_dist, live, 0.0)
        escaped = torch.where((d > p.max_dist) | (t > t_cap), live, 0.0)
        escaped = escaped - escaped * near_now
        advance = live - near_now - escaped
        t = t + slack * inv1w * advance
        live = live - near_now - escaped
        near = near + near_now
    return t, near


def _interval_scan_plain(scene_fn, p: PrepassParams, ox, oy, oz, dx, dy, dz, t, live, t_cap, work=None,
                         leaves=None):
    """The centre ray's scan of the whole scene for up to p.ni near
    intervals -> [s_0 .. s_{ni-1}, e_0 .. e_{ni-1}]
    (pallas_prepass._cone_interval_march_tile, 191-293): plain sphere steps
    inside a near zone, cone steps outside, for at most 2 * max_iter steps.
    A zone's end reverts to +inf (fine rays then march plainly from its
    start) when the centre ray hits inside it, when it is open at the end
    of the budget, and, for the last zone, when one more zone would open
    (the ray then stops). The zone index is the count of closed zones."""
    ni = p.ni
    zero = torch.zeros_like(t)
    starts = [zero + _INF_CAP for _ in range(ni)]
    ends = [zero + _INF_CAP for _ in range(ni)]
    was_near = zero
    idx = zero
    for _ in range(2 * p.max_iter):
        if not bool(live.any()):
            break
        if work is not None:
            work.add(live, leaves)
        d = scene_fn(ox + dx * t, oy + dy * t, oz + dz * t)
        slack = d - p.omega * t
        near = torch.where(slack < p.min_dist, live, 0.0)
        hit_c = torch.where(d < p.min_dist, near, 0.0)
        esc = torch.where((d > p.max_dist) | (t > t_cap), live, 0.0)
        esc = esc - esc * hit_c
        opening = near * (1.0 - was_near)
        closing = torch.where(was_near > 0.0, (1.0 - near) + esc, 0.0)
        closing = torch.clamp_max(closing, 1.0) * live
        overflow = torch.where(idx > ni - 0.5, opening, 0.0)
        opening = opening - overflow
        for j in range(ni):
            at = (idx - j).abs() < 0.5
            starts[j] = torch.where(at & (opening > 0.0), t, starts[j])
            e = torch.where(at & (closing > 0.0), t, ends[j])
            e = torch.where(at & (hit_c > 0.0), _INF_CAP, e)
            if j == ni - 1:
                e = torch.where(overflow > 0.0, _INF_CAP, e)
            ends[j] = e
        idx = idx + closing
        live2 = torch.clamp_min(live - hit_c - esc - overflow * live, 0.0)
        stp = torch.where(near > 0.0, d, slack * p.inv1w)
        t = t + stp * live2
        was_near = near * live2
        live = live2
    for j in range(ni):
        ends[j] = torch.where((was_near > 0.0) & ((idx - j).abs() < 0.5), _INF_CAP, ends[j])
    return starts + ends


def _block_rays(p: PrepassParams, cam):
    """Centre rays of the band's B x B blocks, f32[brows, bcols] each: the
    screen point of pixel coordinate (b + 0.5) * B in the f32 op order of
    pallas_prepass.py:910-911 (an edge block's centre may lie outside the
    image; it is marched all the same)."""
    dev = cam.device
    i = torch.arange(p.brows, device=dev, dtype=torch.float32)[:, None]
    j = torch.arange(p.bcols, device=dev, dtype=torch.float32)[None, :]
    x = div_rn(2.0 * ((j + 0.5) * p.block), p.width) - 1.0
    y = 1.0 - div_rn(2.0 * ((i + 0.5) * p.block + cam[7]), p.height)
    x, y = (v.contiguous() for v in torch.broadcast_tensors(x, y))
    dx, dy, dz = _view_dirs(x, y, cam, p)
    return (*_origin(cam, dx), dx, dy, dz)


def _clipped_start(p: PrepassParams, bound, ox, oy, oz, dx, dy, dz):
    """(t, live, t_cap) of rays from the camera, clipped by the scene's
    bounding sphere under bound_accel."""
    zero = torch.zeros_like(dx)
    t, live, t_cap = zero, zero + 1.0, zero + _INF_CAP
    if p.use_bound:
        live, t, t_cap = _bound_clip(bound, ox, oy, oz, dx, dy, dz, live, t, t_cap, p.min_dist)
    return t, live, t_cap


def coarse_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, cull: TileCull | None = None,
                 work: WorkCount | None = None):
    """Plain version of the coarse kernel -> (t0, status) f32[brows, bcols],
    or with p.ni the 2*ni interval planes (`coarse_interval_plain`). `cull`
    is the coarse grid's TileCull (tiles of whole blocks); `work`, when
    given, counts the pass's scene and leaf evaluations."""
    if p.ni:
        return coarse_interval_plain(scene, cam, bound, p, cull, work)
    ox, oy, oz, dx, dy, dz = _block_rays(p, cam)
    tid = cull.tile_index(*_block_ij(p, cam.device)) if cull is not None else None
    t, live, t_cap = _clipped_start(p, bound, ox, oy, oz, dx, dy, dz)
    leaves = leaves_per_point(scene, cull, tid) if work is not None else None
    return _cone_march_plain(scene_fn_plain(scene, p.max_dist, cull, tid), p, p.omega, p.inv1w, ox, oy, oz,
                             dx, dy, dz, t, live, t_cap, work, leaves)


def coarse_interval_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, cull: TileCull | None = None,
                          work: WorkCount | None = None):
    """Plain version of the coarse kernel's interval scan -> 2*ni planes
    f32[brows, bcols]: the starts s_0 .. s_{ni-1}, then the ends; 3.0e38
    where the block has no such interval."""
    ox, oy, oz, dx, dy, dz = _block_rays(p, cam)
    tid = cull.tile_index(*_block_ij(p, cam.device)) if cull is not None else None
    t, live, t_cap = _clipped_start(p, bound, ox, oy, oz, dx, dy, dz)
    leaves = leaves_per_point(scene, cull, tid) if work is not None else None
    return tuple(_interval_scan_plain(scene_fn_plain(scene, p.max_dist, cull, tid), p, ox, oy, oz, dx, dy, dz,
                                      t, live, t_cap, work, leaves))


def coarse_px_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, t_blk, status_blk,
                    work: WorkCount | None = None):
    """Plain version of the chained pixel pass (K3) -> (t0, status)
    f32[rows, W]: each pixel's cone ray at the pixel cone angle, over the
    whole tape, from max(its bound-clip start, its block's t0), dead where
    its block's status is 0 (pallas_prepass.py:969-1005, 152-154)."""
    dev = cam.device
    i = torch.arange(p.rows, device=dev, dtype=torch.float32)[:, None]
    j = torch.arange(p.width, device=dev, dtype=torch.float32)[None, :]
    x = div_rn(2.0 * (j + 0.5), p.width) - 1.0
    y = 1.0 - div_rn(2.0 * ((i + 0.5) + cam[7]), p.height)
    x, y = (v.contiguous() for v in torch.broadcast_tensors(x, y))
    dx, dy, dz = _view_dirs(x, y, cam, p)
    ox, oy, oz = _origin(cam, dx)
    t, live, t_cap = _clipped_start(p, bound, ox, oy, oz, dx, dy, dz)
    t_in, live_in = (expand_plane(v, p.block, p.rows, p.width) for v in (t_blk, status_blk))
    live = live * live_in
    t = torch.maximum(t, t_in) * live_in
    leaves = leaves_per_point(scene, None) if work is not None else None
    return _cone_march_plain(scene_fn_plain(scene, p.max_dist, None), p, p.omega_px, p.inv1w_px, ox, oy, oz,
                             dx, dy, dz, t, live, t_cap, work, leaves)


def _block_ij(p: PrepassParams, dev):
    return torch.arange(p.brows, device=dev)[:, None], torch.arange(p.bcols, device=dev)[None, :]


def expand_plane(v, block: int, rows: int, width: int):
    """A prepass plane at B x B block resolution -> f32[rows, W]: pixel (i,
    j) reads block (i // B, j // B), the reference's repeat-and-crop
    (pallas_prepass.py:1397-1406) as an index map."""
    if block == 1:
        return v
    dev = v.device
    ii = torch.div(torch.arange(rows, device=dev), block, rounding_mode="floor")
    jj = torch.div(torch.arange(width, device=dev), block, rounding_mode="floor")
    return v.index_select(0, ii).index_select(1, jj)


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


def _fine_rays(scene: SceneBuffers, cam, p: PrepassParams, cull: TileCull | None, work: WorkCount | None):
    """What the plain fine passes (K2's and K4's) start from: the AA rays
    (ox, oy, oz, dx, dy, dz) f32[rows, W, S], the pass's scene and albedo
    functions under `cull`, and the leaves per point when `work` counts."""
    x, y = aa_screen(p, cam)
    dx, dy, dz = _view_dirs(x, y, cam, p)
    ox, oy, oz = _origin(cam, dx)
    tid = cull.tile_index(*_band_ij(p, cam.device)) if cull is not None else None
    leaves = leaves_per_point(scene, cull, tid) if work is not None else None
    return ((ox, oy, oz, dx, dy, dz), scene_fn_plain(scene, p.max_dist, cull, tid),
            albedo_fn_plain(scene, p, cull, tid), leaves)


def fine_res_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, *pre, cull: TileCull | None = None,
                   work: WorkCount | None = None):
    """Plain version of the fine kernel with residuals -> (image f32[rows,
    W, 3], t, hit f32[rows, W, S]): each AA ray's march end and hit flag;
    in soft mode (p.soft) also s_min, t_min f32[rows, W, S], each ray's
    closest approach and its parameter. `pre` holds the prepass planes at
    `p.plane_shape`: (t0, status), or with p.ni the 2*ni interval planes
    (none with `p.no_prepass`). `cull` is the fine grid's TileCull of a
    culled frame; `work`, when given, counts the pass's scene and leaf
    evaluations (in soft mode its `hits` counts the rays that take the
    surface term, alpha > 0)."""
    (ox, oy, oz, dx, dy, dz), scene_fn, albedo_fn, leaves = _fine_rays(scene, cam, p, cull, work)
    if p.soft:
        t, hit, s_min, t_min = _soft_march_plain(scene_fn, p, bound, ox, oy, oz, dx, dy, dz, work, leaves)
        cols = shade_soft_plain(scene, p, ox, oy, oz, dx, dy, dz, t, hit, s_min, t_min, scene_fn, albedo_fn)
        if work is not None:
            shaded = (soft_alpha(p, s_min) > 0.0).to(torch.float32)
            work.add(shaded, leaves, points_per=4)  # the normal taps
            work.hits = work.hits + shaded.sum()
        img = torch.stack([torch.sum(c, dim=-1) * p.inv_s for c in cols], dim=-1)
        return img, t, hit, s_min, t_min

    t, hit = _hard_march_plain(scene_fn, p, bound, (ox, oy, oz, dx, dy, dz), pre, work, leaves)
    if work is not None:
        work.add(hit, leaves, points_per=4)  # the normal taps of hit rays
        work.hits = work.hits + hit.sum()
    cols = shade_plain(scene, p, ox, oy, oz, dx, dy, dz, t, hit, scene_fn, albedo_fn)
    img = torch.stack([torch.sum(c, dim=-1) * p.inv_s for c in cols], dim=-1)
    return img, t, hit


def _hard_march_plain(scene_fn, p: PrepassParams, bound, rays, pre, work=None, leaves=None):
    """The fine march of the AA rays `rays` = (ox, oy, oz, dx, dy, dz)
    f32[rows, W, S] from the prepass planes `pre` -> (t, hit): from each
    pixel's t0 (or t = 0 without a prepass), plainly or over-relaxed, or
    through its block's near intervals; the march K2 and K4 share."""
    ox, oy, oz, dx, dy, dz = rays
    zero = torch.zeros_like(dx)
    pre = [expand_plane(v, p.plane_block, p.rows, p.width)[:, :, None] for v in pre]
    if p.no_prepass:
        t = zero
        live = zero + 1.0
    elif p.ni:
        # A ray lives iff its block has a first interval, and starts there
        # (pallas_prepass.py:1604-1608).
        live = torch.where(zero + pre[0] < _INF_TEST, 1.0, 0.0)
        t = torch.where(live > 0.0, zero + pre[0], 0.0)
    else:
        t = zero + pre[0]
        live = zero + pre[1]
    t_cap = zero + _INF_CAP
    if p.use_bound:
        _, _, t_cap = _bound_clip(
            bound, ox, oy, oz, dx, dy, dz, live, t, t_cap, p.min_dist
        )
    if p.ni and not p.no_prepass:
        return _interval_march_plain(scene_fn, p, ox, oy, oz, dx, dy, dz, t, live, t_cap,
                                     [zero + v for v in pre[: p.ni]], [zero + v for v in pre[p.ni:]],
                                     work, leaves)
    if p.relax > 1.0:
        return _relaxed_march_plain(scene_fn, p, ox, oy, oz, dx, dy, dz, t, live, t_cap, work, leaves)
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
    return t, hit


def fine_unpacked_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, *pre, cull: TileCull | None = None,
                        work: WorkCount | None = None):
    """Plain version of the unpacked fine kernel K4 -> (image f32[rows, W,
    3], t, hit f32[rows, W, S]). Each AA ray marches and shades as in
    `fine_res_plain`; with `p.shared_normals` the first sample in sample
    order that hits a pixel takes the 4 taps at its own hit point, and every
    hitting sample of the pixel shades with that normal and its own hit
    point (pallas_prepass.py:1206-1232). The AA mean sums the samples in
    sample order, then scales by 1/S, as the kernel (and the reference's
    accumulator) does. `work` counts the taps per hit ray, or per pixel
    with a hit when the normal is shared."""
    (ox, oy, oz, dx, dy, dz), scene_fn, albedo_fn, leaves = _fine_rays(scene, cam, p, cull, work)
    t, hit = _hard_march_plain(scene_fn, p, bound, (ox, oy, oz, dx, dy, dz), pre, work, leaves)
    normal = None
    if p.shared_normals:
        # The first hitting sample of each pixel (argmax takes the first of
        # equal maxima; a pixel without a hit takes sample 0, unread).
        first = torch.argmax(hit, dim=-1, keepdim=True)
        at = [torch.gather(v, -1, first) for v in (ox + dx * t * hit, oy + dy * t * hit, oz + dz * t * hit)]
        normal = tet_taps_plain(scene_fn, *at, p.eps)
        tapped = (hit.amax(dim=-1, keepdim=True) > 0.0).to(torch.float32)
    if work is not None:
        work.add(tapped if p.shared_normals else hit, leaves, points_per=4)  # the normal taps
        work.hits = work.hits + hit.sum()
    px, py, pz = ox + dx * t * hit, oy + dy * t * hit, oz + dz * t * hit
    cols = _shade_at(scene, p, ox, oy, oz, dx, dy, dz, px, py, pz, hit, scene_fn, albedo_fn, normal)
    img = torch.stack([_sample_order_mean(c, p.inv_s) for c in cols], dim=-1)
    return img, t, hit


def _sample_order_mean(c, inv_s: float):
    """The mean over the last (sample) axis as K4 takes it: the sum in
    sample order, then times f32(1/S)."""
    acc = c[..., 0]
    for s in range(1, c.shape[-1]):
        acc = acc + c[..., s]
    return acc * inv_s


def _soft_march_plain(scene_fn, p: PrepassParams, bound, ox, oy, oz, dx, dy, dz, work=None, leaves=None):
    """The soft fine march (pallas_prepass._fine_march_tile_soft, 380-476)
    -> (t, hit, s_min, t_min): plain steps from t = 0 that also keep the
    smallest scene distance met at a live sample (strict <) and its t. With
    bound_accel the scene's bounding sphere, inflated by min_dist +
    soft_cull_log_alpha * beta, clips the rays, caps t at -bq + R + min_dist
    and ends a ray past the sphere's centre once |p - c| - R exceeds its
    s_min: no later sample could lower s_min or hit. At most max_iter
    samples count (exit_check_every only blocks the exit test)."""
    zero = torch.zeros_like(dx)
    live = zero + 1.0
    t_cap = zero + _INF_CAP
    t_mid = zero + _INF_CAP
    if p.use_bound:
        bcx, bcy, bcz, bvalid = bound[0], bound[1], bound[2], bound[4]
        br = bound[3] + p.soft_infl
        ocx = ox - bcx
        ocy = oy - bcy
        ocz = oz - bcz
        bq = dx * ocx + dy * ocy + dz * ocz
        c2 = ocx * ocx + ocy * ocy + ocz * ocz - br * br
        disc = bq * bq - c2
        t_exit = -bq + sqrt_rn(torch.clamp_min(disc, 0.0))
        use = bvalid > 0.0
        live = torch.where(use, torch.where((disc > 0.0) & (t_exit > 0.0), live, 0.0), live)
        t_cap = torch.where(use, -bq + br + p.min_dist, t_cap)
        t_mid = torch.where(use, -bq, t_mid)
    t = zero
    hit = zero
    s_min = zero + _INF_CAP
    t_min = zero
    for _ in range(p.max_iter):
        if not bool(live.any()):
            break
        if work is not None:
            work.add(live, leaves)
        px = ox + dx * t
        py = oy + dy * t
        pz = oz + dz * t
        d = scene_fn(px, py, pz)
        better = (live > 0.0) & (d < s_min)
        s_min = torch.where(better, d, s_min)
        t_min = torch.where(better, t, t_min)
        hit_now = torch.where(d < p.min_dist, live, 0.0)
        esc = (d > p.max_dist) | (t > t_cap)
        if p.use_bound:
            pc = sqrt_rn((px - bcx) * (px - bcx) + (py - bcy) * (py - bcy) + (pz - bcz) * (pz - bcz) + 1e-20)
            esc = esc | ((t > t_mid) & (pc - br > s_min))
        escaped = torch.where(esc, live, 0.0)
        escaped = escaped - escaped * hit_now
        advance = live - hit_now - escaped
        t = t + d * advance
        live = live - hit_now - escaped
        hit = hit + hit_now
    return t, hit, s_min, t_min


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


def _interval_march_plain(scene_fn, p: PrepassParams, ox, oy, oz, dx, dy, dz, t, live, t_cap, starts, ends,
                          work=None, leaves=None):
    """The fine march through near intervals (pallas_prepass.
    _fine_march_interval_tile, 296-377): plain steps, or with relax > 1 the
    over-relaxed steps and their fallback, inside interval idx; a step past
    its end e_idx jumps to max(t, s_{idx+1}) with omega, step and previous
    radius reset, or, with no next interval, is a miss. Hit and escape are
    tested only at samples that did not overshoot."""
    ni = p.ni
    zero = torch.zeros_like(t)
    idx = zero
    prev_r = zero
    step_len = zero
    omega = zero + p.relax
    hit = zero

    def cur_end(idx):
        e = ends[ni - 1]
        for j in range(ni - 2, -1, -1):
            e = torch.where(idx < j + 0.5, ends[j], e)
        return e

    def next_start(idx):
        s = zero + _INF_CAP
        for j in range(ni - 1, 0, -1):
            s = torch.where(idx < j - 0.5, starts[j], s)
        return s

    for _ in range(p.max_iter):
        if not bool(live.any()):
            break
        if work is not None:
            work.add(live, leaves)
        d = scene_fn(ox + dx * t, oy + dy * t, oz + dz * t)
        fail = torch.where((omega > 1.0) & (d + prev_r < step_len), live, 0.0)
        ok = live - fail
        hit_now = torch.where(d < p.min_dist, ok, 0.0)
        escaped = torch.where((d > p.max_dist) | (t > t_cap), ok, 0.0)
        escaped = escaped - escaped * hit_now
        new_step = torch.where(fail > 0.0, p.relax_back * step_len, omega * d)
        omega2 = torch.where(fail > 0.0, 1.0, omega)
        live2 = live - hit_now - escaped
        t2 = t + new_step * live2
        crossed = torch.where(t2 > cur_end(idx), live2, 0.0)
        ns = next_start(idx)
        no_more = torch.where(ns > _INF_TEST, crossed, 0.0)
        jump = crossed - no_more
        t = torch.where(jump > 0.0, torch.maximum(t2, ns), t2)
        idx = idx + jump
        omega = torch.where(jump > 0.0, p.relax, omega2)
        step_len = torch.where(jump > 0.0, 0.0, new_step)
        prev_r = torch.where(jump > 0.0, 0.0, d)
        live = live2 - no_more
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
    px = ox + dx * t * hit
    py = oy + dy * t * hit
    pz = oz + dz * t * hit
    return _shade_at(scene, p, ox, oy, oz, dx, dy, dz, px, py, pz, hit, scene_fn, albedo_fn)


def soft_alpha(p: PrepassParams, s_min):
    """The coverage of a soft ray, exp(-max(s_min - min_dist, 0) / beta)
    (shade_soft, march.py:250): 1 on a hit, 0.0 in f32 past ~104 beta."""
    return torch.exp(-torch.clamp_min(s_min - p.min_dist, 0.0) * p.beta_inv)


def shade_soft_plain(scene: SceneBuffers, p: PrepassParams, ox, oy, oz, dx, dy, dz, t, hit, s_min, t_min,
                     scene_fn=None, albedo_fn=None):
    """Per-ray colour of the soft fine pass (pallas_prepass.py:1709-1760,
    ops.march.shade_soft): the coverage alpha (`soft_alpha`) takes the place
    of the hit mask; the surface term sits at the march end on a hit, at
    the closest approach t_min on a miss, and at the ray's origin where
    alpha <= 1e-4 (the reference's NaN guard); the floor is blended by 1 -
    alpha. Differentiable in the scene, the ray, t and s_min; t_min is
    frozen. Rays of alpha exactly 0 take no surface term, which is exact:
    it enters the colour multiplied by alpha."""
    alpha = soft_alpha(p, s_min)
    t_eff = torch.where(hit > 0.5, t, t_min.detach())
    live = alpha > 1e-4
    px = torch.where(live, ox + dx * t_eff, ox)
    py = torch.where(live, oy + dy * t_eff, oy)
    pz = torch.where(live, oz + dz * t_eff, oz)
    return _shade_at(scene, p, ox, oy, oz, dx, dy, dz, px, py, pz, alpha, scene_fn, albedo_fn)


def _shade_at(scene: SceneBuffers, p: PrepassParams, ox, oy, oz, dx, dy, dz, px, py, pz, cover, scene_fn,
              albedo_fn, normal=None):
    """The colour of rays whose surface term sits at (px, py, pz) with
    coverage `cover` (the hit mask, or the soft alpha): cover * albedo *
    Lambert + (1 - cover) * the checker floor, then sqrt gamma. `normal`,
    when given, is the unnormalised normal (nx, ny, nz) to shade with (K4's
    shared normal), broadcasting against the rays; else the taps at (px,
    py, pz)."""
    if scene_fn is None:
        scene_fn = scene_fn_plain(scene, p.max_dist, None)
    nx, ny, nz = normal if normal is not None else tet_taps_plain(scene_fn, px, py, pz, p.eps)
    ninv = 1.0 / sqrt_rn(nx * nx + ny * ny + nz * nz + 1e-20)
    tlx = px - p.light[0]
    tly = py - p.light[1]
    tlz = pz - p.light[2]
    linv = 1.0 / sqrt_rn(tlx * tlx + tly * tly + tlz * tlz + 1e-20)
    diff = (nx * tlx + ny * tly + nz * tlz) * (ninv * linv)
    diff = torch.clamp_min(diff, p.ambient)
    # A miss takes diff = 0 (shade_miss): select, never multiply by hit = 0.
    diff = torch.where(cover > 0.0, diff, 0.0)
    alb = p.albedo if albedo_fn is None else albedo_fn(px, py, pz)
    fcol = floor_plain(p, ox, oy, oz, dx, dy, dz)
    miss = 1.0 - cover
    return [sqrt_rn(torch.clamp_min(cover * (alb[c] * diff) + miss * fcol[c], 0.0) + 1e-12) for c in range(3)]


def floor_plain(p: PrepassParams, ox, oy, oz, dx, dy, dz):
    """The analytic checker floor's colour (r, g, b) of each ray
    (wgsl:117-128, render_common.cuh `floor_colour`): the base colour plus
    the checker where the ray meets y = floor_y ahead of it, else black."""
    dy_ok = torch.where(torch.abs(dy) > 1e-8, 1.0, 0.0)
    dy_safe = torch.where(torch.abs(dy) > 1e-8, dy, 1e-8)
    ft = (p.floor_y - oy) / dy_safe
    fx = torch.clamp(ox + dx * ft, -1e7, 1e7)
    fz = torch.clamp(oz + dz * ft, -1e7, 1e7)
    ipx = torch.round(fx + 0.5).to(torch.int32)  # half to even, as jnp.round
    ipz = torch.round(fz + 0.5).to(torch.int32)
    parity = torch.bitwise_and(torch.bitwise_xor(ipx, ipz), 1).to(torch.float32)
    on_floor = torch.where(ft > 0.0, dy_ok, 0.0)
    return [(p.floor_base[c] + p.floor_checker * parity) * on_floor for c in range(3)]


def fine_plain(scene: SceneBuffers, cam, bound, p: PrepassParams, *pre, cull: TileCull | None = None,
               work: WorkCount | None = None):
    """Plain version of the fine kernel -> image f32[rows, W, 3]."""
    return fine_res_plain(scene, cam, bound, p, *pre, cull=cull, work=work)[0]


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
    if dev.type == "cuda" and p.rows > 65535:
        raise ValueError(f"{p.rows} rows exceed the launch grid")
    return dev


def _check_packed(p: PrepassParams):
    """The AA-packed fine kernel K2 averages a pixel's samples over adjacent
    lanes: within a warp, or over two (aa_samples = 8). Other AA grids take
    the unpacked fine pass K4 (`fine_unpacked`), as the renderer routes
    them."""
    S = p.naa * p.naa
    if 32 % S and S != 64:
        raise ValueError(
            f"the AA-packed fine kernel needs aa_samples^2 dividing 32 or equal to 64, got {S}: "
            "use the unpacked fine pass (fine_unpacked; make_pallas_image_render_aa routes it)"
        )


def _scene_ptrs(scene: SceneBuffers):
    return (
        scene.leaf_params.data_ptr(),
        scene.row_kind.data_ptr(),
        scene.tape.data_ptr(),
        scene.n_instr,
        scene.op_param.data_ptr(),
    )


def _scene_ptrs_dyn(scene: SceneBuffers):
    """`_scene_ptrs` and the DYN flag, as the prepass launchers take them."""
    return (*_scene_ptrs(scene), int(scene.dynamic))


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def _check_cull(cull: TileCull | None, spec: TapeSpec, grid: tuple, dev):
    """`cull` fits a kernel whose threads cover a `grid` = (rows, columns)
    of pixels or blocks."""
    if cull is None:
        return
    n_ty = -(-grid[0] // cull.tile)
    n_tx = -(-grid[1] // cull.tile)
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
    """Coarse pass -> (t0, status) f32[brows, bcols] on the inputs' device,
    or with p.ni the 2*ni interval planes, starts then ends. `cull` is the
    coarse grid's TileCull of a culled frame (tiles of whole blocks)."""
    dev = _check_scene(scene, cam, bound, p)
    _check_cull(cull, scene.spec, (p.brows, p.bcols), dev)
    if p.no_prepass:
        raise ValueError("a no_prepass renderer has no coarse pass")
    if dev.type == "cpu":
        return coarse_plain(scene, cam, bound, p, cull)
    from .. import _build

    lib = _build.load()
    planes = torch.empty((2 * p.ni if p.ni else 2, p.brows, p.bcols), dtype=torch.float32, device=dev)
    cp = _CParams.of(p)
    cc = _CCull.of(cull)
    cb = _CBlockParams.of(p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_coarse_launch(
            *_scene_ptrs_dyn(scene), cam.data_ptr(), bound.data_ptr(),
            ctypes.addressof(cp), ctypes.addressof(cc), planes.data_ptr(),
            None if p.ni else planes[1].data_ptr(), ctypes.addressof(cb), stream,
        )
    _raise_on(err, "coarse_kernel")
    coarse.count(scene, p)
    return planes.unbind(0)


_COUNTS = ("launches", "interval_launches", "wide_launches", "soft_launches", "dyn_soft_launches",
           "dyn_launches")


def _counter(fn, split_intervals: bool):
    """Gives the wrapper `fn` its launch counts (`_COUNTS`, each 0) and a
    `count(scene, p)` that adds one to the count of the build it launched:
    soft builds "soft_launches" (static tape) or "dyn_soft_launches"; other
    DYN builds (a dynamic tape) "dyn_launches"; past MAX_NI intervals
    "wide_launches"; with `split_intervals` the interval builds
    "interval_launches"; the rest "launches"."""
    for name in _COUNTS:
        setattr(fn, name, 0)

    def count(scene, p):
        if p.soft:
            name = "dyn_soft_launches" if scene.dynamic else "soft_launches"
        elif scene.dynamic:
            name = "dyn_launches"
        elif p.ni > MAX_NI:
            name = "wide_launches"
        elif p.ni and split_intervals:
            name = "interval_launches"
        else:
            name = "launches"
        setattr(fn, name, getattr(fn, name) + 1)

    fn.count = count


_counter(coarse, split_intervals=True)


def coarse_px(scene: SceneBuffers, cam, bound, p: PrepassParams, t_blk, status_blk):
    """Chained pixel pass (prepass_chain, B > 1) -> (t0, status) f32[rows,
    W] on the inputs' device, from the coarse pass's block planes."""
    dev = _check_scene(scene, cam, bound, p)
    if not p.chain:
        raise ValueError("the chained pixel pass needs prepass_chain=True and prepass_block > 1")
    _check("t_blk", t_blk, torch.float32, (p.brows, p.bcols), dev)
    _check("status_blk", status_blk, torch.float32, (p.brows, p.bcols), dev)
    if dev.type == "cpu":
        return coarse_px_plain(scene, cam, bound, p, t_blk, status_blk)
    from .. import _build

    lib = _build.load()
    planes = torch.empty((2, p.rows, p.width), dtype=torch.float32, device=dev)
    cp = _CParams.of(p)
    cb = _CBlockParams.of(p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_coarse_px_launch(
            *_scene_ptrs_dyn(scene), cam.data_ptr(), bound.data_ptr(), ctypes.addressof(cp),
            t_blk.data_ptr(), status_blk.data_ptr(), planes.data_ptr(), planes[1].data_ptr(),
            ctypes.addressof(cb), stream,
        )
    _raise_on(err, "coarse_px_kernel")
    coarse_px.count(scene, p)
    return planes.unbind(0)


_counter(coarse_px, split_intervals=False)


def _check_fine(scene: SceneBuffers, cam, bound, p: PrepassParams, pre, cull):
    dev = _check_scene(scene, cam, bound, p)
    _check_cull(cull, scene.spec, (p.rows, p.width), dev)
    n_pre = 0 if p.no_prepass else (2 * p.ni if p.ni else 2)
    if len(pre) != n_pre:
        raise ValueError(f"the fine pass takes {n_pre} prepass planes, got {len(pre)}")
    for k, v in enumerate(pre):
        _check(f"prepass plane {k}", v, torch.float32, p.plane_shape, dev)
    return dev


def _fine_launch(scene: SceneBuffers, cam, bound, p: PrepassParams, pre, residuals: bool, cull):
    dev = _check_fine(scene, cam, bound, p, pre, cull)
    if dev.type == "cpu":
        out = fine_res_plain(scene, cam, bound, p, *pre, cull=cull)
        return out if residuals else out[0]
    _check_packed(p)
    from .. import _build

    lib = _build.load()
    planes = torch.stack(pre) if p.ni else None  # held until the launch is queued
    img = torch.empty((p.rows, p.width, 3), dtype=torch.float32, device=dev)
    res = ()
    if residuals:
        res = tuple(torch.empty((p.rows, p.width, p.naa * p.naa), dtype=torch.float32, device=dev)
                    for _ in range(4 if p.soft else 2))
    t, hit = res[:2] if res else (None, None)
    cp = _CParams.of(p)
    cc = _CCull.of(cull)
    cb = _CBlockParams.of(p)
    cs = _CSoftParams()  # soft: no prepass; residuals s_min, t_min when kept
    if p.soft:
        cs.beta_inv = p.beta_inv
        cs.infl = p.soft_infl
        if residuals:
            cs.s_min_out = res[2].data_ptr()
            cs.t_min_out = res[3].data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_fine_launch(
            *_scene_ptrs_dyn(scene), cam.data_ptr(), bound.data_ptr(),
            ctypes.addressof(cp), ctypes.addressof(cc),
            planes.data_ptr() if p.ni else (pre[0].data_ptr() if pre else None),
            pre[1].data_ptr() if pre and not p.ni else None,
            img.data_ptr(),
            t.data_ptr() if residuals else None,
            hit.data_ptr() if residuals else None,
            int(scene.spec.has_materials),
            ctypes.addressof(cb),
            int(p.soft),
            ctypes.addressof(cs),
            stream,
        )
    _raise_on(err, "fine_kernel")
    (fine_res if residuals else fine).count(scene, p)
    return (img, *res) if residuals else img


def fine(scene: SceneBuffers, cam, bound, p: PrepassParams, *pre, cull: TileCull | None = None):
    """Fine pass -> image f32[rows, W, 3] on the inputs' device. `pre` are
    the prepass planes at `p.plane_shape` (none with `p.no_prepass`): (t0,
    status), or with p.ni the 2*ni interval planes; `cull` is the fine
    grid's TileCull of a culled frame."""
    return _fine_launch(scene, cam, bound, p, pre, False, cull)


def fine_res(scene: SceneBuffers, cam, bound, p: PrepassParams, *pre, cull: TileCull | None = None):
    """Fine pass that also keeps its residuals -> (image f32[rows, W, 3], t,
    hit f32[rows, W, S]), the counterpart of the Pallas fine kernel with
    `emit_th=True` (pallas_prepass.py:1850-1862). The image is the one
    `fine` gives; t and hit are each AA ray's march end and hit flag, in
    the lane order of the kernel (pixel-major, sample fastest). In soft
    mode it returns (image, t, hit, s_min, t_min): also each ray's closest
    approach and its parameter, the soft backward's residuals (1856)."""
    return _fine_launch(scene, cam, bound, p, pre, True, cull)


def fine_march(scene: SceneBuffers, cam, bound, p: PrepassParams, *pre, cull: TileCull | None = None):
    """The fine pass's march-only build -> (t, hit) f32[rows * W * S]: each
    AA ray's march end and hit flag, flat in pixel-major AA-ray order (r =
    (i * W + j) * S + s), with no taps, shading or image (the reference's
    `march_only` launch of `fine_packed_kernel`, pallas_prepass.py:1813-1843).
    Its plain version is `fine_res_plain`'s (t, hit). Takes every prepass
    form of `fine`; no soft mode."""
    if p.soft:
        raise ValueError("march_only requires aa_packed=True, soft=False")
    dev = _check_fine(scene, cam, bound, p, pre, cull)
    if dev.type == "cpu":
        return tuple(v.reshape(-1) for v in fine_res_plain(scene, cam, bound, p, *pre, cull=cull)[1:3])
    _check_packed(p)
    from .. import _build

    lib = _build.load()
    planes = torch.stack(pre) if p.ni else None  # held until the launch is queued
    n = p.rows * p.width * p.naa * p.naa
    t = torch.empty(n, dtype=torch.float32, device=dev)
    hit = torch.empty(n, dtype=torch.float32, device=dev)
    cp = _CParams.of(p)
    cc = _CCull.of(cull)
    cb = _CBlockParams.of(p)
    cs = _CSoftParams()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_fine_launch(
            *_scene_ptrs_dyn(scene), cam.data_ptr(), bound.data_ptr(),
            ctypes.addressof(cp), ctypes.addressof(cc),
            planes.data_ptr() if p.ni else (pre[0].data_ptr() if pre else None),
            pre[1].data_ptr() if pre and not p.ni else None,
            None, t.data_ptr(), hit.data_ptr(), 0, ctypes.addressof(cb), 0, ctypes.addressof(cs), stream,
        )
    _raise_on(err, "fine_kernel (march only)")
    fine_march.count(scene, p)
    return t, hit


def _fine_unpacked_launch(scene: SceneBuffers, cam, bound, p: PrepassParams, pre, residuals: bool, cull):
    dev = _check_fine(scene, cam, bound, p, pre, cull)
    if p.soft:
        raise ValueError("soft requires no_prepass=True, aa_packed=True")
    if dev.type == "cpu":
        out = fine_unpacked_plain(scene, cam, bound, p, *pre, cull=cull)
        return out if residuals else out[0]
    from .. import _build

    lib = _build.load()
    planes = torch.stack(pre) if p.ni else None  # held until the launch is queued
    img = torch.empty((p.rows, p.width, 3), dtype=torch.float32, device=dev)
    t = hit = None
    if residuals:
        t, hit = (torch.empty((p.rows, p.width, p.naa * p.naa), dtype=torch.float32, device=dev)
                  for _ in range(2))
    cp = _CParams.of(p)
    cc = _CCull.of(cull)
    cb = _CBlockParams.of(p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_fine_unpacked_launch(
            *_scene_ptrs_dyn(scene), cam.data_ptr(), bound.data_ptr(),
            ctypes.addressof(cp), ctypes.addressof(cc),
            planes.data_ptr() if p.ni else (pre[0].data_ptr() if pre else None),
            pre[1].data_ptr() if pre and not p.ni else None,
            img.data_ptr(), None if t is None else t.data_ptr(), None if hit is None else hit.data_ptr(),
            int(scene.spec.has_materials), int(p.shared_normals), ctypes.addressof(cb), stream,
        )
    _raise_on(err, "fine_unpacked_kernel")
    (fine_unpacked_res if residuals else fine_unpacked).count(scene, p)
    return (img, t, hit) if residuals else img


def fine_unpacked(scene: SceneBuffers, cam, bound, p: PrepassParams, *pre, cull: TileCull | None = None):
    """The unpacked fine pass K4 (`csrc/fine_unpacked.cu`) -> image f32[rows,
    W, 3] on the inputs' device: every AA sample of a pixel in one thread,
    in sample order; with `p.shared_normals` the pixel's first hit normal is
    shared. Takes every prepass form of `fine`, static and dynamic tapes,
    and any aa_samples."""
    return _fine_unpacked_launch(scene, cam, bound, p, pre, False, cull)


def fine_unpacked_res(scene: SceneBuffers, cam, bound, p: PrepassParams, *pre, cull: TileCull | None = None):
    """K4 that also keeps its residuals -> (image, t, hit f32[rows, W, S]),
    in the layout `fine_res` writes them (the legacy backward K8 reads
    either)."""
    return _fine_unpacked_launch(scene, cam, bound, p, pre, True, cull)


# The fine passes' counts by build (`_counter`); `fine` counts the march
# through at most MAX_NI near intervals apart from the legacy planes.
_counter(fine, split_intervals=True)
for _fn in (fine_res, fine_march, fine_unpacked, fine_unpacked_res):
    _counter(_fn, split_intervals=False)


def reset_launch_counts():
    for fn in (coarse, coarse_px, fine, fine_res, fine_march, fine_unpacked, fine_unpacked_res):
        for name in vars(fn):
            if name.endswith("launches"):
                setattr(fn, name, 0)


# --------------------------------------------------------------------------
# Renderer


def frame_args(spec: TapeSpec, p: PrepassParams, topology, device, arrays: TapeArrays, cam_vec):
    """(SceneBuffers, cam f32[8] or None, bound f32[8]) for one frame, all
    on `device`. Parameters and camera given as tensors must lie there
    already and are used detached. The bound comes from the current
    parameters: tensors get it computed on the device, with no host round
    trip; numpy parameters get the numpy form (the same bits) and one small
    upload, which costs the host less than the torch form's launches."""
    scene = scene_buffers(spec, arrays, device, topology)
    if not p.use_bound:
        bound = torch.zeros(8, dtype=torch.float32, device=device)
    elif torch.is_tensor(arrays.leaf_params) or torch.is_tensor(arrays.op_param):
        bound = compute_bound_torch(spec, scene.leaf_params, scene.op_param)
    else:
        bound = torch.as_tensor(compute_bound(spec, arrays), device=device)
    cam = None
    if cam_vec is not None:
        cam = torch.as_tensor(cam_vec, dtype=torch.float32).detach()
        if cam.device != device:
            raise ValueError(f"cam_vec is on {cam.device}, expected {device}")
    return scene, cam, bound


class PrepassRenderer:
    """`renderer(arrays, cam_vec) -> image f32[rows, W, 3]` on one device:
    the band of `rows` image rows (all H without band_rows) that starts at
    image row cam_vec[7].

    Built once per (spec, cfg, width, height, device, options); a scene
    edit that keeps the TapeSpec uploads new arrays and reuses it. The tape
    topology (and with `cfg.leaf_cull` the compact plan) is uploaded once,
    at construction; the culling masks and lists are built on the device
    once per frame (`cull_args`) and shared by both kernels.
    """

    def __init__(self, spec, cfg, width, height, device, no_prepass, block=1, n_intervals=0, chain=False,
                 band_rows=None, soft=False, march_only=False, unpacked=False):
        self.march_only = march_only
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.params = PrepassParams.make(cfg, width, height, no_prepass, block, n_intervals, chain, band_rows,
                                         soft, unpacked)
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
        this renderer's device (`frame_args`)."""
        return frame_args(self.spec, self.params, self.topology, self.device, arrays, cam_vec)

    def _grid_cull(self, bounds, cam, grid: tuple, tile: int, tile_px: int, extra_angle: float) -> TileCull:
        """The TileCull of a kernel whose threads cover `grid` = (rows,
        columns) of pixels or blocks, in tiles of `tile` x `tile` of them
        (`tile_px` pixels a side)."""
        from .culling import compact_plan_rows, tile_leaf_masks

        p = self.params
        n_ty, n_tx = -(-grid[0] // tile), -(-grid[1] // tile)
        masks = tile_leaf_masks(bounds, cam, self.cfg, p.width, p.height, n_ty, n_tx,
                                float(tile_px), float(tile_px), extra_angle=extra_angle)
        if not self.compact:
            return TileCull(tile, n_tx, masks)
        lists, counts = compact_plan_rows(self.spec, self.plan, masks)
        return TileCull(tile, n_tx, masks, lists, counts, self.prog)

    def cull_args(self, scene: SceneBuffers, cam):
        """(coarse TileCull or None, fine TileCull) of one frame, or (None,
        None) without `cfg.leaf_cull`. The coarse tiles are squares of whole
        B x B blocks, COARSE_TILE pixels a side rounded up to a multiple of
        B, and their cones widen by the block cone angle omega, so that they
        hold every block ray's cone (pallas_prepass.py:1308-1314,
        1343-1347). Both grids cover the band. In soft mode the leaf bounds
        take the soft inflation (1307, 1332, 1342)."""
        if not self.cfg.leaf_cull:
            return None, None
        from .culling import leaf_bound_spheres

        p = self.params
        bounds = leaf_bound_spheres(self.spec, scene, self.cfg, soft=p.soft)
        coarse_cull = None
        if not p.no_prepass:
            tb = -(-COARSE_TILE // p.block)
            omega = cone_omega(self.cfg, p.width, p.height, p.block)
            coarse_cull = self._grid_cull(bounds, cam, (p.brows, p.bcols), tb, tb * p.block, omega)
        return coarse_cull, self._grid_cull(bounds, cam, (p.rows, p.width), FINE_TILE, FINE_TILE, 0.0)

    def prepass(self, scene: SceneBuffers, cam, bound, coarse_cull, plain: bool = False):
        """The prepass planes the fine pass reads: the coarse pass's, then,
        chained, the pixel pass's; () with no_prepass. `plain` runs the
        plain versions."""
        p = self.params
        if p.no_prepass:
            return ()
        pre = (coarse_plain if plain else coarse)(scene, cam, bound, p, coarse_cull)
        if p.chain:
            pre = (coarse_px_plain if plain else coarse_px)(scene, cam, bound, p, *pre)
        return pre

    def coarse(self, arrays, cam_vec):
        scene, cam, bound = self.scene_args(arrays, cam_vec)
        return self.prepass(scene, cam, bound, self.cull_args(scene, cam)[0])

    def fine_pass(self, residuals: bool = False):
        """The fine pass of this renderer: K2 (`fine`, `fine_res`), K4
        (`fine_unpacked`, `fine_unpacked_res`) or the march-only build."""
        if self.march_only:
            return fine_march
        if self.params.unpacked:
            return fine_unpacked_res if residuals else fine_unpacked
        return fine_res if residuals else fine

    def fine(self, arrays, cam_vec, pre):
        scene, cam, bound = self.scene_args(arrays, cam_vec)
        return self.fine_pass()(scene, cam, bound, self.params, *pre, cull=self.cull_args(scene, cam)[1])

    def __call__(self, arrays: TapeArrays, cam_vec):
        """The band's image, or with `march_only` its AA rays' (t, hit)
        f32[N], flat in pixel-major order."""
        scene, cam, bound = self.scene_args(arrays, cam_vec)
        cc, fc = self.cull_args(scene, cam)
        return self.fine_pass()(scene, cam, bound, self.params, *self.prepass(scene, cam, bound, cc), cull=fc)

    def render_plain(self, arrays: TapeArrays, cam_vec):
        """The same frame (or march) through the plain versions, on this
        device."""
        scene, cam, bound = self.scene_args(arrays, cam_vec)
        cc, fc = self.cull_args(scene, cam)
        plain = fine_unpacked_plain if self.params.unpacked else fine_res_plain
        out = plain(scene, cam, bound, self.params, *self.prepass(scene, cam, bound, cc, plain=True), cull=fc)
        return tuple(v.reshape(-1) for v in out[1:3]) if self.march_only else out[0]


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
    device="cuda",
    prepass_block: int = 1,
    band_rows=None,
    prepass_chain: bool = False,
    n_intervals: int = 0,
    no_prepass: bool = False,
    aa_packed: bool | None = None,
    soft: bool = False,
    march_only: bool = False,
) -> PrepassRenderer:
    """Cone-prepass forward renderer (the port's counterpart of
    `raymarch_tpu.ops.pallas_prepass.make_pallas_image_render_aa`), cached
    per (spec, cfg, width, height, device and the options below).

    Takes a static tape (painted or not) or a dynamic one
    (`compile_scene(scene)`: the frame's tape is uploaded with its arrays
    and interpreted by the kernels' DYN builds, so a topology edit within
    the bucket builds nothing), with or without `cfg.leaf_cull` (per-tile
    culling: compacted item lists for a static compact plan, else the gated
    tape) and `cfg.relax > 1` (relaxed fine march), and:
    - `prepass_block` = B >= 1: one coarse cone per B x B pixel block
      (values below 1 read as 1, as the reference's);
    - `n_intervals` = ni >= 0: the near-interval prepass (0: the
      first-near prepass), any count;
    - `prepass_chain`: the chained pixel pass after a B > 1 block pass (a
      no-op at B = 1, as the reference's);
    - `band_rows`: render the band of that many rows starting at image row
      cam_vec[7];
    - `no_prepass=True`, the strict-reference path (every AA ray marches
      from t=0);
    - `soft=True` with `no_prepass=True`: soft-coverage rendering, whose
      `fine_res` also keeps each ray's closest approach (s_min, t_min), the
      soft fused VJP's forward; with `cfg.leaf_cull` the leaf bounds take
      the soft inflation.
    - `aa_packed` picks the fine pass. The AA-packed kernel K2 keeps a
      pixel's samples in adjacent lanes and takes aa_samples^2 dividing
      128 (aa 1, 2, 4, 8); the unpacked kernel K4 walks a pixel's samples
      in one thread and takes any aa_samples and `cfg.aa_shared_normals`.
      None (the default; the reference's default is False) packs wherever
      K2 can render the call and takes K4 elsewhere: with
      `cfg.aa_shared_normals` or an AA grid that does not pack. True packs
      too, and also falls to K4 where the grid does not pack (so the
      reference's `make_renderer` call form, `aa_packed=not
      cfg.aa_shared_normals`, renders aa = 3); with `cfg.aa_shared_normals`
      it raises the reference's ValueError. False takes K4.
    `device` defaults to the card ("cuda"); "cpu" runs the plain versions.
    - `march_only=True`: the renderer returns each AA ray's (t, hit)
      f32[N], flat in pixel-major order, through the fine kernel's
      march-only build (no taps, shading or image).
    It raises the reference's ValueErrors for prepass_chain with intervals,
    for no_prepass with either, for march_only or soft without packing,
    for soft without no_prepass or with relax > 1, and for aa_packed with
    aa_shared_normals. Every option takes a dynamic tape, as the reference's.
    """
    S = cfg.aa_samples ** 2
    if aa_packed and cfg.aa_shared_normals:
        raise ValueError("aa_packed excludes aa_shared_normals")
    unpacked = aa_packed is False or bool(cfg.aa_shared_normals) or 128 % S != 0
    if march_only and (unpacked or soft):
        raise ValueError("march_only requires aa_packed=True, soft=False")
    ni = max(0, int(n_intervals))
    if ni and prepass_chain:
        raise ValueError("prepass_chain is a legacy-prepass feature")
    if no_prepass and (ni or prepass_chain):
        raise ValueError("no_prepass excludes interval/chained prepasses")
    if band_rows is not None and int(band_rows) < 1:
        raise ValueError(f"band_rows must be at least 1, got {band_rows}")
    if soft:
        # The closest approach can lie anywhere along the ray: a prepass
        # would skip it and relaxed steps would move the sampled argmin
        # (pallas_prepass.py:642-656).
        if not no_prepass or unpacked:
            raise ValueError("soft requires no_prepass=True, aa_packed=True")
        if cfg.relax > 1.0:
            raise ValueError("soft requires relax=1.0 (relaxed stepping changes the closest-approach sample)")
    block = max(1, int(prepass_block))
    chain = bool(prepass_chain) and block > 1
    return _cached_renderer(spec, cfg, int(width), int(height), resolve_device(device), bool(no_prepass), block,
                            ni, chain, None if band_rows is None else int(band_rows), bool(soft), bool(march_only),
                            unpacked)


@functools.lru_cache(maxsize=None)
def _cached_renderer(spec, cfg, width, height, device, no_prepass, block=1, n_intervals=0, chain=False,
                     band_rows=None, soft=False, march_only=False, unpacked=False):
    return PrepassRenderer(spec, cfg, width, height, device, no_prepass, block, n_intervals, chain, band_rows,
                           soft, march_only, unpacked)


def make_pallas_image_march_fast(spec: TapeSpec, cfg: RenderConfig, width: int, height: int,
                                 interpret: bool = False, *, device="cuda", **kw):
    """The march-only fast path (pallas_prepass.py:1932-1949): `fn(arrays,
    cam_vec f32[8]) -> (t[N], hit[N])` flat f32 in pixel-major AA-ray
    order, N = aa^2 * H * W: the cone prepass, then the fine kernel's
    march-only build (with culling when cfg.leaf_cull). `kw` are
    `make_pallas_image_render_aa`'s options; `prepass_block` defaults to
    the reference's 4. `interpret` has no effect."""
    del interpret
    kw.setdefault("prepass_block", 4)
    return make_pallas_image_render_aa(spec, cfg, width, height, device=device, aa_packed=True, march_only=True,
                                       **kw)
