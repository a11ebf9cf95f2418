"""Fused forward+backward renderer: the cone-prepass forward that keeps its
residuals, and a CUDA backward kernel.

Port of `raymarch_tpu/ops/pallas_grad.py:make_fused_render_vjp` (1221):
the legacy backward (`backward_info["kind"] == "pallas_legacy_unrolled"`)
of every static tape, painted or not, of any length, and with
`cfg.leaf_cull` the compact backward of every compact plan without
residual subtrees (`"pallas_compact"`): pool, seg1 chain and stream plans,
and painted pools.

- Forward: the coarse kernel (per pixel, or per B x B block with
  `prepass_block`), then the fine kernel with residuals
  (`cuda_prepass.fine_res`, the counterpart of the Pallas fine kernel with
  `emit_th=True`): the image, and each AA ray's march end t and hit flag;
  culled per tile with `cfg.leaf_cull`. Where the layout is unpacked
  (aa_packed=False, or aa_samples^2 not dividing 128) the unpacked fine
  pass K4 (`cuda_prepass.fine_unpacked_res`) writes the same residuals.
- Compact backward (`compact_bwd`; kernel `compact_bwd_kernel` in
  csrc/compact_bwd.cu, replacing `_make_compact_bwd.bwd_kernel`,
  pallas_grad.py:256): the same gradient with every scene evaluation
  folded over the ray's fine-tile lists and each point's cotangent pushed
  through its winning source alone: the pool's winning leaf, or the
  reverse sweep of the seg1 chain's or a stream segment's ordered fold
  (blend radii included); on a painted pool also the winner's albedo.
  `compact_bwd_plain` is its autograd replay.
- Backward (`bwd`; kernel `fused_bwd_kernel` in csrc/fused_bwd.cu,
  replacing `bwd_kernel`, pallas_grad.py:1432): per hit ray, the adjoint of
  the shading chain plus the implicit-function term, summed over rays into
  one flat vector of `16 * n_rows + n_real + 7` words (pallas_grad.py:
  1653-1699, unpacked as `_run_bwd` does at 1830-1840). On a painted scene
  the shading reads the albedo of the colour walk at the hit point, and its
  cotangent reaches the leaves' albedo and flag words and, through the
  smooth blend weights, the geometry, the blend radii and the hit point
  (`_albedo_tile`, 1386-1402). It reads the tape packed (`GradLayout.
  packed`), keeps compact reverse records (2 bits per hard op, a float per
  smooth op) in shared memory or, where they would crowd the block out of
  it, in device memory within L2 (`GradLayout.rec_in_smem`), and sums its
  gradient in per-thread rows (the per-thread build, `GradLayout.long`
  false) or in warp-aggregated adds to one row per block, in shared memory
  or, for a row too large for it, in device memory (`row_in_smem`): no
  scene is too large for it.

`bwd_plain` is the same gradient by torch autograd through a replay of
`shade_loss` and `implicit_loss` (1600-1699) from the residuals, in row
bands so that no graph spans the whole frame. On CPU tensors `bwd` runs
it; on a CUDA device `bwd` launches the kernel, or raises.

Soft coverage (`soft=True`, silhouette gradients, pallas_grad.py:1243-1249,
1510-1597, 1683-1743): the forward is the fine kernel's soft build with no
prepass, which also keeps each ray's closest approach (s_min, t_min); both
backwards take their soft builds, which replay `shade_loss_soft` (the
coverage alpha in the place of the hit mask) and add the envelope term at
the frozen point o + d t_min, for every ray that hit or whose coverage
exceeds 1e-4 * min(1, beta). A painted scene takes K8 in soft mode, as in
the reference.

Both the residuals (8 bytes per AA ray: 265 MB at 1920x1080 with 16 AA
rays per pixel; 16 bytes, 531 MB, in soft mode) and the saved parameters
live until the backward runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import types

import numpy as np
import torch

from ..config import RenderConfig
from ..utils import profiling
from . import opcodes as oc
from .cuda_march import (
    SceneBuffers,
    build_compact_plan,
    pool_albedo_plain,
    scene_color_plain,
    scene_compact_plain,
    scene_plain,
)
from .cuda_prepass import (
    PrepassParams,
    TileCull,
    _CCull,
    _CParams,
    _check,
    _check_cull,
    _origin,
    _raise_on,
    _scene_ptrs,
    _view_dirs,
    aa_screen,
    make_pallas_image_render_aa,
    resolve_device,
    shade_plain,
    shade_soft_plain,
    soft_alpha,
    tile_active,
)
from .tape import TapeArrays, TapeSpec

MAX_BWD_INSTR = 64  # the per-thread build's longest tape
# Shared memory the per-thread build's rows may take a block (nscal * 65
# floats: at most 126 words). Measured on an H100 (PERF.md): config 2's 60
# words run faster in per-thread rows (1.90 against 2.16 ms), 16 painted
# spheres' 294 words in the warp-row build (4.12 against 7.15 ms), where
# per-thread rows of 76 KB a block cut its residency.
THREAD_ROWS_SMEM = 32 << 10
BWD_THREADS = 64  # csrc/fused_bwd.cu BWD_THREADS: the per-thread build
BWD_WARP_THREADS = 128  # csrc/fused_bwd.cu BWD_WARP_THREADS: the warp-row build
CBWD_THREADS = 128  # csrc/compact_bwd.cu CBWD_THREADS
SMEM_PER_BLOCK = 232448  # an H100 block's shared memory, bytes
# Shared memory a backward block gives its gradient row and its threads'
# reverse records: past these they go to device memory (a row as atomics
# into the output after the warp's reduction, records as a slice per
# thread), so that several blocks stay resident on an SM.
ROW_SMEM = 64 << 10
REC_SMEM = 32 << 10
# Device memory the backwards' per-thread records may take there (the
# legacy backward's reverse records, the compact backward's fold history):
# within the card's 50 MB L2, so that they never reach HBM; the launch grid
# shrinks until every thread's slice fits.
REC_BUDGET = 32 << 20
# Record sets of a legacy backward thread (csrc/scene_grad.cuh TAP_SETS):
# the 4 taps; a painted scene adds the colour walk's.
TAP_SETS = 4
SMOOTH_OPS = (oc.COP_SMOOTH_UNION, oc.COP_SMOOTH_INTERSECTION, oc.COP_SMOOTH_SUBTRACTION)
PLAIN_BAND_ROWS = 64  # rows per autograd graph in bwd_plain


@dataclasses.dataclass(frozen=True)
class GradLayout:
    """Where each gradient word sits in the backward's flat vector
    (pallas_grad.py:1311-1316): 16 words for each pushed leaf row, in row
    order, then one per real tape instruction, then 7 camera words."""

    n_leaves: int
    n_instr: int
    pushed_rows: tuple
    n_real: int
    push_slot: tuple  # per real instruction: slot base of its leaf row, else 0
    grad_denom_clamp: float
    # The tape as the kernel reads it: per real instruction (op | out_slot
    # << 8, leaf row, the row's kind, push_slot); and its smooth ops.
    packed: tuple = ()
    n_smooth: int = 0

    @staticmethod
    def of(spec: TapeSpec, cfg: RenderConfig) -> "GradLayout":
        from .cuda_march import pack_words, row_kinds

        tape = spec.static_tape
        rows = tuple(sorted({a for c, a, _ in tape if c == oc.COP_PUSH}))
        base = {r: 16 * k for k, r in enumerate(rows)}
        push_slot = tuple(base[a] if c == oc.COP_PUSH else 0 for c, a, _ in tape)
        cols = np.asarray(tape, np.int32).reshape(-1, 3).T
        return GradLayout(
            n_leaves=spec.n_leaves,
            n_instr=spec.n_instr,
            pushed_rows=rows,
            n_real=len(tape),
            push_slot=push_slot,
            grad_denom_clamp=float(cfg.grad_denom_clamp),
            packed=tuple(map(tuple, pack_words(*cols, row_kinds(spec), push_slot).tolist())),
            n_smooth=sum(c in SMOOTH_OPS for c, _, _ in tape),
        )

    @property
    def op_base(self) -> int:
        return 16 * len(self.pushed_rows)

    @property
    def cam_base(self) -> int:
        return self.op_base + self.n_real

    @property
    def nscal(self) -> int:
        return self.cam_base + 7

    @property
    def long(self) -> bool:
        """True when the backward takes its warp-row build (one gradient row
        per block, warp-aggregated adds), False for the per-thread build (a
        row per thread in shared memory): a tape of more than MAX_BWD_INSTR
        instructions, or rows of more than THREAD_ROWS_SMEM bytes a block."""
        return self.n_real > MAX_BWD_INSTR or self.nscal * (BWD_THREADS + 1) * 4 > THREAD_ROWS_SMEM

    @property
    def threads(self) -> int:
        return BWD_WARP_THREADS if self.long else BWD_THREADS

    @property
    def row_in_smem(self) -> bool:
        """The warp-row build's row sits in shared memory, else it is added
        straight into the output in device memory (the per-thread build's
        rows always sit in shared memory)."""
        return not self.long or self.nscal * 4 <= ROW_SMEM

    def rec_words(self, mats: bool) -> int:
        """32-bit words of reverse records per thread (csrc/scene_grad.cuh
        rec_words): 2-bit codes of every instruction, 16 to a word, in
        TAP_SETS sets (+1 painted), and per smooth op one float in each tap
        set and 4 in the colour set."""
        sets = TAP_SETS + int(mats)
        return sets * (-(-self.n_real // 16)) + (TAP_SETS + 4 * int(mats)) * self.n_smooth

    def rec_in_smem(self, mats: bool) -> bool:
        """The threads' records fit the block's REC_SMEM bytes of shared
        memory; else each keeps them in device memory."""
        return self.rec_words(mats) * 4 * self.threads <= REC_SMEM

    def unpack(self, flat: torch.Tensor):
        """Flat f32[nscal] -> (d_lp f32[n_leaves, 16], d_opp f32[n_instr],
        d_cam f32[8]): unpushed rows, padding instructions and cam[7] (the
        band's row offset) get zeros."""
        dev = flat.device
        d_lp = torch.zeros((self.n_leaves, oc.LEAF_PARAM_WIDTH), dtype=torch.float32, device=dev)
        if self.pushed_rows:
            idx = _device_index(self.pushed_rows, dev)
            d_lp.index_copy_(0, idx, flat[: self.op_base].view(-1, oc.LEAF_PARAM_WIDTH))
        d_opp = torch.zeros(self.n_instr, dtype=torch.float32, device=dev)
        d_opp[: self.n_real] = flat[self.op_base : self.cam_base]
        d_cam = torch.cat([flat[self.cam_base :], torch.zeros(1, dtype=torch.float32, device=dev)])
        return d_lp, d_opp, d_cam


@functools.lru_cache(maxsize=None)
def _device_index(rows: tuple, device: torch.device) -> torch.Tensor:
    """`rows` as an i64 tensor on `device`, uploaded once: an upload from
    pageable host memory waits for the stream, so one per backward would
    stall the host behind the kernel."""
    return torch.as_tensor(rows, dtype=torch.int64, device=device)


# --------------------------------------------------------------------------
# Plain version


def _bwd_plain_band(scene: SceneBuffers, cam, p: PrepassParams, clamp: float, t, hit, g_img, i0,
                    scene_fn_of=None, albedo_fn_of=None, soft=None):
    """Gradient of one band of rows [i0, i0 + len(t)) -> (d_lp, d_opp,
    d_cam7), the replay of pallas_grad.py:1600-1699 by autograd.
    `scene_fn_of(sc)` gives the scene function of the scene buffers `sc`
    (default: the whole tape, `scene_plain`), `albedo_fn_of(sc)` the
    albedo function of a painted scene (default: cfg.albedo). `soft` =
    (s_min, t_min) of the band replays the soft shading instead
    (`shade_soft_plain`, differentiated in s_min too) over the rays that
    pass the soft work gate, and adds the envelope term: the cotangent of
    s_min times the scene at the frozen point o + d t_min (1683-1696)."""
    if scene_fn_of is None:
        def scene_fn_of(sc):
            return lambda px, py, pz: scene_plain(sc, p.max_dist, px, py, pz)
    # The fused backward runs inside autograd's backward, where grad mode
    # is off: the replay turns it on for itself.
    with torch.enable_grad():
        n = t.shape[0]
        lp = scene.leaf_params.detach().clone().requires_grad_(True)
        opp = scene.op_param.detach().clone().requires_grad_(True)
        cam7 = cam[:7].detach().clone().requires_grad_(True)
        cam_g = torch.cat([cam7, cam[7:].detach()])
        sc = dataclasses.replace(scene, leaf_params=lp, op_param=opp)
        x, y = aa_screen(p, cam.detach(), i0, n)
        g = [g_img[:, :, c : c + 1] * p.inv_s for c in range(3)]
        if soft is not None:
            s_min, t_min = soft
            # The per-ray work gate of the soft kernels (scene_grad.cuh
            # soft_work): a skipped ray contributes nothing.
            work = ((hit > 0.0) | (soft_alpha(p, s_min) > p.soft_gate)).to(torch.float32)
            g = [gc * work for gc in g]

        def rays(c):
            dx, dy, dz = _view_dirs(x, y, c, p)
            return _origin(c, dx) + (dx, dy, dz)

        # Explicit shading path: dL/d(theta, cam, t[, s_min]) (shade_loss,
        # shade_loss_soft).
        tt = t.detach().clone().requires_grad_(True)
        albedo_fn = None if albedo_fn_of is None else albedo_fn_of(sc)
        if soft is None:
            cols = shade_plain(sc, p, *rays(cam_g), tt, hit, scene_fn_of(sc), albedo_fn)
            wrt = (lp, opp, cam7, tt)
        else:
            sm = s_min.detach().clone().requires_grad_(True)
            cols = shade_soft_plain(sc, p, *rays(cam_g), tt, hit, sm, t_min, scene_fn_of(sc), albedo_fn)
            wrt = (lp, opp, cam7, tt, sm)
        loss = sum(torch.sum(col * gc) for col, gc in zip(cols, g))
        g1 = torch.autograd.grad(loss, wrt, allow_unused=True)
        gt = g1[3] if g1[3] is not None else torch.zeros_like(t)

        # Implicit term: dt/dtheta through the hit constraint F(o + d t) = 0.
        with torch.no_grad():
            ox, oy, oz, dx, dy, dz = rays(cam.detach())
        ts = t.detach().clone().requires_grad_(True)
        f = scene_fn_of(scene)(ox + dx * ts, oy + dy * ts, oz + dz * ts)
        (fdot,) = torch.autograd.grad(f.sum(), ts)
        c = clamp
        denom = torch.where(torch.abs(fdot) > c, fdot, torch.where(fdot >= 0, c, -c))
        w = (-gt * hit / denom).detach()
        qx, qy, qz, ex, ey, ez = rays(cam_g)
        f = scene_fn_of(sc)(qx + ex * t * hit, qy + ey * t * hit, qz + ez * t * hit)
        total = torch.sum(w * f)
        if soft is not None and g1[4] is not None:
            # Envelope (Danskin) term at the frozen closest approach.
            tm = t_min.detach()
            f_env = scene_fn_of(sc)(qx + ex * tm, qy + ey * tm, qz + ez * tm)
            total = total + torch.sum(g1[4].detach() * f_env)
        g2 = torch.autograd.grad(total, (lp, opp, cam7), allow_unused=True)

    out = []
    for a, b, like in zip(g1[:3], g2, (lp, opp, cam7)):
        s = torch.zeros_like(like)
        for v in (a, b):
            if v is not None:
                s = s + v
        out.append(s.detach())
    return out


def bwd_plain(scene: SceneBuffers, cam, p: PrepassParams, lay: GradLayout, t, hit, g_img,
              band_rows: int = PLAIN_BAND_ROWS, soft=None):
    """Plain version of the fused backward -> (d_lp f32[n_leaves, 16], d_opp
    f32[n_instr], d_cam f32[8]) on the inputs' device, from the residuals
    (t, hit f32[rows, W, S]) and the image cotangent g_img f32[rows, W, 3].
    A painted scene shades with the albedo of the whole tape's colour walk
    at the hit point (`scene_color_plain`, un-gated as the reference's
    `_albedo_tile` is in this backward). `soft` = (s_min, t_min) f32[rows,
    W, S] takes the soft backward (`_bwd_plain_band`). The gradient is a sum
    over rays, so it runs `band_rows` rows at a time and adds the bands'
    gradients."""
    albedo_fn_of = None
    if scene.spec.has_materials:
        def albedo_fn_of(sc):
            return lambda px, py, pz: scene_color_plain(sc, p.max_dist, p.albedo, px, py, pz)[1]
    d_lp = torch.zeros_like(scene.leaf_params)
    d_opp = torch.zeros_like(scene.op_param)
    d_cam7 = torch.zeros(7, dtype=torch.float32, device=cam.device)
    for i0 in range(0, p.rows, band_rows):
        i1 = min(i0 + band_rows, p.rows)
        a, b, c = _bwd_plain_band(scene, cam, p, lay.grad_denom_clamp, t[i0:i1], hit[i0:i1], g_img[i0:i1], i0,
                                  albedo_fn_of=albedo_fn_of, soft=_band(soft, i0, i1))
        d_lp += a
        d_opp += b
        d_cam7 += c
    # Words the kernel never writes are zero in its layout as well.
    keep = torch.zeros(lay.n_instr, dtype=torch.bool, device=cam.device)
    keep[: lay.n_real] = True
    d_opp = torch.where(keep, d_opp, 0.0)
    return d_lp, d_opp, torch.cat([d_cam7, torch.zeros(1, dtype=torch.float32, device=cam.device)])


def _band(soft, i0, i1):
    return None if soft is None else tuple(v[i0:i1] for v in soft)


def compact_bwd_plain(scene: SceneBuffers, cull: TileCull, cam, p: PrepassParams, clamp: float,
                      t, hit, g_img, band_rows: int = PLAIN_BAND_ROWS, soft=None):
    """Plain version of the compact backward -> (d_lp f32[n_leaves, 16],
    d_opp f32[n_instr], d_cam f32[8]): `bwd_plain`'s autograd replay in row
    bands, with every scene evaluation the ray's fine-tile compact scene
    (`scene_compact_plain`: pool, seg1 chain and stream folds, each winner
    chosen by an explicit strict `<`), so each point's cotangent reaches its
    winning source alone; on a painted scene the shading reads the albedo
    of the hit point's pool winner (`pool_albedo_plain`). `cull`
    is the fine grid's TileCull of the forward that wrote the residuals (t,
    hit); `soft` = (s_min, t_min) takes the soft backward, whose envelope
    point's cotangent reaches its own winning source."""
    spec = scene.spec
    plan = build_compact_plan(spec)
    d_lp = torch.zeros_like(scene.leaf_params)
    d_opp = torch.zeros_like(scene.op_param)
    d_cam7 = torch.zeros(7, dtype=torch.float32, device=cam.device)
    for i0 in range(0, p.rows, band_rows):
        i1 = min(i0 + band_rows, p.rows)
        i = torch.arange(i0, i1, device=cam.device)[:, None, None]
        j = torch.arange(p.width, device=cam.device)[None, :, None]
        active = tile_active(spec, cull, cull.tile_index(i, j))

        def scene_fn_of(sc, active=active):
            return lambda px, py, pz: scene_compact_plain(sc, plan, active, px, py, pz)

        def albedo_fn_of(sc, active=active):
            return lambda px, py, pz: pool_albedo_plain(sc, plan, active, p.albedo, px, py, pz)

        a, b, c = _bwd_plain_band(scene, cam, p, clamp, t[i0:i1], hit[i0:i1], g_img[i0:i1], i0,
                                  scene_fn_of, albedo_fn_of if spec.has_materials else None,
                                  _band(soft, i0, i1))
        d_lp += a
        d_opp += b
        d_cam7 += c
    return d_lp, d_opp, torch.cat([d_cam7, torch.zeros(1, dtype=torch.float32, device=cam.device)])


# --------------------------------------------------------------------------
# Wrappers: plain on the CPU, the CUDA kernel on a CUDA device


class _CSoftRes(ctypes.Structure):
    """ctypes mirror of `SoftRes` in csrc/scene_grad.cuh: the soft
    residuals (null pointers: a hard backward) and constants."""

    _fields_ = [
        ("s_min", ctypes.c_void_p),
        ("t_min", ctypes.c_void_p),
        ("beta_inv", ctypes.c_float),
        ("gate", ctypes.c_float),
    ]

    @staticmethod
    def of(p: PrepassParams, soft) -> "_CSoftRes":
        v = _CSoftRes()
        if soft is not None:
            v.s_min = soft[0].data_ptr()
            v.t_min = soft[1].data_ptr()
            v.beta_inv = p.beta_inv
            v.gate = p.soft_gate
        return v


def _check_soft(p: PrepassParams, soft, dev):
    """`soft` = (s_min, t_min) residuals of a soft forward, or None."""
    if soft is None:
        return
    S = p.naa * p.naa
    if len(soft) != 2:
        raise ValueError("soft takes the residuals (s_min, t_min)")
    for name, v in zip(("s_min", "t_min"), soft):
        _check(name, v, torch.float32, (p.rows, p.width, S), dev)


def _check_bwd(scene: SceneBuffers, cam, p: PrepassParams, lay: GradLayout, t, hit, g_img, soft=None):
    dev = cam.device
    S = p.naa * p.naa
    _check("cam", cam, torch.float32, (8,), dev)
    _check("tape", scene.tape, torch.int32, (3, max(scene.n_instr, 1)), dev)
    _check("row_kind", scene.row_kind, torch.int32, (lay.n_leaves,), dev)
    _check("leaf_params", scene.leaf_params, torch.float32, (lay.n_leaves, 16), dev)
    _check("op_param", scene.op_param, torch.float32, (lay.n_instr,), dev)
    _check("t", t, torch.float32, (p.rows, p.width, S), dev)
    _check("hit", hit, torch.float32, (p.rows, p.width, S), dev)
    _check("g_img", g_img, torch.float32, (p.rows, p.width, 3), dev)
    _check_soft(p, soft, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _device_consts(lay: GradLayout, mats: bool, device: torch.device):
    """(packed tape i32[n_real, 4] on device, max grid size, the launcher's
    shape words, words of device-memory records per thread: 0 when they sit
    in shared memory)."""
    ins = torch.as_tensor(lay.packed or ((0, 0, 0, 0),), dtype=torch.int32, device=device)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    max_blocks = n_sm * (2048 // lay.threads)
    rec_words = 0 if lay.rec_in_smem(mats) else lay.rec_words(mats)
    if rec_words:
        max_blocks = max(1, min(max_blocks, REC_BUDGET // (4 * rec_words * lay.threads)))
    shape = (ctypes.c_int * 7)(lay.nscal, lay.op_base, lay.cam_base, lay.n_smooth, int(not lay.long),
                               int(lay.row_in_smem), int(not rec_words))
    return ins, max_blocks, shape, rec_words


def bwd(scene: SceneBuffers, cam, p: PrepassParams, lay: GradLayout, t, hit, g_img, soft=None):
    """Fused backward -> (d_lp f32[n_leaves, 16], d_opp f32[n_instr], d_cam
    f32[8]) on the inputs' device; see `bwd_plain` for the arguments. On
    CUDA: `fused_bwd_kernel` (csrc/fused_bwd.cu) in the build and with the
    routes `lay` gives (per-thread or warp rows; records and the warp-row
    build's row in shared or device memory), with the albedo words on a
    painted scene and in its soft build when `soft` = (s_min, t_min) is
    given, then, when its rows sit in shared memory, `bwd_finalize_kernel`
    over its block rows."""
    dev = _check_bwd(scene, cam, p, lay, t, hit, g_img, soft)
    if dev.type == "cpu":
        return bwd_plain(scene, cam, p, lay, t, hit, g_img, soft=soft)
    from .. import _build

    lib = _build.load()
    mats = scene.spec.has_materials
    ins, max_blocks, shape, rec_words = _device_consts(lay, mats, dev)
    out = torch.empty(lay.nscal, dtype=torch.float32, device=dev)
    partials = torch.empty(max_blocks * lay.nscal if lay.row_in_smem else 1, dtype=torch.float32, device=dev)
    rec = torch.empty(max_blocks * lay.threads * rec_words, dtype=torch.int32, device=dev) if rec_words else None
    cp = _CParams.of(p)
    cs = _CSoftRes.of(p, soft)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_fused_bwd_launch(
            scene.leaf_params.data_ptr(), ins.data_ptr(), lay.n_real, scene.op_param.data_ptr(), shape,
            cam.data_ptr(), ctypes.addressof(cp), lay.grad_denom_clamp,
            t.data_ptr(), hit.data_ptr(), g_img.data_ptr(), int(mats), ctypes.addressof(cs),
            None if rec is None else rec.data_ptr(),
            partials.data_ptr(), max_blocks, out.data_ptr(), stream,
        )
    _raise_on(err, "fused_bwd_kernel")
    if soft is None:
        bwd.launches += 1
    else:
        bwd.soft_launches += 1
    return lay.unpack(out)


bwd.launches = 0
bwd.soft_launches = 0


def _check_compact_bwd(scene: SceneBuffers, cull: TileCull, cam, p: PrepassParams, t, hit, g_img, soft=None):
    """The compact backward's argument checks. Which scenes take it is
    `backward_route`'s decision, made once per renderer; this checks only
    the tensors."""
    dev = cam.device
    S = p.naa * p.naa
    spec = scene.spec
    _check("cam", cam, torch.float32, (8,), dev)
    _check("tape", scene.tape, torch.int32, (3, max(scene.n_instr, 1)), dev)
    _check("row_kind", scene.row_kind, torch.int32, (spec.n_leaves,), dev)
    _check("leaf_params", scene.leaf_params, torch.float32, (spec.n_leaves, 16), dev)
    _check("op_param", scene.op_param, torch.float32, (spec.n_instr,), dev)
    _check("t", t, torch.float32, (p.rows, p.width, S), dev)
    _check("hit", hit, torch.float32, (p.rows, p.width, S), dev)
    _check("g_img", g_img, torch.float32, (p.rows, p.width, 3), dev)
    _check_soft(p, soft, dev)
    if soft is not None and spec.has_materials:
        raise ValueError("a painted scene takes the legacy backward in soft mode")
    if cull is None or not cull.compact:
        raise ValueError("the compact backward needs the fine grid's item lists")
    _check_cull(cull, spec, (p.rows, p.width), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev, 16 * spec.n_leaves + spec.n_instr + 7


# Shared memory a compact backward block may give one tile's staged counts
# and active list entries; a plan with longer lists reads them in place.
STAGE_SMEM = 48 << 10


@dataclasses.dataclass(frozen=True)
class CompactRoutes:
    """Where the compact backward of a plan keeps its gradient row, its fold
    history and each tile's lists: the row (nscal words) in shared memory up
    to ROW_SMEM bytes, else added into the output in device memory; the
    history (`history_layout`: hist_len floats per thread) in shared memory
    up to REC_SMEM bytes a block, else in device memory within REC_BUDGET;
    each tile's counts and active lists staged in shared memory up to
    STAGE_SMEM bytes, else read in place."""

    nscal: int
    hist_off: int
    hist_len: int
    row_smem: bool
    hist_smem: bool
    stage: bool

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def of(spec: TapeSpec) -> "CompactRoutes":
        plan = build_compact_plan(spec)
        nscal = 16 * spec.n_leaves + spec.n_instr + 7
        hist_off, hist_len = history_layout(spec)
        staged = 4 * len(plan["groups"]) + plan["n_counts"] + plan["n_items"]
        return CompactRoutes(nscal, hist_off, hist_len, nscal * 4 <= ROW_SMEM,
                             hist_len * 4 * CBWD_THREADS <= REC_SMEM, staged * 4 <= STAGE_SMEM)


@functools.lru_cache(maxsize=None)
def compact_layout(spec: TapeSpec, device: torch.device):
    """(routes, max grid size, the launcher's shape words, floats of
    device-memory history per thread: 0 when it sits in shared memory) of
    the compact backward of `spec`'s plan on `device`."""
    ro = CompactRoutes.of(spec)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    max_blocks = n_sm * (2048 // CBWD_THREADS)
    hist_words = 0 if ro.hist_smem else ro.hist_len
    if hist_words:
        max_blocks = max(1, min(max_blocks, REC_BUDGET // (4 * hist_words * CBWD_THREADS)))
    op_base = 16 * spec.n_leaves
    shape = (ctypes.c_int * 8)(ro.nscal, op_base, op_base + spec.n_instr, ro.hist_off, ro.hist_len,
                               int(ro.row_smem), int(ro.hist_smem), int(ro.stage))
    return ro, max_blocks, shape, hist_words


@functools.lru_cache(maxsize=None)
def history_layout(spec: TapeSpec):
    """(hist_off, hist_len) of the compact backward's fold history: the
    list column of the plan's first ordered item, and the plan's total
    ordered span, every seg1 and stream group's items (0 for a pool-only
    plan). The ordered groups sit after the pool in one run of list
    columns, each at its own base. The reference sizes its history to the
    largest single group instead, though it lays the groups out one after
    another (ROADMAP §3.1)."""
    plan = build_compact_plan(spec)
    groups = plan["groups"]
    gis = list(plan["seg1"] or ()) + list(plan["stream"])
    if not gis:
        return 0, 0
    off = min(groups[g]["offset"] for g in gis)
    span = sum(len(groups[g]["rows"]) for g in gis)
    if max(groups[g]["offset"] + len(groups[g]["rows"]) for g in gis) != off + span:
        raise ValueError("the plan's ordered groups do not share one run of list columns")
    return off, span


def compact_bwd(scene: SceneBuffers, cull: TileCull, cam, p: PrepassParams, clamp: float, t, hit, g_img,
                soft=None):
    """Compact backward -> (d_lp f32[n_leaves, 16], d_opp f32[n_instr], d_cam
    f32[8]) on the inputs' device; see `compact_bwd_plain` for the
    arguments. On CUDA: `compact_bwd_kernel` (csrc/compact_bwd.cu), in its
    soft build when `soft` = (s_min, t_min) is given, then, when its row sits
    in shared memory (`compact_layout`), `bwd_finalize_kernel` over its block
    rows."""
    dev, nscal = _check_compact_bwd(scene, cull, cam, p, t, hit, g_img, soft)
    if dev.type == "cpu":
        return compact_bwd_plain(scene, cull, cam, p, clamp, t, hit, g_img, soft=soft)
    from .. import _build

    lib = _build.load()
    L = scene.spec.n_leaves
    cam_base = 16 * L + scene.spec.n_instr
    ro, max_blocks, shape, hist_words = compact_layout(scene.spec, dev)
    row_smem = ro.row_smem
    hist = torch.empty(max_blocks * CBWD_THREADS * hist_words, dtype=torch.float32, device=dev) if hist_words else None
    partials = torch.empty(max_blocks * nscal if row_smem else 1, dtype=torch.float32, device=dev)
    out = torch.empty(nscal, dtype=torch.float32, device=dev)
    tile_next = torch.empty(1, dtype=torch.int32, device=dev)
    n_blocks = ctypes.c_int(0)
    cp = _CParams.of(p)
    cc = _CCull.of(cull)
    cs = _CSoftRes.of(p, soft)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_compact_bwd_launch(
            *_scene_ptrs(scene), ctypes.addressof(cc), cam.data_ptr(),
            ctypes.addressof(cp), clamp, t.data_ptr(), hit.data_ptr(), g_img.data_ptr(), shape,
            int(scene.spec.has_materials), ctypes.addressof(cs), None if hist is None else hist.data_ptr(),
            tile_next.data_ptr(), partials.data_ptr(), max_blocks, ctypes.byref(n_blocks), out.data_ptr(),
            stream,
        )
        _raise_on(err, "compact_bwd_kernel")
        if soft is None:
            compact_bwd.launches += 1
        else:
            compact_bwd.soft_launches += 1
        if row_smem:
            err = lib.rmt_bwd_finalize_launch(partials.data_ptr(), n_blocks.value, nscal, out.data_ptr(), stream)
    _raise_on(err, "bwd_finalize_kernel")
    d_lp = out[: 16 * L].view(L, 16)
    d_opp = out[16 * L : cam_base]
    d_cam = torch.cat([out[cam_base:], torch.zeros(1, dtype=torch.float32, device=dev)])
    return d_lp, d_opp, d_cam


compact_bwd.launches = 0
compact_bwd.soft_launches = 0
for _fn in (bwd, compact_bwd):
    profiling.count_launches("cuda_grad", _fn, ("launches", "soft_launches"))


def reset_launch_counts():
    bwd.launches = 0
    bwd.soft_launches = 0
    compact_bwd.launches = 0
    compact_bwd.soft_launches = 0


# --------------------------------------------------------------------------
# The differentiable renderer


class _FusedRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp, opp, cam, fr):
        rp = fr.prepass
        scene, cam_d, bound = rp.scene_args(types.SimpleNamespace(leaf_params=lp, op_param=opp), cam)
        coarse_cull, fine_cull = rp.cull_args(scene, cam_d)
        # Soft mode runs no coarse pass (pallas_grad.py:1863-1868).
        pre = rp.prepass(scene, cam_d, bound, coarse_cull)
        # K2 with residuals, or K4's where the layout is unpacked.
        img, *res = rp.fine_pass(residuals=True)(scene, cam_d, bound, rp.params, *pre, cull=fine_cull)
        ctx.fr = fr
        # The backward reads, for each ray, the fine list its forward used.
        ctx.fine_cull = fine_cull
        ctx.save_for_backward(scene.leaf_params, scene.op_param, cam_d, *res)
        return img

    @staticmethod
    def backward(ctx, g_img):
        lp, opp, cam, t, hit, *soft = ctx.saved_tensors
        soft = tuple(soft) or None  # (s_min, t_min) in soft mode
        fr = ctx.fr
        rp = fr.prepass
        scene = SceneBuffers(fr.spec, rp.topology[0], rp.topology[1], lp, opp)
        if fr.compact_bwd:
            d_lp, d_opp, d_cam = compact_bwd(
                scene, ctx.fine_cull, cam, rp.params, fr.layout.grad_denom_clamp, t, hit,
                g_img.contiguous(), soft=soft,
            )
        else:
            # The legacy backward runs ungated after a culled forward, as in
            # the reference (pallas_grad.py:1423-1429).
            d_lp, d_opp, d_cam = bwd(
                scene, cam, rp.params, fr.layout, t, hit, g_img.contiguous(), soft=soft
            )
        return d_lp, d_opp, d_cam, None


def _param_tensor(name, x, device):
    if torch.is_tensor(x):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        return x
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def plan_kind(spec: TapeSpec):
    """The kind of `spec`'s compact plan: None (no plan), "residual" (it
    has residual subtrees), else its ordered source "seg1" or "stream", or
    "pool" when the free pool is its only source."""
    plan = build_compact_plan(spec)
    if plan is None:
        return None
    if plan["residual_ops"]:
        return "residual"
    if plan["seg1"] is not None:
        return "seg1"
    return "stream" if plan["stream"] else "pool"


def backward_route(spec: TapeSpec, cfg: RenderConfig, soft: bool = False, packed: bool = True):
    """(plan kind, reason): why the compact O(active) backward is not taken,
    or reason None when it is, by the eligibility chain of
    pallas_grad.py:1279-1298 with the reference's reason strings. This is
    the one place that decides; every compact plan without residual
    subtrees takes K9 (pool, seg1 and stream plans, painted pools), but in
    soft mode a painted scene takes K8 ("painted materials in soft mode",
    first in the reference's chain), and so does a forward without the
    AA-packed layout (`packed` False: aa_packed=False, or an AA grid whose
    aa_samples^2 does not divide 128), whose residuals K4 writes ("AA-packed
    layout unavailable", last in the chain).

    The 64-item history cap of the TPU's VMEM (1278, 1292) is not carried:
    the port sizes the history to the plan's total ordered span
    (`history_layout`, ROADMAP §3.1), so a seg1 chain or stream group of
    more than 64 items takes K9 here where the reference takes its legacy
    backward with the reason "ordered fold history exceeds the VMEM budget
    (64)"."""
    if soft and spec.has_materials:
        return (plan_kind(spec) if cfg.leaf_cull else None), "painted materials in soft mode"
    if not cfg.leaf_cull:
        return None, "leaf_cull disabled"
    kind = plan_kind(spec)
    if kind is None:
        return kind, "scene has no compact plan (not foldable)"
    if kind == "residual":
        return kind, "plan has residual (unrolled) subtrees"
    if spec.has_materials and kind != "pool":
        return kind, "painted materials on smooth/ordered segments"
    if not packed:
        return kind, "AA-packed layout unavailable"
    return kind, None


class FusedRenderer:
    """`render(arrays, cam_vec f32[8]) -> image f32[rows, W, 3]` on one
    device, the band of `band_rows` rows (all H without it) that starts at
    image row cam_vec[7], differentiable with respect to
    `arrays.leaf_params`, `arrays.op_param` and `cam_vec` (tensors; numpy
    parameters are uploaded and are not differentiated). `cam_vec[7]` is the band's first row and gets a zero
    gradient.

    With `cfg.leaf_cull` the forward is culled (the coarse and fine kernels
    read per-tile item lists or masks); a compact plan without residual
    subtrees then takes the compact backward K9 (`compact_bwd`), any other
    scene the legacy K8 (`backward_route`), painted or not. `prepass_block`
    = B runs the coarse pass per B x B block and the fine pass on its block
    planes, as the reference's fused forward does (pallas_grad.py:1340-1346).
    `soft` renders soft coverage: no prepass (`prepass_block` then has no
    effect), the soft fine build, the soft backwards.
    """

    def __init__(self, spec: TapeSpec, cfg: RenderConfig, width: int, height: int, device, reason,
                 prepass_block: int = 1, soft: bool = False, packed: bool = True, band_rows=None):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.prepass = make_pallas_image_render_aa(spec, cfg, width, height, device=device,
                                                   prepass_block=prepass_block, band_rows=band_rows,
                                                   no_prepass=soft, aa_packed=packed, soft=soft)
        self.params = self.prepass.params
        self.layout = GradLayout.of(spec, cfg)
        # `reason` is backward_route's: None takes the compact backward.
        self.compact_bwd = reason is None
        # The keys and strings of the reference (pallas_grad.py:1887-1895).
        # The port has no row-block size.
        self.backward_info = {
            "kind": "pallas_compact" if self.compact_bwd else "pallas_legacy_unrolled",
            "compact": self.compact_bwd,
            "reason": reason,
            "aa_packed": not self.prepass.params.unpacked,
            "bm": None,
            "soft": soft,
        }

    def __call__(self, arrays: TapeArrays, cam_vec):
        lp = _param_tensor("leaf_params", arrays.leaf_params, self.device)
        opp = _param_tensor("op_param", arrays.op_param, self.device)
        cam = _param_tensor("cam_vec", cam_vec, self.device)
        return _FusedRender.apply(lp, opp, cam, self)


def make_fused_render_vjp(
    spec: TapeSpec,
    cfg: RenderConfig,
    width: int,
    height: int,
    interpret: bool = False,
    bm=None,
    prepass_block: int = 1,
    band_rows=None,
    aa_packed=None,
    soft: bool = False,
    *,
    device="cuda",
) -> FusedRenderer:
    """The port's counterpart of `raymarch_tpu.ops.pallas_grad.
    make_fused_render_vjp`, with the reference's arguments in its order,
    cached per (spec, cfg, width, height, prepass_block, band_rows, soft,
    device); `device` defaults to the card ("cuda"), "cpu" runs the plain
    versions.

    Serves every static tape: without `cfg.leaf_cull`
    the legacy backward (K8); with it the culled forward, then the compact
    backward (K9) for every compact plan without residual subtrees (pool,
    seg1 chain, streams; painted pools) and K8 for any other scene, as the
    reference dispatches (`backward_route`, `backward_info`). K8 takes
    painted scenes (the albedo words) and tapes of any length.
    `prepass_block` = B >= 1 runs the block prepass (values below 1 read as
    1, as the reference's).

    `aa_packed` picks the forward's layout as the reference's route does
    (pallas_grad.py:1296-1310): False, or an AA grid whose aa_samples^2 does
    not divide 128 (aa = 3), takes the unpacked fine pass K4 with residuals,
    then K8 ("AA-packed layout unavailable"); the compact backward and soft
    mode force the packed layout. None packs wherever it can and takes K4
    with `cfg.aa_shared_normals` (whose forward then shades with the
    shared normals, and K8 with each ray's own, as the reference's does).
    Like the reference it raises ValueError for aa_packed=True with an AA
    grid that does not pack, and for a packed VJP with aa_shared_normals.

    `soft=True` renders soft coverage (silhouette gradients): the packed
    no-prepass forward that keeps (s_min, t_min), then the soft backward;
    like the reference it needs aa_samples^2 dividing 128 (ValueError),
    takes the packed layout whatever `aa_packed` says, and runs no coarse
    pass. A painted scene takes K8 in soft mode.

    `interpret` and `bm` set the TPU kernels' layout in the reference (the
    Pallas interpreter; the backward's row-block size) and have no effect
    here. `band_rows` renders and differentiates the band of that many rows
    that starts at image row cam_vec[7] (pallas_grad.py:1229, 1321): K1 and
    K2 write the band's planes and residuals f32[band_rows, W, S], the
    culling lists cover the band's tiles, and K8 or K9 run over its rows;
    the row-sharded fit runs one per band. A dynamic tape raises
    NotImplementedError (the reference's raises too, pallas_grad.py:
    1239-1242).
    """
    del interpret, bm  # TPU layout only
    if spec.static_tape is None:
        # The reference's own refusal (pallas_grad.py:1239-1242).
        raise NotImplementedError("fused-VJP rendering requires compile_scene(static=True), as in the reference "
                                  "(ROADMAP §2 item 3: the fused VJP takes static tapes only)")
    S = cfg.aa_samples ** 2
    if soft:
        if S and 128 % S:
            raise ValueError("soft VJP needs aa_samples^2 dividing 128")
        aa_packed = True  # pallas_grad.py:1243-1249
    if aa_packed and 128 % S:
        raise ValueError("aa_packed VJP needs aa_samples^2 dividing 128")
    _, reason = backward_route(spec, cfg, soft, packed=aa_packed is not False and 128 % S == 0)
    # The compact backward forces the packed layout (1299-1301).
    packed = reason is None or bool(aa_packed) or (
        aa_packed is None and 128 % S == 0 and not cfg.aa_shared_normals)
    if packed and cfg.aa_shared_normals:
        raise ValueError("aa_packed excludes aa_shared_normals")
    return _cached_fused(spec, cfg, int(width), int(height), resolve_device(device), reason,
                         1 if soft else max(1, int(prepass_block)), bool(soft), packed,
                         None if band_rows is None else int(band_rows))


@functools.lru_cache(maxsize=None)
def _cached_fused(spec, cfg, width, height, device, reason, prepass_block, soft=False, packed=True, band_rows=None):
    return FusedRenderer(spec, cfg, width, height, device, reason, prepass_block, soft, packed, band_rows)
