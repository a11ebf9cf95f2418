"""Fused forward+backward renderer: the cone-prepass forward that keeps its
residuals, and a CUDA backward kernel.

Port of `raymarch_tpu/ops/pallas_grad.py:make_fused_render_vjp` (1221):
the legacy backward (`backward_info["kind"] == "pallas_legacy_unrolled"`),
and with `cfg.leaf_cull` the compact backward of pool-only plans
(`"pallas_compact"`).

- Forward: the coarse kernel, then the fine kernel with residuals
  (`cuda_prepass.fine_res`, the counterpart of the Pallas fine kernel with
  `emit_th=True`): the image, and each AA ray's march end t and hit flag;
  culled per tile with `cfg.leaf_cull`.
- Compact backward (`compact_bwd`; kernel `compact_bwd_kernel` in
  csrc/compact_bwd.cu, replacing `_make_compact_bwd.bwd_kernel`,
  pallas_grad.py:256): for a pool-only compact plan, the same gradient with
  every scene evaluation folded over the ray's fine-tile list and each
  point's cotangent pushed through the winning leaf's adjoint alone.
  `compact_bwd_plain` is its autograd replay.
- Backward (`bwd`; kernel `fused_bwd_kernel` in csrc/fused_bwd.cu,
  replacing `bwd_kernel`, pallas_grad.py:1432): per hit ray, the adjoint of
  the shading chain plus the implicit-function term, summed over rays into
  one flat vector of `16 * n_rows + n_real + 7` words (pallas_grad.py:
  1653-1699, unpacked as `_run_bwd` does at 1830-1840).

`bwd_plain` is the same gradient by torch autograd through a replay of
`shade_loss` and `implicit_loss` (1600-1699) from the residuals, in row
bands so that no graph spans the whole frame. On CPU tensors `bwd` runs
it; on a CUDA device `bwd` launches the kernel, or raises.

Both the residuals (8 bytes per AA ray: 265 MB at 1920x1080 with 16 AA
rays per pixel) and the saved parameters live until the backward runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import types

import torch

from ..config import RenderConfig
from . import opcodes as oc
from .cuda_march import SceneBuffers, build_compact_plan, pool_fold_plain, scene_plain
from .cuda_prepass import (
    PrepassParams,
    TileCull,
    _CCull,
    _CParams,
    _check,
    _check_cull,
    _not_ported,
    _origin,
    _raise_on,
    _scene_ptrs,
    _view_dirs,
    aa_screen,
    coarse,
    fine_res,
    make_pallas_image_render_aa,
    resolve_device,
    shade_plain,
)
from .tape import TapeArrays, TapeSpec

MAX_BWD_INSTR = 64  # csrc/scene_grad.cuh MAX_BWD_INSTR
BWD_THREADS = 64  # csrc/fused_bwd.cu BWD_THREADS
CBWD_THREADS = 128  # csrc/compact_bwd.cu CBWD_THREADS
SMEM_PER_BLOCK = 232448  # an H100 block's shared memory, bytes
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

    @staticmethod
    def of(spec: TapeSpec, cfg: RenderConfig) -> "GradLayout":
        tape = spec.static_tape
        rows = tuple(sorted({a for c, a, _ in tape if c == oc.COP_PUSH}))
        base = {r: 16 * k for k, r in enumerate(rows)}
        return GradLayout(
            n_leaves=spec.n_leaves,
            n_instr=spec.n_instr,
            pushed_rows=rows,
            n_real=len(tape),
            push_slot=tuple(base[a] if c == oc.COP_PUSH else 0 for c, a, _ in tape),
            grad_denom_clamp=float(cfg.grad_denom_clamp),
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
                    scene_fn_of=None):
    """Gradient of one band of rows [i0, i0 + len(t)) -> (d_lp, d_opp,
    d_cam7), the replay of pallas_grad.py:1600-1699 by autograd.
    `scene_fn_of(sc)` gives the scene function of the scene buffers `sc`
    (default: the whole tape, `scene_plain`)."""
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

        def rays(c):
            dx, dy, dz = _view_dirs(x, y, c, p)
            return _origin(c, dx) + (dx, dy, dz)

        # Explicit shading path: dL/d(theta, cam, t) (shade_loss).
        tt = t.detach().clone().requires_grad_(True)
        cols = shade_plain(sc, p, *rays(cam_g), tt, hit, scene_fn_of(sc))
        loss = sum(torch.sum(col * gc) for col, gc in zip(cols, g))
        g1 = torch.autograd.grad(loss, (lp, opp, cam7, tt), allow_unused=True)
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
        g2 = torch.autograd.grad(torch.sum(w * f), (lp, opp, cam7), allow_unused=True)

    out = []
    for a, b, like in zip(g1[:3], g2, (lp, opp, cam7)):
        s = torch.zeros_like(like)
        for v in (a, b):
            if v is not None:
                s = s + v
        out.append(s.detach())
    return out


def bwd_plain(scene: SceneBuffers, cam, p: PrepassParams, lay: GradLayout, t, hit, g_img, band_rows: int = PLAIN_BAND_ROWS):
    """Plain version of the fused backward -> (d_lp f32[n_leaves, 16], d_opp
    f32[n_instr], d_cam f32[8]) on the inputs' device, from the residuals
    (t, hit f32[rows, W, S]) and the image cotangent g_img f32[rows, W, 3].
    The gradient is a sum over rays, so it runs `band_rows` rows at a time
    and adds the bands' gradients."""
    d_lp = torch.zeros_like(scene.leaf_params)
    d_opp = torch.zeros_like(scene.op_param)
    d_cam7 = torch.zeros(7, dtype=torch.float32, device=cam.device)
    for i0 in range(0, p.rows, band_rows):
        i1 = min(i0 + band_rows, p.rows)
        a, b, c = _bwd_plain_band(scene, cam, p, lay.grad_denom_clamp, t[i0:i1], hit[i0:i1], g_img[i0:i1], i0)
        d_lp += a
        d_opp += b
        d_cam7 += c
    # Words the kernel never writes are zero in its layout as well.
    keep = torch.zeros(lay.n_instr, dtype=torch.bool, device=cam.device)
    keep[: lay.n_real] = True
    d_opp = torch.where(keep, d_opp, 0.0)
    return d_lp, d_opp, torch.cat([d_cam7, torch.zeros(1, dtype=torch.float32, device=cam.device)])


def compact_bwd_plain(scene: SceneBuffers, cull: TileCull, cam, p: PrepassParams, clamp: float,
                      t, hit, g_img, band_rows: int = PLAIN_BAND_ROWS):
    """Plain version of the compact backward of a pool-only plan -> (d_lp
    f32[n_leaves, 16], d_opp f32[n_instr], d_cam f32[8]): `bwd_plain`'s
    autograd replay in row bands, with every scene evaluation the pool fold
    of the ray's fine tile (`pool_fold_plain`), so each point's cotangent
    reaches its winner leaf only. `cull` is the fine grid's TileCull of the
    forward that wrote the residuals (t, hit)."""
    from .culling import _active_from_mask

    plan = build_compact_plan(scene.spec)
    act_cols = _active_from_mask(scene.spec, cull.masks).T.contiguous()  # [L, T]
    d_lp = torch.zeros_like(scene.leaf_params)
    d_opp = torch.zeros_like(scene.op_param)
    d_cam7 = torch.zeros(7, dtype=torch.float32, device=cam.device)
    for i0 in range(0, p.rows, band_rows):
        i1 = min(i0 + band_rows, p.rows)
        i = torch.arange(i0, i1, device=cam.device)[:, None, None]
        j = torch.arange(p.width, device=cam.device)[None, :, None]
        tid = cull.tile_index(i, j)
        memo = {}

        def active(row, tid=tid, memo=memo):
            if row not in memo:
                memo[row] = act_cols[row][tid]
            return memo[row]

        def scene_fn_of(sc, active=active):
            return lambda px, py, pz: pool_fold_plain(sc, plan, active, px, py, pz)

        a, b, c = _bwd_plain_band(scene, cam, p, clamp, t[i0:i1], hit[i0:i1], g_img[i0:i1], i0,
                                  scene_fn_of)
        d_lp += a
        d_opp += b
        d_cam7 += c
    return d_lp, d_opp, torch.cat([d_cam7, torch.zeros(1, dtype=torch.float32, device=cam.device)])


# --------------------------------------------------------------------------
# Wrappers: plain on the CPU, the CUDA kernel on a CUDA device


def _check_bwd(scene: SceneBuffers, cam, p: PrepassParams, lay: GradLayout, t, hit, g_img):
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if lay.n_real > MAX_BWD_INSTR:
            raise NotImplementedError(
                f"the backward kernel takes tapes of at most {MAX_BWD_INSTR} "
                f"instructions; this one has {lay.n_real} (ROADMAP §1.10 "
                "many-primitive backward)"
            )
        smem = lay.nscal * (BWD_THREADS + 1) * 4
        if smem > SMEM_PER_BLOCK:
            raise NotImplementedError(
                f"{lay.nscal} gradient words need {smem} bytes of shared memory "
                f"per block, more than {SMEM_PER_BLOCK} (ROADMAP §1.10 "
                "many-primitive backward)"
            )
    return dev


@functools.lru_cache(maxsize=None)
def _device_consts(lay: GradLayout, device: torch.device):
    """(push_slot i32[n_real] on device, max grid size) for the launcher."""
    slots = torch.as_tensor(lay.push_slot or (0,), dtype=torch.int32, device=device)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return slots, n_sm * (2048 // BWD_THREADS)


def bwd(scene: SceneBuffers, cam, p: PrepassParams, lay: GradLayout, t, hit, g_img):
    """Fused backward -> (d_lp f32[n_leaves, 16], d_opp f32[n_instr], d_cam
    f32[8]) on the inputs' device; see `bwd_plain` for the arguments."""
    dev = _check_bwd(scene, cam, p, lay, t, hit, g_img)
    if dev.type == "cpu":
        return bwd_plain(scene, cam, p, lay, t, hit, g_img)
    from .. import _build

    lib = _build.load()
    slots, max_blocks = _device_consts(lay, dev)
    out = torch.empty(lay.nscal, dtype=torch.float32, device=dev)
    partials = torch.empty(max_blocks * lay.nscal, dtype=torch.float32, device=dev)
    cp = _CParams.of(p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_fused_bwd_launch(
            *_scene_ptrs(scene), slots.data_ptr(), cam.data_ptr(),
            ctypes.addressof(cp), lay.grad_denom_clamp,
            t.data_ptr(), hit.data_ptr(), g_img.data_ptr(),
            lay.nscal, lay.op_base, lay.cam_base,
            partials.data_ptr(), max_blocks, out.data_ptr(), stream,
        )
    _raise_on(err, "fused_bwd_kernel")
    bwd.launches += 1
    return lay.unpack(out)


bwd.launches = 0


def _check_compact_bwd(scene: SceneBuffers, cull: TileCull, cam, p: PrepassParams, t, hit, g_img):
    dev = cam.device
    S = p.naa * p.naa
    spec = scene.spec
    if plan_kind(spec) != "pool":
        raise ValueError("the compact backward takes pool-only plans (see backward_route)")
    _check("cam", cam, torch.float32, (8,), dev)
    _check("tape", scene.tape, torch.int32, (3, max(scene.n_instr, 1)), dev)
    _check("row_kind", scene.row_kind, torch.int32, (spec.n_leaves,), dev)
    _check("leaf_params", scene.leaf_params, torch.float32, (spec.n_leaves, 16), dev)
    _check("op_param", scene.op_param, torch.float32, (spec.n_instr,), dev)
    _check("t", t, torch.float32, (p.rows, p.width, S), dev)
    _check("hit", hit, torch.float32, (p.rows, p.width, S), dev)
    _check("g_img", g_img, torch.float32, (p.rows, p.width, 3), dev)
    if cull is None or not cull.compact:
        raise ValueError("the compact backward needs the fine grid's item lists")
    _check_cull(cull, spec, p, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    nscal = 16 * spec.n_leaves + spec.n_instr + 7
    if dev.type == "cuda" and nscal * 4 > SMEM_PER_BLOCK:
        raise NotImplementedError(
            f"{nscal} gradient words need {nscal * 4} bytes of shared memory per "
            f"block, more than {SMEM_PER_BLOCK} (ROADMAP §1.10 many-primitive backward)"
        )
    return dev, nscal


@functools.lru_cache(maxsize=None)
def _max_compact_blocks(device: torch.device) -> int:
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return n_sm * (2048 // CBWD_THREADS)


def compact_bwd(scene: SceneBuffers, cull: TileCull, cam, p: PrepassParams, clamp: float, t, hit, g_img):
    """Compact backward of a pool-only plan -> (d_lp f32[n_leaves, 16],
    d_opp f32[n_instr], d_cam f32[8]) on the inputs' device; see
    `compact_bwd_plain` for the arguments. On CUDA: `compact_bwd_kernel`
    (csrc/compact_bwd.cu), then `bwd_finalize_kernel` over its block rows."""
    dev, nscal = _check_compact_bwd(scene, cull, cam, p, t, hit, g_img)
    if dev.type == "cpu":
        return compact_bwd_plain(scene, cull, cam, p, clamp, t, hit, g_img)
    from .. import _build

    lib = _build.load()
    L, n_instr = scene.spec.n_leaves, scene.spec.n_instr
    cam_base = 16 * L + n_instr
    max_blocks = _max_compact_blocks(dev)
    partials = torch.empty(max_blocks * nscal, dtype=torch.float32, device=dev)
    out = torch.empty(nscal, dtype=torch.float32, device=dev)
    n_blocks = ctypes.c_int(0)
    cp = _CParams.of(p)
    cc = _CCull.of(cull)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rmt_compact_bwd_launch(
            *_scene_ptrs(scene), ctypes.addressof(cc), cam.data_ptr(),
            ctypes.addressof(cp), clamp, t.data_ptr(), hit.data_ptr(), g_img.data_ptr(),
            nscal, cam_base, partials.data_ptr(), max_blocks, ctypes.byref(n_blocks), stream,
        )
        _raise_on(err, "compact_bwd_kernel")
        compact_bwd.launches += 1
        err = lib.rmt_bwd_finalize_launch(partials.data_ptr(), n_blocks.value, nscal, out.data_ptr(), stream)
    _raise_on(err, "bwd_finalize_kernel")
    d_lp = out[: 16 * L].view(L, 16)
    d_opp = out[16 * L : cam_base]
    d_cam = torch.cat([out[cam_base:], torch.zeros(1, dtype=torch.float32, device=dev)])
    return d_lp, d_opp, d_cam


compact_bwd.launches = 0


def reset_launch_counts():
    bwd.launches = 0
    compact_bwd.launches = 0


# --------------------------------------------------------------------------
# The differentiable renderer


class _FusedRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp, opp, cam, fr):
        rp = fr.prepass
        scene, cam_d, bound = rp.scene_args(types.SimpleNamespace(leaf_params=lp, op_param=opp), cam)
        coarse_cull, fine_cull = rp.cull_args(scene, cam_d)
        pre = coarse(scene, cam_d, bound, rp.params, coarse_cull)
        img, t, hit = fine_res(scene, cam_d, bound, rp.params, *pre, cull=fine_cull)
        ctx.fr = fr
        # The backward reads, for each ray, the fine list its forward used.
        ctx.fine_cull = fine_cull
        ctx.save_for_backward(scene.leaf_params, scene.op_param, cam_d, t, hit)
        return img

    @staticmethod
    def backward(ctx, g_img):
        lp, opp, cam, t, hit = ctx.saved_tensors
        fr = ctx.fr
        rp = fr.prepass
        scene = SceneBuffers(fr.spec, rp.topology[0], rp.topology[1], lp, opp)
        if fr.compact_bwd:
            d_lp, d_opp, d_cam = compact_bwd(
                scene, ctx.fine_cull, cam, rp.params, fr.layout.grad_denom_clamp, t, hit,
                g_img.contiguous(),
            )
        else:
            # The legacy backward runs ungated after a culled forward, as in
            # the reference (pallas_grad.py:1423-1429).
            d_lp, d_opp, d_cam = bwd(
                scene, cam, rp.params, fr.layout, t, hit, g_img.contiguous()
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


def backward_route(spec: TapeSpec, cfg: RenderConfig):
    """(plan kind, reason): why the compact O(active) backward is not taken,
    or reason None when it is, by the eligibility chain of
    pallas_grad.py:1279-1298 with the reference's reason strings. Two of its
    gates do not apply to the port: the 64-item history cap of the TPU's
    VMEM (the port sizes history to the plan's span, ROADMAP §3.1) and the
    AA-packed layout (always available)."""
    if not cfg.leaf_cull:
        return None, "leaf_cull disabled"
    kind = plan_kind(spec)
    if kind is None:
        return kind, "scene has no compact plan (not foldable)"
    if kind == "residual":
        return kind, "plan has residual (unrolled) subtrees"
    if spec.has_materials and kind != "pool":
        return kind, "painted materials on smooth/ordered segments"
    return kind, None


class FusedRenderer:
    """`render(arrays, cam_vec f32[8]) -> image f32[H, W, 3]` on one device,
    differentiable with respect to `arrays.leaf_params`, `arrays.op_param`
    and `cam_vec` (tensors; numpy parameters are uploaded and are not
    differentiated). `cam_vec[7]` is the band's first row and gets a zero
    gradient.

    With `cfg.leaf_cull` the forward is culled (the coarse and fine kernels
    read per-tile item lists or masks); a pool-only compact plan then takes
    the compact backward K9 (`compact_bwd`), any other scene the legacy K8."""

    def __init__(self, spec: TapeSpec, cfg: RenderConfig, width: int, height: int, device, reason):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.prepass = make_pallas_image_render_aa(spec, cfg, width, height, device=device)
        self.params = self.prepass.params
        self.layout = GradLayout.of(spec, cfg)
        # `reason` is backward_route's; make_fused_render_vjp has refused
        # the compact plans whose backward is not ported.
        self.compact_bwd = reason is None
        # The keys and strings of the reference (pallas_grad.py:1887-1895).
        # The port always keeps a pixel's AA samples in adjacent lanes (the
        # packed layout) and has no row-block size.
        self.backward_info = {
            "kind": "pallas_compact" if self.compact_bwd else "pallas_legacy_unrolled",
            "compact": self.compact_bwd,
            "reason": reason,
            "aa_packed": True,
            "bm": None,
            "soft": False,
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
    *,
    device,
    prepass_block: int = 1,
    band_rows=None,
    aa_packed=None,
    soft: bool = False,
) -> FusedRenderer:
    """The port's counterpart of `raymarch_tpu.ops.pallas_grad.
    make_fused_render_vjp`, cached per (spec, cfg, width, height, device).

    Serves a static, material-free tape with prepass_block=1 and the packed
    layout: without `cfg.leaf_cull` the legacy backward (K8); with it the
    culled forward, then the compact backward (K9) for a pool-only plan and
    K8 for a plan with residual subtrees or no plan, as the reference
    dispatches (`backward_info`). A seg1 or stream plan, which the
    reference sends to branches of the compact backward not ported yet,
    raises, as does every other option, with its ROADMAP item.
    """
    if spec.static_tape is None:
        _not_ported("fused-VJP rendering of a dynamic tape (compile_scene(static=True) is required)",
                    "§1.12 dynamic tape, tiered runtime and viewer")
    if soft:
        _not_ported("soft", "§1.10 many-primitive backward and soft coverage")
    kind, reason = backward_route(spec, cfg)
    if reason is None and kind != "pool":
        _not_ported(f"the compact backward of a {kind} plan (K9's ordered-fold branches)",
                    "§1.10 many-primitive backward and soft coverage")
    if reason is None and spec.has_materials:
        _not_ported("the compact backward of painted materials (K9's winner albedo routing)",
                    "§1.10 many-primitive backward and soft coverage")
    if spec.has_materials:
        _not_ported("materials", "§1.8 forward variants on the main kernels")
    if band_rows is not None:
        _not_ported("band_rows", "§1.11 multi-device")
    if prepass_block != 1:
        _not_ported("prepass_block > 1", "§1.9 many-primitive forward")
    if aa_packed is False:
        _not_ported("the unpacked layout", "§1.13 remaining surfaces, K4 fine_kernel")
    return _cached_fused(spec, cfg, int(width), int(height), resolve_device(device), reason)


@functools.lru_cache(maxsize=None)
def _cached_fused(spec, cfg, width, height, device, reason):
    return FusedRenderer(spec, cfg, width, height, device, reason)
