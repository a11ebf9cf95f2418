"""Fused forward+backward renderer: the cone-prepass forward that keeps its
residuals, and a CUDA backward kernel.

Port of `raymarch_tpu/ops/pallas_grad.py:make_fused_render_vjp` (1221) on
the path it takes with `leaf_cull=False`: the legacy backward
(`backward_info["kind"] == "pallas_legacy_unrolled"`, reason "leaf_cull
disabled").

- Forward: the coarse kernel, then the fine kernel with residuals
  (`cuda_prepass.fine_res`, the counterpart of the Pallas fine kernel with
  `emit_th=True`): the image, and each AA ray's march end t and hit flag.
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
from .cuda_march import SceneBuffers, scene_plain
from .cuda_prepass import (
    PrepassParams,
    _CParams,
    _check,
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


def _bwd_plain_band(scene: SceneBuffers, cam, p: PrepassParams, lay: GradLayout, t, hit, g_img, i0):
    """Gradient of one band of rows [i0, i0 + len(t)) -> (d_lp, d_opp,
    d_cam7), the replay of pallas_grad.py:1600-1699 by autograd."""
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
        cols = shade_plain(sc, p, *rays(cam_g), tt, hit)
        loss = sum(torch.sum(col * gc) for col, gc in zip(cols, g))
        g1 = torch.autograd.grad(loss, (lp, opp, cam7, tt), allow_unused=True)
        gt = g1[3] if g1[3] is not None else torch.zeros_like(t)

        # Implicit term: dt/dtheta through the hit constraint F(o + d t) = 0.
        with torch.no_grad():
            ox, oy, oz, dx, dy, dz = rays(cam.detach())
        ts = t.detach().clone().requires_grad_(True)
        f = scene_plain(scene, p.max_dist, ox + dx * ts, oy + dy * ts, oz + dz * ts)
        (fdot,) = torch.autograd.grad(f.sum(), ts)
        c = lay.grad_denom_clamp
        denom = torch.where(torch.abs(fdot) > c, fdot, torch.where(fdot >= 0, c, -c))
        w = (-gt * hit / denom).detach()
        qx, qy, qz, ex, ey, ez = rays(cam_g)
        f = scene_plain(sc, p.max_dist, qx + ex * t * hit, qy + ey * t * hit, qz + ez * t * hit)
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
        a, b, c = _bwd_plain_band(scene, cam, p, lay, t[i0:i1], hit[i0:i1], g_img[i0:i1], i0)
        d_lp += a
        d_opp += b
        d_cam7 += c
    # Words the kernel never writes are zero in its layout as well.
    keep = torch.zeros(lay.n_instr, dtype=torch.bool, device=cam.device)
    keep[: lay.n_real] = True
    d_opp = torch.where(keep, d_opp, 0.0)
    return d_lp, d_opp, torch.cat([d_cam7, torch.zeros(1, dtype=torch.float32, device=cam.device)])


# --------------------------------------------------------------------------
# Wrapper: plain on the CPU, the CUDA kernel on a CUDA device


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


def reset_launch_counts():
    bwd.launches = 0


# --------------------------------------------------------------------------
# The differentiable renderer


class _FusedRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp, opp, cam, fr):
        rp = fr.prepass
        scene, cam_d, bound = rp.scene_args(types.SimpleNamespace(leaf_params=lp, op_param=opp), cam)
        pre = coarse(scene, cam_d, bound, rp.params)
        img, t, hit = fine_res(scene, cam_d, bound, rp.params, *pre)
        ctx.fr = fr
        ctx.save_for_backward(scene.leaf_params, scene.op_param, cam_d, t, hit)
        return img

    @staticmethod
    def backward(ctx, g_img):
        lp, opp, cam, t, hit = ctx.saved_tensors
        fr = ctx.fr
        rp = fr.prepass
        scene = SceneBuffers(fr.spec, rp.topology[0], rp.topology[1], lp, opp)
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


class FusedRenderer:
    """`render(arrays, cam_vec f32[8]) -> image f32[H, W, 3]` on one device,
    differentiable with respect to `arrays.leaf_params`, `arrays.op_param`
    and `cam_vec` (tensors; numpy parameters are uploaded and are not
    differentiated). `cam_vec[7]` is the band's first row and gets a zero
    gradient."""

    def __init__(self, spec: TapeSpec, cfg: RenderConfig, width: int, height: int, device):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.prepass = make_pallas_image_render_aa(spec, cfg, width, height, device=device)
        self.params = self.prepass.params
        self.layout = GradLayout.of(spec, cfg)
        # The keys and strings of the reference (pallas_grad.py:1887-1895).
        # The port always keeps a pixel's AA samples in adjacent lanes (the
        # packed layout) and has no row-block size.
        self.backward_info = {
            "kind": "pallas_legacy_unrolled",
            "compact": False,
            "reason": "leaf_cull disabled",
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

    Serves the legacy backward of a static, material-free tape with
    leaf_cull off, prepass_block=1 and the packed layout; every other option
    raises NotImplementedError naming its ROADMAP item.
    """
    if spec.static_tape is None:
        _not_ported("fused-VJP rendering of a dynamic tape (compile_scene(static=True) is required)",
                    "§1.12 dynamic tape, tiered runtime and viewer")
    if soft:
        _not_ported("soft", "§1.10 many-primitive backward and soft coverage")
    if cfg.leaf_cull:
        _not_ported("leaf_cull (the compact backward, K9)", "§1.9/§1.10 many-primitive forward and backward")
    if spec.has_materials:
        _not_ported("materials", "§1.8 forward variants on the main kernels")
    if band_rows is not None:
        _not_ported("band_rows", "§1.11 multi-device")
    if prepass_block != 1:
        _not_ported("prepass_block > 1", "§1.9 many-primitive forward")
    if aa_packed is False:
        _not_ported("the unpacked layout", "§1.13 remaining surfaces, K4 fine_kernel")
    return _cached_fused(spec, cfg, int(width), int(height), resolve_device(device))


@functools.lru_cache(maxsize=None)
def _cached_fused(spec, cfg, width, height, device):
    return FusedRenderer(spec, cfg, width, height, device)
