"""Sphere-tracing march, shading and the renderer: `raymarch_tpu.ops.march`.

The torch reference renderer (march.py:49-584 of the JAX package): the
masked march of a batch of rays (`make_march`, modes "forward", "implicit",
"unrolled"), the soft-coverage march (`make_march_soft`), tetrahedron
normals, Lambert shading with the checker floor (`shade`, `shade_soft`),
sqrt gamma, `render_rays`, and `make_renderer` over every backend of the
reference:

- "jnp": the reference's pure-XLA path, here plain torch ops on the
  renderer's device (no kernel stands behind it in the reference either);
  all four modes, and `chunk`;
- "pallas": K5 (csrc/march.cu) per ray batch, mode "forward" raw and
  "implicit" with the implicit-function VJP (`cuda_march.make_march_pallas`);
- "pallas_image": K6 (in-kernel raygen, march) and this module's shading;
- "pallas_full": K7 (raygen, march and shading in one kernel);
- "pallas_prepass" and "pallas_fused": the cone-prepass renderer and the
  fused forward + backward (`cuda_prepass`, `cuda_grad`).

Differentiation: the march is a `torch.autograd.Function` whose backward
applies the implicit-function theorem at the converged hit point (F = sdf(o
+ t d) = 0): dt/dtheta = -F_theta / (grad_x F . d), dt/do = -grad_x F /
(grad_x F . d), dt/dd = t dt/do, the denominator clamped away from 0 by
`cfg.grad_denom_clamp`; misses get no gradient through t. The soft march
adds the envelope (Danskin) term of its closest approach s_min at the frozen
argmin t_min. The scene's vector-Jacobian products come from torch autograd
on `sdf.make_scene_fn`. "unrolled" leaves the step loop to autograd;
"forward" carries no gradient through t.

Host syncs: the reference's while_loop tests `any(live)` on the device every
iteration. Here each test reads a flag to the host, so the loop tests every
`cfg.exit_check_every` steps (every 4 when that is 1); masked lanes are
no-ops, so t, hit and steps do not move.

`make_renderer` takes the reference's arguments in its order (384-393),
plus the keyword-only `device` (default "cuda"; "cpu" runs the plain
versions of the kernels). `interpret` has no effect.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.utils.checkpoint

from ..config import DEFAULT_CONFIG, RenderConfig
from ..utils import profiling
from ..utils.camera import cam_vec
from .raygen import raygen_flat
from .sdf import _param, make_scene_color_fn, make_scene_fn
from .tape import TapeArrays, TapeSpec

# The exit test's period where cfg.exit_check_every is 1: each test is a
# host sync, and masked steps change nothing.
_CHECK_EVERY = 4


def _check_every(cfg: RenderConfig) -> int:
    k = int(cfg.exit_check_every)
    return k if k > 1 else _CHECK_EVERY


def _arrays_on(arrays: TapeArrays, like: torch.Tensor) -> TapeArrays:
    """`arrays` with its parameters as tensors on `like`'s device (numpy is
    uploaded; tensors keep their autograd graph)."""
    return dataclasses.replace(arrays, leaf_params=_param(arrays.leaf_params, like),
                               op_param=_param(arrays.op_param, like))


# ---------------------------------------------------------------------------
# March
# ---------------------------------------------------------------------------


def _march_loop(scene, origins, dirs, arrays, cfg: RenderConfig, soft: bool = False):
    """The masked march (march.py:49-80; soft 146-178): step every live ray
    by the scene distance until it falls below min_dist (hit), exceeds
    max_dist (escape), or max_iter evaluations elapse. Differentiable
    through autograd where its inputs are ("unrolled")."""
    n = origins.shape[0]
    dev = origins.device
    t = origins.new_zeros(n)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    s_min = origins.new_full((n,), float("inf"))
    t_min = origins.new_zeros(n)
    every = _check_every(cfg)
    for k in range(cfg.max_iter):
        if k % every == 0 and not bool(live.any()):
            break
        dist = scene(origins + dirs * t[:, None], arrays)
        if soft:
            better = live & (dist < s_min)
            s_min = torch.where(better, dist, s_min)
            t_min = torch.where(better, t, t_min)
        newly_hit = live & (dist < cfg.min_dist)
        escaped = live & (dist > cfg.max_dist)
        live2 = live & ~(newly_hit | escaped)
        t = torch.where(live2, t + dist, t)
        hit = hit | newly_hit
        steps = steps + live.to(torch.int32)
        live = live2
    out = (t, hit.to(origins.dtype), steps)
    return (*out[:2], s_min, t_min) if soft else out


def _march_while(scene, origins, dirs, arrays, cfg: RenderConfig):
    """The masked march with no gradient through t -> (t, hit, steps)."""
    with torch.no_grad():
        return _march_loop(scene, origins, dirs, arrays, cfg)


def _march_scan(scene, origins, dirs, arrays, cfg: RenderConfig):
    """The masked march left to autograd (the reference's `lax.scan`
    marcher): reverse-differentiable step by step."""
    return _march_loop(scene, origins, dirs, arrays, cfg)


def _march_while_soft(scene, origins, dirs, arrays, cfg: RenderConfig):
    """The march that also keeps each ray's smallest scene distance and its
    t: (t, hit, s_min, t_min)."""
    with torch.no_grad():
        return _march_loop(scene, origins, dirs, arrays, cfg, soft=True)


def _denominator(fdot, cfg: RenderConfig):
    c = cfg.grad_denom_clamp
    return torch.where(torch.abs(fdot) > c, fdot, torch.where(fdot >= 0, c, -c))


def _scene_vjp(scene, arrays, lp, opp, pos, w, with_fdot=None, cfg=None):
    """(grad pos, grad leaf_params, grad op_param) of sum(w * scene(pos)),
    through autograd on the scene. With `with_fdot` (the ray directions),
    w is first divided by the clamped directional derivative grad_x F . d
    at pos (the implicit-function weight): w <- w / denom."""
    with torch.enable_grad():
        pos = pos.detach().requires_grad_(True)
        lp_ = lp.detach().requires_grad_(True)
        opp_ = opp.detach().requires_grad_(True)
        d = scene(pos, dataclasses.replace(arrays, leaf_params=lp_, op_param=opp_))
        if with_fdot is not None:
            (gx,) = torch.autograd.grad(d.sum(), pos, retain_graph=True)
            w = w / _denominator(torch.sum(gx * with_fdot, dim=-1), cfg)
        g = torch.autograd.grad(d, (pos, lp_, opp_), grad_outputs=w, allow_unused=True)
    return tuple(torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, (pos, lp_, opp_)))


class _ImplicitMarch(torch.autograd.Function):
    """march(origins, dirs, lp, opp) -> (t, hit, steps) with the implicit-
    function VJP (march.py:104-125)."""

    @staticmethod
    def forward(ctx, origins, dirs, lp, opp, fwd, scene, arrays, cfg):
        a = dataclasses.replace(arrays, leaf_params=lp, op_param=opp)
        t, hit, steps = fwd(origins.detach(), dirs.detach(), a)
        ctx.save_for_backward(origins, dirs, lp, opp, t, hit)
        ctx.scene, ctx.arrays, ctx.cfg = scene, arrays, cfg
        ctx.mark_non_differentiable(hit, steps)
        return t, hit, steps

    @staticmethod
    def backward(ctx, gt, _ghit, _gsteps):
        origins, dirs, lp, opp, t, hit = ctx.saved_tensors
        pos = origins + dirs * t[:, None]
        gpos, glp, gopp = _scene_vjp(ctx.scene, ctx.arrays, lp, opp, pos, -gt * hit, dirs, ctx.cfg)
        return gpos, gpos * t[:, None], glp, gopp, None, None, None, None


def implicit_march(fwd, scene, cfg: RenderConfig):
    """`march(origins, dirs, arrays) -> (t, hit, steps)` of the forward
    march `fwd(origins, dirs, arrays)` with the implicit-function VJP through
    `scene`: the "implicit" mode of `make_march`, and of `make_march_pallas`
    over K5."""

    def march(origins, dirs, arrays):
        a = _arrays_on(arrays, origins)
        return _ImplicitMarch.apply(origins, dirs, a.leaf_params, a.op_param, fwd, scene, a, cfg)

    return march


@functools.lru_cache(maxsize=None)
def make_march(spec: TapeSpec, cfg: RenderConfig, mode: str = "implicit"):
    """Build `march(origins[N,3], dirs[N,3], arrays) -> (t, hit, steps)` on
    the rays' device.

    mode: "implicit" (masked march + implicit-function VJP), "unrolled" (the
    step loop left to autograd), or "forward" (no gradient through t).
    """
    scene = make_scene_fn(spec, cfg)
    if mode == "forward":
        return lambda o, d, a: _march_while(scene, o, d, _arrays_on(a, o), cfg)
    if mode == "unrolled":
        return lambda o, d, a: _march_scan(scene, o, d, _arrays_on(a, o), cfg)
    if mode != "implicit":
        raise ValueError(f"unknown march mode: {mode}")
    return implicit_march(lambda o, d, a: _march_while(scene, o, d, a, cfg), scene, cfg)


# ---------------------------------------------------------------------------
# Soft-coverage march (silhouette gradients)
# ---------------------------------------------------------------------------


class _SoftMarch(torch.autograd.Function):
    """march_soft(origins, dirs, lp, opp) -> (t, hit, s_min, t_min): the
    implicit-function VJP of t plus the envelope term of s_min at the frozen
    argmin (march.py:207-233)."""

    @staticmethod
    def forward(ctx, origins, dirs, lp, opp, scene, arrays, cfg):
        a = dataclasses.replace(arrays, leaf_params=lp, op_param=opp)
        t, hit, s_min, t_min = _march_while_soft(scene, origins.detach(), dirs.detach(), a, cfg)
        ctx.save_for_backward(origins, dirs, lp, opp, t, hit, t_min)
        ctx.scene, ctx.arrays, ctx.cfg = scene, arrays, cfg
        ctx.mark_non_differentiable(hit, t_min)
        return t, hit, s_min, t_min

    @staticmethod
    def backward(ctx, gt, _ghit, gs, _gtm):
        origins, dirs, lp, opp, t, hit, t_min = ctx.saved_tensors
        pos = origins + dirs * t[:, None]
        gpos_t, glp_t, gop_t = _scene_vjp(ctx.scene, ctx.arrays, lp, opp, pos, -gt * hit, dirs, ctx.cfg)
        pos_m = origins + dirs * t_min[:, None]
        gpos_m, glp_m, gop_m = _scene_vjp(ctx.scene, ctx.arrays, lp, opp, pos_m, gs)
        go = gpos_t + gpos_m
        gd = gpos_t * t[:, None] + gpos_m * t_min[:, None]
        return go, gd, glp_t + glp_m, gop_t + gop_m, None, None, None


@functools.lru_cache(maxsize=None)
def make_march_soft(spec: TapeSpec, cfg: RenderConfig):
    """Build `march_soft(origins, dirs, arrays) -> (t, hit, s_min, t_min)`:
    the march plus the closest approach s_min = min over the march of the
    scene distance and its t_min, whose VJP is the envelope (Danskin)
    derivative at the frozen argmin; t keeps the implicit-function VJP."""
    scene = make_scene_fn(spec, cfg)

    def march_soft(origins, dirs, arrays):
        a = _arrays_on(arrays, origins)
        return _SoftMarch.apply(origins, dirs, a.leaf_params, a.op_param, scene, a, cfg)

    return march_soft


# ---------------------------------------------------------------------------
# Normals and shading
# ---------------------------------------------------------------------------

_TETRA_TAPS = (
    (1.0, -1.0, -1.0),
    (-1.0, -1.0, 1.0),
    (-1.0, 1.0, -1.0),
    (1.0, 1.0, 1.0),
)


def calculate_normals(scene, pos, arrays, cfg: RenderConfig):
    """Tetrahedron 4-tap normal estimate (reference wgsl:135-144)."""
    acc = torch.zeros_like(pos)
    for tap in _TETRA_TAPS:
        k = pos.new_tensor(tap)
        acc = acc + k * scene(pos + k * cfg.normal_eps, arrays)[:, None]
    norm = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    return acc / torch.clamp_min(norm, 1e-20)


def _surface(scene, origins, dirs, pos, arrays, cfg: RenderConfig, albedo_fn):
    """(albedo * Lambert at pos, the checker floor's colour of each ray)."""
    normal = calculate_normals(scene, pos, arrays, cfg)
    to_light = pos - pos.new_tensor(cfg.light_position)
    to_light = to_light / torch.clamp_min(torch.linalg.vector_norm(to_light, dim=-1, keepdim=True), 1e-20)
    diffuse = torch.clamp_min(torch.sum(normal * to_light, dim=-1), cfg.ambient)
    if albedo_fn is not None:
        albedo = albedo_fn(pos, arrays)
    else:
        albedo = pos.new_tensor(cfg.albedo)[None, :]
    surf = albedo * diffuse[:, None]

    dy = dirs[:, 1]
    dy_safe = torch.where(torch.abs(dy) > 1e-8, dy, 1e-8)
    floor_t = (cfg.floor_y - origins[:, 1]) / dy_safe
    fpos = origins + dirs * floor_t[:, None]
    # Clamp before the int cast: far-away floor positions (grazing rays)
    # must not overflow int32; the pattern out there is sub-pixel anyway.
    fxz = torch.clamp(fpos[:, [0, 2]], -1e7, 1e7)
    ip = torch.round(fxz + 0.5).to(torch.int32)  # half to even, as jnp.round
    parity = torch.bitwise_and(torch.bitwise_xor(ip[:, 0], ip[:, 1]), 1).to(pos.dtype)
    floor_color = pos.new_tensor(cfg.floor_base)[None, :] + cfg.floor_checker * parity[:, None]
    on_floor = (floor_t > 0.0) & (torch.abs(dy) > 1e-8)
    miss_color = torch.where(on_floor[:, None], floor_color, 0.0)
    return surf, miss_color


def shade(scene, origins, dirs, t, hit, arrays, cfg: RenderConfig, albedo_fn=None):
    """Per-ray linear colour (no gamma): Lambert on a hit, the checker floor
    on a miss, black otherwise (reference wgsl:96-130). A miss ray's surface
    term is evaluated at its origin (the reference's double-where), so its
    masked-out normal leaks no NaN into the gradients. `albedo_fn(pos,
    arrays) -> rgb[N,3]` gives the per-hit albedo of a painted scene."""
    pos = origins + dirs * t[:, None]
    pos = torch.where(hit[:, None] > 0.5, pos, origins)
    hit_color, miss_color = _surface(scene, origins, dirs, pos, arrays, cfg, albedo_fn)
    return hit[:, None] * hit_color + (1.0 - hit[:, None]) * miss_color


def shade_soft(scene, origins, dirs, t, hit, s_min, t_min, arrays, cfg: RenderConfig, albedo_fn=None):
    """Soft-coverage shading (march.py:236-287): the hit mask becomes alpha
    = exp(-max(s_min - min_dist, 0) / beta); a miss shades its surface term
    at the closest approach, and a ray of alpha <= 1e-4 at its origin."""
    alpha = torch.exp(-torch.clamp_min(s_min - cfg.min_dist, 0.0) / cfg.coverage_beta)
    t_eff = torch.where(hit > 0.5, t, t_min)
    pos = origins + dirs * t_eff[:, None]
    pos = torch.where((alpha > 1e-4)[:, None], pos, origins)
    surf, miss_color = _surface(scene, origins, dirs, pos, arrays, cfg, albedo_fn)
    a = alpha[:, None]
    return a * surf + (1.0 - a) * miss_color


# ---------------------------------------------------------------------------
# Full renderer
# ---------------------------------------------------------------------------


def _gamma(color):
    """sqrt gamma (reference wgsl:68); the +1e-12 keeps the gradient finite
    at exactly-black pixels."""
    return torch.sqrt(torch.clamp_min(color, 0.0) + 1e-12)


def _make_albedo_fn(spec: TapeSpec, cfg: RenderConfig):
    """Per-hit albedo lookup of a painted scene, else None."""
    if not spec.has_materials:
        return None
    scene_color = make_scene_color_fn(spec, cfg)
    return lambda pos, arrays: scene_color(pos, arrays)[1]


def render_rays(spec, arrays, origins, dirs, cfg=DEFAULT_CONFIG, mode="implicit"):
    """March + shade + gamma for explicit rays -> colour[N,3], on the rays'
    device."""
    scene = make_scene_fn(spec, cfg)
    march = make_march(spec, cfg, mode)
    t, hit, _ = march(origins, dirs, arrays)
    color = shade(scene, origins, dirs, t, hit, _arrays_on(arrays, origins), cfg, _make_albedo_fn(spec, cfg))
    return _gamma(color)


def make_renderer(
    spec: TapeSpec,
    width: int,
    height: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    mode: str = "implicit",
    chunk: Optional[int] = None,
    backend: str = "jnp",
    interpret: bool = False,
    *,
    device="cuda",
):
    """Build `render(arrays, camera) -> image f32[H, W, 3]` on `device`.

    `device` is "cuda[:n]" (the default) or "cpu": on the CPU the kernels'
    plain versions run, on CUDA the kernels; CUDA without a GPU raises, it
    never falls back to the CPU. Backends (see the module docstring): "jnp"
    (modes "forward", "implicit", "unrolled", "soft"), "pallas" ("forward",
    "implicit"), "pallas_image", "pallas_full" and "pallas_prepass"
    ("forward"), "pallas_fused" ("implicit", "soft"). The output is
    differentiable with respect to `arrays.leaf_params`, `arrays.op_param`
    (tensors) and the camera's position and rotation (tensors) in the
    gradient modes. `chunk` renders the rays of backends "jnp", "pallas" and
    "pallas_image" in chunks of that many, and in a backward recomputes
    each chunk's shading instead of keeping it (only the march outputs are
    kept). Renderers are cached per argument set, so a numeric scene edit
    that keeps the TapeSpec gets the same renderer back and rebuilds
    nothing. `interpret` (the Pallas interpreter) has no effect.
    """
    del interpret
    from .cuda_prepass import resolve_device

    dev = resolve_device(device)
    return _renderer(spec, int(width), int(height), cfg, mode, None if chunk is None else int(chunk), backend,
                     dev)


@functools.lru_cache(maxsize=None)
def _renderer(spec, width, height, cfg, mode, chunk, backend, dev):
    from . import cuda_march as cm

    s = cfg.aa_samples * cfg.aa_samples
    total = s * height * width

    if backend == "pallas_fused":
        # Fused forward + backward: differentiable with respect to
        # arrays.leaf_params, arrays.op_param and the camera (tensors).
        if mode not in ("implicit", "soft"):
            raise ValueError("pallas_fused backend supports 'implicit'/'soft'")
        from .cuda_grad import make_fused_render_vjp

        rv = make_fused_render_vjp(spec, cfg, width, height, soft=mode == "soft", device=dev)

        @profiling.framed
        def render_fused(arrays: TapeArrays, camera):
            return rv(arrays, cam_vec(camera, 0.0, device=rv.device))

        render_fused.renderer = rv
        render_fused.backward_info = rv.backward_info
        return render_fused
    if backend == "pallas_prepass":
        if mode != "forward":
            raise ValueError("pallas_prepass backend is forward-only")
        from .cuda_prepass import make_pallas_image_render_aa

        # The reference's call form (march.py:446-449); an AA grid that does
        # not pack falls to the unpacked fine pass K4.
        rp = make_pallas_image_render_aa(spec, cfg, width, height, device=dev,
                                         aa_packed=not cfg.aa_shared_normals)

        @profiling.framed
        def render_prepass(arrays: TapeArrays, camera):
            return rp(arrays, cam_vec(camera, 0.0, device=rp.device))

        render_prepass.renderer = rp
        return render_prepass
    if backend == "pallas_full":
        if mode != "forward":
            raise ValueError("pallas_full backend is forward-only")
        # K7's pixel build takes the reference's AA mean (march.py:488-507)
        # inside the kernel.
        pixel_render = cm.make_pallas_pixel_render(spec, cfg, width, height, device=dev)

        @profiling.framed
        def render_full(arrays: TapeArrays, camera):
            return pixel_render(arrays, cam_vec(camera, 0.0, device=dev))

        render_full.renderer = pixel_render
        return render_full

    scene = make_scene_fn(spec, cfg)
    albedo_fn = _make_albedo_fn(spec, cfg)
    if backend == "jnp":
        march = make_march_soft(spec, cfg) if mode == "soft" else make_march(spec, cfg, mode)
    elif backend == "pallas":
        if mode == "forward":
            raw = cm.make_pallas_ray_march(spec, cfg, device=dev)
            march = lambda o, d, a: raw(a, o, d)  # noqa: E731
        elif mode == "implicit":
            march = cm.make_march_pallas(spec, cfg, device=dev)
        else:
            raise ValueError("pallas backend supports modes 'forward'/'implicit'")
    elif backend == "pallas_image":
        if mode != "forward":
            raise ValueError("pallas_image backend is forward-only")
        image_march = cm.make_pallas_image_march(spec, cfg, width, height, device=dev)
    else:
        raise ValueError(f"unknown backend: {backend}")

    def rays(idx, camera):
        return raygen_flat(idx, camera.position, camera.rotation, width, height, cfg)

    def shade_rays(origins, dirs, t, hit, arrays):
        return _gamma(shade(scene, origins, dirs, t, hit, arrays, cfg, albedo_fn))

    def march_and_shade(idx, arrays, camera):
        origins, dirs = rays(idx, camera)
        if mode == "soft":
            t, hit, s_min, t_min = march(origins, dirs, arrays)
            shade_fn = lambda o, d, a: _gamma(  # noqa: E731
                shade_soft(scene, o, d, t, hit, s_min, t_min, a, cfg, albedo_fn))
        else:
            t, hit, _ = march(origins, dirs, arrays)
            shade_fn = lambda o, d, a: shade_rays(o, d, t, hit, a)  # noqa: E731
        if chunk is None or mode == "unrolled" or not torch.is_grad_enabled():
            return shade_fn(origins, dirs, arrays)
        # Keep only the march outputs of the chunk: its shading is
        # recomputed in the backward (save_only_these_names("march"),
        # march.py:562-581).
        return torch.utils.checkpoint.checkpoint(shade_fn, origins, dirs, arrays, use_reentrant=False)

    def chunks():
        step = total if chunk is None else chunk
        return [(i, min(i + step, total)) for i in range(0, total, step)]

    if backend == "pallas_image":

        @profiling.framed
        def render_image(arrays: TapeArrays, camera):
            a = _arrays_on(arrays, torch.empty(0, device=dev))
            t, hit, _ = image_march(arrays, cam_vec(camera, 0.0, device=dev))
            cols = []
            for i0, i1 in chunks():
                idx = torch.arange(i0, i1, dtype=torch.int64, device=dev)
                origins, dirs = rays(idx, camera)
                cols.append(shade_rays(origins, dirs, t[i0:i1], hit[i0:i1], a))
            return torch.cat(cols).reshape(height, width, s, 3).mean(dim=2)

        render_image.renderer = image_march
        return render_image

    @profiling.framed
    def render(arrays: TapeArrays, camera):
        a = _arrays_on(arrays, torch.empty(0, device=dev))
        cols = []
        for i0, i1 in chunks():
            idx = torch.arange(i0, i1, dtype=torch.int64, device=dev)
            cols.append(march_and_shade(idx, a, camera))
        return torch.cat(cols).reshape(height, width, s, 3).mean(dim=2)

    render.backward_info = {
        "kind": "pallas_fwd_jnp_vjp" if backend == "pallas" else f"jnp_{mode}",
        "compact": False,
        "reason": None,
    }
    return render
