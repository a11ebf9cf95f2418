"""Renderer entry point: `make_renderer`, as in `raymarch_tpu.ops.march`.

Ported so far: the forward cone-prepass backend (`backend="pallas_prepass"`,
`mode="forward"`, march.py:439-461 of the JAX package) and the fused
forward+backward backend (`backend="pallas_fused"`, modes "implicit" and
"soft", 462-487); the other backend strings and modes raise
NotImplementedError naming their ROADMAP item. `make_renderer` takes the
reference's arguments in the reference's order (384-393), plus the
keyword-only `device` (default "cuda").
"""

from __future__ import annotations

import functools

from ..config import DEFAULT_CONFIG, RenderConfig
from ..utils.camera import cam_vec
from .cuda_grad import make_fused_render_vjp
from .cuda_prepass import make_pallas_image_render_aa
from .tape import TapeArrays, TapeSpec

_NOT_PORTED = {
    "jnp": "§1 item 3, the torch reference renderer",
    "pallas": "§1 item 5, the remaining render surfaces, K5",
    "pallas_image": "§1 item 5, the remaining render surfaces, K6",
    "pallas_full": "§1 item 5, the remaining render surfaces, K7",
}


def make_renderer(
    spec: TapeSpec,
    width: int,
    height: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    mode: str = "implicit",
    chunk=None,
    backend: str = "jnp",
    interpret: bool = False,
    *,
    device="cuda",
):
    """Build `render(arrays, camera) -> image f32[H, W, 3]` on `device`.

    `device` is "cuda[:n]" (the default) or "cpu": on the CPU the kernels'
    plain versions run, on CUDA the kernels; CUDA without a GPU raises, it
    never falls back to the CPU. `backend="pallas_fused"` takes mode
    "implicit" (interior gradients) or "soft" (soft coverage: silhouette
    gradients through each ray's closest approach). The renderer is cached
    per (spec, cfg, width, height, mode, device), so a numeric scene edit
    that keeps the TapeSpec gets the same renderer back and rebuilds
    nothing. `chunk` (the ray chunk of the reference's "jnp"
    march) and `interpret` (the Pallas interpreter) have no effect on the
    ported backends, which render the whole frame in their kernels.
    """
    del chunk, interpret  # the reference's layout only
    if backend == "pallas_fused":
        # Fused forward + backward: differentiable with respect to
        # arrays.leaf_params, arrays.op_param and the camera (tensors).
        if mode not in ("implicit", "soft"):
            raise ValueError("pallas_fused backend supports 'implicit'/'soft'")
        rv = make_fused_render_vjp(spec, cfg, width, height, soft=mode == "soft", device=device)
        return _fused_render(rv)
    if backend != "pallas_prepass":
        item = _NOT_PORTED.get(backend)
        if item is None:
            raise ValueError(f"unknown backend: {backend}")
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP: {item})"
        )
    if mode != "forward":
        raise NotImplementedError(
            f"mode {mode!r} of backend 'pallas_prepass' is not ported: the "
            "prepass backend is forward-only (gradients: backend 'pallas_fused')"
        )
    rp = make_pallas_image_render_aa(spec, cfg, width, height, device=device)
    return _prepass_render(rp)


@functools.lru_cache(maxsize=None)
def _prepass_render(rp):
    def render(arrays: TapeArrays, camera):
        return rp(arrays, cam_vec(camera, 0.0, device=rp.device))

    render.renderer = rp
    return render


@functools.lru_cache(maxsize=None)
def _fused_render(rv):
    def render(arrays: TapeArrays, camera):
        return rv(arrays, cam_vec(camera, 0.0, device=rv.device))

    render.renderer = rv
    render.backward_info = rv.backward_info
    return render
