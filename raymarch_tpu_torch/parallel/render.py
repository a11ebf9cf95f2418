"""The fit step for inverse rendering, on one device.

Port of `raymarch_tpu/parallel/render.py:make_fit_step` (208-371) at world
size 1: the image is one band (rows [0, H), so `cam_vec[7] = 0`, as
`_band_cam_vec` (47) builds it for device 0), and no gradient crosses
devices. Row-sharded training over several devices, `row_interleave` and
`band_rows` come with ROADMAP §1 item 7. `make_fit_step` takes the
reference's arguments in its order (208-222), plus the keyword-only
`device` (default "cuda"); `interpret` (the Pallas interpreter) has no
effect here.

Backends: "pallas_fused" (the fused forward + backward kernels), and, as
`_local_renderer`'s non-fused branch (96-136), "jnp" (the torch march in
mode "implicit", "unrolled" or "soft") and "pallas" (K5's forward with the
implicit-function VJP), whose band is raygen + march + shading in torch. The
reference's "pallas" fit step crashes in soft mode (ROADMAP §3 fault 13);
the port raises the ValueError of its `make_renderer` instead.

`mode="soft"` trains through the soft-coverage VJP (silhouette gradients).
The reference's `pallas_fused` fit step builds its fused VJP without
`soft` and so trains the implicit gradients whatever the mode (ROADMAP §3
fault 11); the port passes the mode on.

Optimizers are torch's: `optimizer` and `camera_optimizer` are callables
that build a `torch.optim.Optimizer` over a list of tensors, e.g.
`functools.partial(torch.optim.Adam, lr=1e-2)`; `torch.optim.Adam` computes
the update of `optax.adam` (eps 1e-8, bias-corrected), `torch.optim.SGD`
that of `optax.sgd`. The optimizer state (`FitOptState`) holds the
optimizers and the tensors they update; the step updates it in place and
returns it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..ops.cuda_grad import make_fused_render_vjp
from ..ops.cuda_prepass import resolve_device
from ..ops.tape import TapeArrays, TapeSpec
from ..utils.camera import Camera, cam_vec


def _row_band_indices(i0, rows, width, height, aa_samples, device):
    """Flat (pixel-major, see ops.raygen) ray indices of image rows [i0,
    i0 + rows): r = (i * W + j) * S + s."""
    s = aa_samples * aa_samples
    ri = (i0 + torch.arange(rows, dtype=torch.int64, device=device))[:, None, None] * (width * s)
    ci = torch.arange(width, dtype=torch.int64, device=device)[None, :, None] * s
    si = torch.arange(s, dtype=torch.int64, device=device)[None, None, :]
    return (ri + ci + si).reshape(-1)


def _local_renderer(spec, width, height, cfg, mode, backend, device):
    """The band renderer of backends "jnp" and "pallas" (render.py:96-136):
    (arrays, camera, i0, rows) -> image f32[rows, W, 3], raygen, march and
    shading in torch, differentiable with respect to the parameters and the
    camera (tensors)."""
    from ..ops.cuda_march import make_march_pallas
    from ..ops.march import _arrays_on, _gamma, _make_albedo_fn, make_march, make_march_soft, shade, shade_soft
    from ..ops.raygen import raygen_flat
    from ..ops.sdf import make_scene_fn

    scene = make_scene_fn(spec, cfg)
    soft = mode == "soft"
    if backend == "pallas":
        if soft:
            # ROADMAP §3 fault 13: the reference's step unpacks four outputs
            # of this three-output march here.
            raise ValueError("pallas backend supports modes 'forward'/'implicit'")
        march = make_march_pallas(spec, cfg, device=device)
    elif soft:
        march = make_march_soft(spec, cfg)
    elif mode == "forward":
        raise ValueError("mode 'forward' carries no gradient through the march: train with 'implicit', "
                         "'unrolled' or 'soft'")
    else:
        march = make_march(spec, cfg, mode)
    albedo_fn = _make_albedo_fn(spec, cfg)
    s = cfg.aa_samples * cfg.aa_samples

    def render_band(arrays, camera, i0, rows):
        idx = _row_band_indices(i0, rows, width, height, cfg.aa_samples, device)
        origins, dirs = raygen_flat(idx, camera.position, camera.rotation, width, height, cfg)
        a = _arrays_on(arrays, origins)
        if soft:
            t, hit, s_min, t_min = march(origins, dirs, a)
            color = shade_soft(scene, origins, dirs, t, hit, s_min, t_min, a, cfg, albedo_fn)
        else:
            t, hit, _ = march(origins, dirs, a)
            color = shade(scene, origins, dirs, t, hit, a, cfg, albedo_fn)
        return _gamma(color).reshape(rows, width, s, 3).mean(dim=2)

    render_band.backward_info = {
        "kind": "pallas_fwd_jnp_vjp" if backend == "pallas" else f"jnp_{mode}",
        "compact": False,
        "reason": None,
    }
    return render_band


@dataclasses.dataclass
class FitOptState:
    """The optimizers of a fit and the tensors they update: `params` =
    [leaf_params, op_param], and with `fit_camera` also `cam_params` =
    [position, rotation]."""

    params: list
    optimizer: torch.optim.Optimizer
    cam_params: Optional[list] = None
    cam_optimizer: Optional[torch.optim.Optimizer] = None

    def state_dict(self) -> dict:
        return {
            "optimizer": self.optimizer.state_dict(),
            "cam_optimizer": None if self.cam_optimizer is None else self.cam_optimizer.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if (state["cam_optimizer"] is None) != (self.cam_optimizer is None):
            raise ValueError("the state and this fit disagree on fit_camera")
        if self.cam_optimizer is not None:
            self.cam_optimizer.load_state_dict(state["cam_optimizer"])


def _on(x, device) -> torch.Tensor:
    """`x` (numpy or a tensor) as an f32 tensor on `device`, detached."""
    if torch.is_tensor(x):
        if x.device != device:
            raise ValueError(f"a fit input is on {x.device}, expected {device}")
        return x.detach().to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _one_device(mesh):
    """`mesh` may be None or hold one device; more is ROADMAP §1 item 7."""
    if mesh is None:
        return
    n = len(mesh) if hasattr(mesh, "__len__") else getattr(mesh, "size", 1)
    if n != 1:
        raise NotImplementedError(
            f"a fit over {n} devices is not ported yet (ROADMAP: §1 item 7, multi-device)"
        )


def make_fit_step(
    spec: TapeSpec,
    width: int,
    height: int,
    mesh=None,
    optimizer=None,
    cfg: RenderConfig = DEFAULT_CONFIG,
    mode: str = "implicit",
    backend: str = "jnp",
    fit_camera: bool = False,
    grad_mask=None,
    interpret: bool = False,
    camera_optimizer=None,
    row_interleave: int = 1,
    *,
    device="cuda",
):
    """Build the training step of inverse rendering on `device`:

        step(arrays, camera, opt_state, target[H, W, 3]) ->
            (new_arrays, new_camera, opt_state, loss)

    The loss is sum((img - target)^2) / (H * W * 3), a 0-d tensor on the
    device (reading it is the caller's one synchronisation per step). The
    gradient runs through `backend` "pallas_fused", "jnp" or "pallas"
    (the module docstring). `grad_mask` = (leaf
    mask, op mask), 1.0 = trainable, multiplies the gradients before the
    optimizer. With `fit_camera`, the pose is trained by `camera_optimizer`
    (default SGD, lr 1e-2) and the rotation is projected back to unit norm
    after each update; `init_opt_state` then takes the camera too. The
    returned arrays and camera hold tensors on the device.
    """
    del interpret  # the Pallas interpreter: no effect on the ported kernels
    _one_device(mesh)
    if int(row_interleave) != 1:
        raise NotImplementedError(
            "row_interleave is not ported yet (ROADMAP: §1 item 7, multi-device)"
        )
    if backend not in ("pallas_fused", "jnp", "pallas"):
        raise ValueError(f"backend {backend!r} cannot be differentiated")
    if backend == "pallas_fused" and mode not in ("implicit", "soft"):
        raise ValueError("pallas_fused backend supports 'implicit'/'soft'")
    dev = resolve_device(device)
    if optimizer is None:
        raise ValueError("make_fit_step needs an optimizer factory, e.g. "
                         "functools.partial(torch.optim.Adam, lr=1e-2)")
    if fit_camera and camera_optimizer is None:
        camera_optimizer = functools.partial(torch.optim.SGD, lr=1e-2)
    if backend == "pallas_fused":
        fused = make_fused_render_vjp(spec, cfg, width, height, soft=mode == "soft", device=dev)

        def render(a, camera):
            return fused(a, cam_vec(camera, 0.0, device=dev))

        render.backward_info = fused.backward_info
    else:
        band = _local_renderer(spec, width, height, cfg, mode, backend, dev)

        def render(a, camera):
            return band(a, camera, 0, height)

        render.backward_info = band.backward_info
    denom = float(height * width * 3)
    masks = None
    if grad_mask is not None:
        masks = tuple(_on(m, dev) for m in grad_mask)

    def step(arrays: TapeArrays, camera, opt_state: FitOptState, target):
        lp = _on(arrays.leaf_params, dev).requires_grad_(True)
        opp = _on(arrays.op_param, dev).requires_grad_(True)
        a = dataclasses.replace(arrays, leaf_params=lp, op_param=opp)
        cam = camera
        if fit_camera:
            pos = _on(camera.position, dev).requires_grad_(True)
            rot = _on(camera.rotation, dev).requires_grad_(True)
            cam = Camera(position=pos, rotation=rot)
        img = render(a, cam)
        loss = torch.sum((img - _on(target, dev)) ** 2) / denom
        inputs = (lp, opp, pos, rot) if fit_camera else (lp, opp)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = tuple(torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs))
        g_leaf, g_op = grads[0], grads[1]
        if masks is not None:
            # Restrict the fit to the selected parameters (adaptive
            # optimizers otherwise take full-size steps along noise
            # directions of parameters the user never meant to move).
            g_leaf = g_leaf * masks[0]
            g_op = g_op * masks[1]
        with torch.no_grad():
            for p, src, g in zip(opt_state.params, (lp, opp), (g_leaf, g_op)):
                p.copy_(src)
                p.grad = g
        opt_state.optimizer.step()
        new_arrays = dataclasses.replace(
            arrays,
            leaf_params=opt_state.params[0].detach().clone(),
            op_param=opt_state.params[1].detach().clone(),
        )
        new_camera = camera
        if fit_camera:
            with torch.no_grad():
                for p, src, g in zip(opt_state.cam_params, (pos, rot), grads[2:]):
                    p.copy_(src)
                    p.grad = g
            opt_state.cam_optimizer.step()
            with torch.no_grad():
                new_pos, q = (p.detach().clone() for p in opt_state.cam_params)
                # Project the rotation back onto the unit quaternions.
                q = q / torch.clamp_min(torch.linalg.norm(q), 1e-8)
            new_camera = Camera(position=new_pos, rotation=q)
        return new_arrays, new_camera, opt_state, loss.detach()

    def init_opt_state(arrays: TapeArrays, camera=None) -> FitOptState:
        params = [_on(arrays.leaf_params, dev).clone().requires_grad_(True),
                  _on(arrays.op_param, dev).clone().requires_grad_(True)]
        state = FitOptState(params=params, optimizer=optimizer(params))
        if fit_camera:
            if camera is None:
                raise ValueError("init_opt_state needs the camera when fit_camera=True")
            state.cam_params = [_on(camera.position, dev).clone().requires_grad_(True),
                                _on(camera.rotation, dev).clone().requires_grad_(True)]
            state.cam_optimizer = camera_optimizer(state.cam_params)
        return state

    step.init_opt_state = init_opt_state
    # Which backward this step trains through, and why the fast O(active)
    # one was skipped (pallas_grad.py:1887-1895); fit_scene logs it.
    step.backward_info = render.backward_info
    step.device = dev
    return step
