"""Row-sharded rendering and the fit step for inverse rendering.

Port of `raymarch_tpu/parallel/render.py` on `torch.distributed`, one
process per device (parallel/mesh.py). The semantics are the reference's
(render.py:1-13): image rows are sharded over the ranks, each rank renders
whole pixels with all their AA samples (the AA mean never crosses ranks),
the scene and the camera are replicated, and the only communication is the
fit step's reduction of gradients and loss, and the gather of the sharded
image. `make_sharded_renderer` and `make_fit_step` take the reference's
arguments in its order, plus the keyword-only `device`; `interpret` (the
Pallas interpreter) has no effect here.

Backends: "pallas_prepass" (the forward kernels K1, K2 per band),
"pallas_fused" (the fused forward K1, K2 and the backward K8 or K9 per
band), and, as `_local_renderer`'s non-fused branch (render.py:96-136),
"jnp" (the torch march in mode "forward", "implicit", "unrolled" or
"soft") and "pallas" (K5's march with the implicit-function VJP), whose
band is raygen + march + shading in torch. The reference's "pallas" fit
step crashes in soft mode (ROADMAP §3 fault 13); the port raises the
ValueError of its `make_renderer` instead.

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
returns it. Every rank applies its optimizer to the same reduced sums, so
the replicas stay equal.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..ops.cuda_grad import make_fused_render_vjp
from ..ops.cuda_prepass import COARSE_TILE, FINE_TILE, resolve_device
from ..ops.tape import TapeArrays, TapeSpec
from ..utils import profiling
from ..utils.camera import Camera, cam_vec
from .mesh import Mesh, all_reduce_sum, make_mesh, require_member


def _row_band_indices(i0, rows, width, height, aa_samples, device):
    """Flat (pixel-major, see ops.raygen) ray indices of image rows [i0,
    i0 + rows): r = (i * W + j) * S + s."""
    s = aa_samples * aa_samples
    ri = (i0 + torch.arange(rows, dtype=torch.int64, device=device))[:, None, None] * (width * s)
    ci = torch.arange(width, dtype=torch.int64, device=device)[None, :, None] * s
    si = torch.arange(s, dtype=torch.int64, device=device)[None, None, :]
    return (ri + ci + si).reshape(-1)


def _band_cam_vec(camera, i0, device) -> torch.Tensor:
    """The camera vector of the band that starts at image row `i0`
    (render.py:47-54): position, rotation, i0."""
    return cam_vec(camera, float(i0), device=device)


def _local_renderer(spec, width, height, cfg, mode, backend, device, rows_per):
    """This rank's band renderer (render.py:57-137): (arrays, camera, i0,
    rows) -> image f32[rows, W, 3] of image rows [i0, i0 + rows).

    "pallas_prepass" runs the cone-prepass kernels K1 and K2 (K4 with
    `cfg.aa_shared_normals`) per band, forward only; "pallas_fused" the
    fused forward (K1, K2 with residuals) and its backward (K8, or K9 for a
    compact plan) per band. Both are built for bands of `rows_per` rows and
    read the band's first row from the camera vector, so one renderer
    serves every band. "jnp" (the torch march in `mode`) and "pallas"
    (K5's march, the implicit-function VJP) run raygen, march and shading
    in torch on the band's rays, differentiable with respect to the
    parameters and the camera (tensors)."""
    from ..ops.cuda_march import make_march_pallas
    from ..ops.cuda_prepass import make_pallas_image_render_aa
    from ..ops.march import _arrays_on, _gamma, _make_albedo_fn, make_march, make_march_soft, shade, shade_soft
    from ..ops.raygen import raygen_flat
    from ..ops.sdf import make_scene_fn

    band_rows = None if rows_per == height else rows_per  # a whole frame shares make_renderer's renderer
    if backend in ("pallas_prepass", "pallas_fused"):
        if backend == "pallas_prepass":
            band = make_pallas_image_render_aa(spec, cfg, width, height, device=device, prepass_block=1,
                                               band_rows=band_rows, aa_packed=not cfg.aa_shared_normals)
            info = {"kind": "forward_only", "compact": False, "reason": None}
        else:
            band = make_fused_render_vjp(spec, cfg, width, height, band_rows=band_rows, soft=mode == "soft",
                                         device=device)
            info = band.backward_info

        def render_band_fused(arrays, camera, i0, rows):
            return band(arrays, _band_cam_vec(camera, i0, device))

        render_band_fused.backward_info = info
        return render_band_fused

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


def _rows_per(height: int, n_bands: int, cfg: RenderConfig) -> int:
    """Rows of each of the image's `n_bands` bands: ceil(H / n_bands), as
    the reference's (render.py:171), rounded up with `cfg.leaf_cull` to a
    multiple of the culling tiles' rows. A band's tiles start at its first
    row; aligned, they are the whole frame's tiles, so a culled band gets
    the frame's item lists and renders exactly the frame's rows. (Other
    tiles hold other lists, whose distance field the relaxed march follows
    to other stops: on an H100 at 1920x1080, 270-row bands moved the
    64-sphere step's gradients by 9% of max|g| from the whole frame's.)"""
    rows = -(-height // n_bands)
    if cfg.leaf_cull:
        tile = math.lcm(COARSE_TILE, FINE_TILE)  # the coarse tiles at prepass_block 1, and the fine tiles
        rows = -(-rows // tile) * tile
    return rows


def _bands(mesh: Mesh, k: int, rows_per: int, height: int):
    """(first row, rows inside the image) of this rank's bands: band b = d
    + j n of the image's n k bands of `rows_per` rows, for j < k (rank d of
    n). A band that starts past the last row holds nothing of the image
    and is left out; the last band may reach past it (the reference pads H
    to rows_per n k, render.py:171)."""
    n = mesh.size
    out = []
    for j in range(k):
        i0 = (mesh.rank + j * n) * rows_per
        if i0 < height:
            out.append((i0, min(rows_per, height - i0)))
    return out


def _mesh_of(mesh, device, what) -> Mesh:
    """`mesh`, or `make_mesh(device=device)` for None; a `device` that is
    not the mesh's, or a rank outside the mesh, raises ValueError."""
    if mesh is None:
        return make_mesh(device=device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a raymarch_tpu_torch.parallel.Mesh (make_mesh), got {type(mesh).__name__}")
    require_member(mesh, what)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device!r} is not the mesh's device {mesh.device}")
    return mesh


def make_sharded_renderer(
    spec: TapeSpec,
    width: int,
    height: int,
    mesh: Optional[Mesh] = None,
    cfg: RenderConfig = DEFAULT_CONFIG,
    mode: str = "forward",
    backend: str = "jnp",
    interpret: bool = False,
    row_interleave: int = 1,
    *,
    device=None,
):
    """`render(arrays, camera) -> image f32[H, W, 3]`, row-sharded over the
    mesh's ranks (render.py:141-205), on every rank.

    The scene and camera are replicated. On a mesh of part of the world
    (make_mesh(n), 1 < n < the world) the mesh's n ranks do all of this
    among themselves, over its group; a rank outside it gets ValueError
    here, before any collective. `row_interleave` = k splits the
    image into n k contiguous bands of ceil(H / n k) rows (with
    `cfg.leaf_cull` a multiple of the culling tiles' 16 rows: `_rows_per`),
    and rank d renders bands d, d + n, ..., d + (k - 1) n: each rank gets a
    spread of sky-heavy and scene-centre rows (the load balance of the
    straggler band), while each launch keeps a contiguous band, so the
    per-tile cones and culling lists keep their locality; k launches per
    rank a frame.
    The bands are gathered to the whole image on every rank, in image
    order: each rank writes its bands into a zero frame and one all_reduce
    sums the frames (a gather on any backend, gloo's CUDA tensors
    included; exact, since each pixel is one rank's value plus zeros).

    Forward only (no autograd graph): the fit step carries the gradients.
    `mesh` None is `make_mesh(device=device)`; `interpret` (the Pallas
    interpreter) has no effect."""
    del interpret
    mesh = _mesh_of(mesh, device, "make_sharded_renderer")
    k = max(1, int(row_interleave))
    rows_per = _rows_per(height, mesh.size * k, cfg)
    render_band = _local_renderer(spec, width, height, cfg, mode, backend, mesh.device, rows_per)
    bands = _bands(mesh, k, rows_per, height)

    @profiling.framed
    def render(arrays: TapeArrays, camera):
        dev = mesh.device
        with torch.no_grad():
            # The pose goes up once a frame: a pageable upload waits for the
            # kernels queued before it, so one a band would keep the host
            # from running ahead. The parameters stay as given: numpy ones
            # take frame_args's host bound, which costs the host less than
            # the torch form's launches.
            with profiling.span("upload"):
                cam = Camera(position=_on(camera.position, dev), rotation=_on(camera.rotation, dev))
            img = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
            for i0, rows in bands:
                with profiling.span("band", row=i0):
                    img[i0 : i0 + rows] = render_band(arrays, cam, i0, rows_per)[:rows]
            with profiling.span("gather"):
                return all_reduce_sum(img, mesh)

    render.backward_info = render_band.backward_info
    render.bands = bands
    return render


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
    return profiling.uploaded(torch.as_tensor(x, dtype=torch.float32, device=device))


def make_fit_step(
    spec: TapeSpec,
    width: int,
    height: int,
    mesh: Optional[Mesh] = None,
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
    device=None,
):
    """Build the training step of inverse rendering over the mesh's ranks
    (render.py:208-372):

        step(arrays, camera, opt_state, target[H, W, 3]) ->
            (new_arrays, new_camera, opt_state, loss)

    Each rank renders its bands (`row_interleave` = k of them, as
    `make_sharded_renderer` assigns them) and sums their squared error over
    the image's rows, / (H W 3): a band's rows past the image carry no
    cotangent. One all_reduce of one flat f32 buffer (the leaf, op and
    camera gradients and the loss) sums them over the ranks, and every rank
    applies the same optimizer to the same sums. The loss is a 0-d tensor
    on the device (reading it is the caller's one synchronisation per
    step). The gradient runs through `backend` "pallas_fused", "jnp" or
    "pallas" (the module docstring). `grad_mask` = (leaf mask, op mask),
    1.0 = trainable, multiplies the gradients before the optimizer. With
    `fit_camera`, the pose is trained by `camera_optimizer` (default SGD,
    lr 1e-2) and the rotation is projected back to unit norm after each
    update; `init_opt_state` then takes the camera too. The returned arrays
    and camera hold tensors on the rank's device. `mesh` None is
    `make_mesh(device=device)` (`device` default "cuda"); with a mesh,
    `device` may only repeat the mesh's. A rank outside a mesh of part of
    the world gets ValueError here, before any collective.
    """
    del interpret  # the Pallas interpreter: no effect on the ported kernels
    if backend not in ("pallas_fused", "jnp", "pallas"):
        raise ValueError(f"backend {backend!r} cannot be differentiated")
    if backend == "pallas_fused" and mode not in ("implicit", "soft"):
        raise ValueError("pallas_fused backend supports 'implicit'/'soft'")
    if mode == "forward":
        raise ValueError("mode 'forward' carries no gradient through the march: train with 'implicit', "
                         "'unrolled' or 'soft'")
    if optimizer is None:
        raise ValueError("make_fit_step needs an optimizer factory, e.g. "
                         "functools.partial(torch.optim.Adam, lr=1e-2)")
    mesh = _mesh_of(mesh, device, "make_fit_step")
    dev = mesh.device
    if fit_camera and camera_optimizer is None:
        camera_optimizer = functools.partial(torch.optim.SGD, lr=1e-2)
    k = max(1, int(row_interleave))
    rows_per = _rows_per(height, mesh.size * k, cfg)
    render_band = _local_renderer(spec, width, height, cfg, mode, backend, dev, rows_per)
    bands = _bands(mesh, k, rows_per, height)
    denom = float(height * width * 3)
    masks = None
    if grad_mask is not None:
        masks = tuple(_on(m, dev) for m in grad_mask)

    def step(arrays: TapeArrays, camera, opt_state: FitOptState, target):
        lp = _on(arrays.leaf_params, dev).requires_grad_(True)
        opp = _on(arrays.op_param, dev).requires_grad_(True)
        a = dataclasses.replace(arrays, leaf_params=lp, op_param=opp)
        pos = _on(camera.position, dev).requires_grad_(fit_camera)
        rot = _on(camera.rotation, dev).requires_grad_(fit_camera)
        cam = Camera(position=pos, rotation=rot)  # uploaded once a step, not once a band
        inputs = (lp, opp, pos, rot) if fit_camera else (lp, opp)
        tgt = _on(target, dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i0, rows in bands:
            img = render_band(a, cam, i0, rows_per)[:rows]
            loss = loss + torch.sum((img - tgt[i0 : i0 + rows]) ** 2)
        loss = loss / denom
        grads = (None,) * len(inputs)
        if loss.requires_grad:  # this rank holds a band of the image
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
        # The step's one collective: the gradients and the loss in one buffer.
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)]), mesh)
        *grads, loss = flat.split([x.numel() for x in inputs] + [1])
        grads = [g.view_as(x) for g, x in zip(grads, inputs)]
        loss = loss.reshape(())
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
        return new_arrays, new_camera, opt_state, loss

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
    step.backward_info = render_band.backward_info
    step.device = dev
    step.bands = bands
    return step
