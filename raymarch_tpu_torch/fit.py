"""High-level inverse rendering: fit scene parameters to a target image.

Port of `raymarch_tpu/fit.py` (40-179): BASELINE config 3, "smooth-blend
CSG scene with differentiable blend radii; fit primitive params to a target
image via pixel-loss gradients". Wraps the fit step
(parallel.render.make_fit_step) with optimizer set-up, parameter masking,
checkpoints, a stall watchdog and a loop with per-step logging.

Gradient model: mode="implicit" differentiates interior signal only
(implicit-function VJP at hit points plus shading); mode="soft" adds the
silhouette (soft coverage) gradients: each ray's coverage follows its
closest approach, with the envelope-theorem VJP at the frozen argmin. Mask
the fit to the parameters you mean to move: adaptive optimizers otherwise
follow noise directions of untouched parameters.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from .config import DEFAULT_CONFIG, RenderConfig
from .ops.tape import TapeArrays, TapeSpec


@dataclasses.dataclass
class FitResult:
    arrays: TapeArrays
    camera: object
    losses: list
    steps_per_sec: float
    # Which backward the fit trained through (and, when the fast O(active)
    # kernel was skipped, why): make_fit_step's backward_info.
    backward_info: Optional[dict] = None


def fit_scene(
    spec: TapeSpec,
    arrays: TapeArrays,
    camera,
    target,
    *,
    width: int,
    height: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    steps: int = 100,
    learning_rate: float = 1e-2,
    optimizer=None,
    mesh=None,
    leaf_mask: Optional[np.ndarray] = None,
    op_mask: Optional[np.ndarray] = None,
    fit_camera: bool = False,
    camera_optimizer=None,
    mode: str = "implicit",
    backend: str = "jnp",
    log_every: int = 0,
    log_fn: Callable[[str], None] = print,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 25,
    resume: bool = True,
    stall_timeout: Optional[float] = None,
    stall_exit_code: Optional[int] = None,
    device=None,
) -> FitResult:
    """Gradient-descend scene parameters toward a target image over the
    ranks of `mesh`: `mesh=None` builds `make_mesh(device=device)`, the
    process group's ranks when one is initialized, else this process alone
    (a world of one on `device`, default "cuda"; "cpu" runs the plain
    versions). A given mesh decides the device, and `device` may only
    repeat it.

    `optimizer` builds a torch optimizer over a list of tensors (default
    `torch.optim.Adam` at `learning_rate`). `leaf_mask` / `op_mask` (same
    shapes as the parameter arrays, 1.0 = trainable) restrict the fit; None
    trains everything of that group. `backend` is "pallas_fused" (mode
    "implicit" or "soft"), "jnp" ("implicit", "unrolled" or "soft") or
    "pallas" ("implicit": K5's forward, the implicit-function VJP).

    `checkpoint_dir` (storage every rank of the mesh reads) gets an atomic
    checkpoint of the whole fit state every `checkpoint_every` steps,
    written by the mesh's rank 0; with `resume` a restarted job continues
    from the latest one, every rank of the mesh from the step its rank 0
    finds. On a mesh of part of the world (make_mesh(n)) a rank outside it
    gets ValueError before any collective. `stall_timeout` arms a Watchdog
    on step progress, and `stall_exit_code` turns a stall into a hard exit
    for a supervisor to relaunch.

    Each step reads its loss back to the host (`float(loss)`): the one
    synchronisation per step, as in the reference.
    """
    from .parallel import make_fit_step, make_mesh
    from .parallel.elastic import FitCheckpointer, Watchdog
    from .parallel.render import _on
    from .utils.camera import Camera

    if mesh is None:
        mesh = make_mesh(device=device)
    if optimizer is None:
        optimizer = functools.partial(torch.optim.Adam, lr=learning_rate)

    grad_mask = None
    if leaf_mask is not None or op_mask is not None:
        grad_mask = (
            np.ones(np.shape(arrays.leaf_params), np.float32) if leaf_mask is None else leaf_mask,
            np.ones(np.shape(arrays.op_param), np.float32) if op_mask is None else op_mask,
        )

    step = make_fit_step(
        spec,
        width,
        height,
        mesh,
        optimizer,
        cfg,
        mode=mode,
        backend=backend,
        fit_camera=fit_camera,
        camera_optimizer=camera_optimizer,
        grad_mask=grad_mask,
        device=device,
    )
    dev = step.device
    opt_state = step.init_opt_state(arrays, camera if fit_camera else None)
    on_device = functools.partial(_on, device=dev)
    target = on_device(target)

    # Surface which backward this fit trains through: a scene that falls
    # off the O(active) kernel onto the O(n_leaves) legacy one should see
    # that cliff, not meet it silently.
    bwd = step.backward_info
    if log_every:
        msg = f"fit: backward = {bwd['kind']}"
        if bwd.get("reason"):
            msg += f" (fast path skipped: {bwd['reason']})"
        log_fn(msg)

    losses = []
    start = 0
    a, cam = arrays, camera
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = FitCheckpointer(checkpoint_dir, mesh=mesh)
        if resume:
            restored = ckpt.restore(spec, opt_state)
            if restored is not None:
                start, a, cam, opt_state, losses = restored
                log_fn(f"fit: resumed from checkpoint at step {start}")

    # Parameters, pose and target live on the device for the whole loop, so
    # a step uploads nothing.
    a = dataclasses.replace(a, leaf_params=on_device(a.leaf_params), op_param=on_device(a.op_param))
    cam = Camera(position=on_device(cam.position), rotation=on_device(cam.rotation))

    watchdog = (
        Watchdog(stall_timeout, exit_code=stall_exit_code)
        if stall_timeout is not None
        else None
    )

    def _loop():
        nonlocal a, cam, opt_state
        for i in range(start, steps):
            a, cam, opt_state, loss = step(a, cam, opt_state, target)
            losses.append(float(loss))  # device sync: the step completed
            if watchdog is not None:
                watchdog.beat()
            if log_every and (i % log_every == 0 or i == steps - 1):
                log_fn(f"fit step {i:4d}: loss {losses[-1]:.6f}")
            if ckpt is not None and (
                (i + 1) % max(1, checkpoint_every) == 0 or i == steps - 1
            ):
                ckpt.save(i + 1, spec, a, cam, opt_state, losses)

    t0 = time.perf_counter()
    if watchdog is not None:
        with watchdog:
            _loop()
    else:
        _loop()
    elapsed = time.perf_counter() - t0
    done = max(steps - start, 1)
    return FitResult(
        arrays=a,
        camera=cam,
        losses=losses,
        steps_per_sec=done / max(elapsed, 1e-9),
        backward_info=bwd,
    )
