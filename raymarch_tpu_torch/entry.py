"""Entry points: a forward render of the flagship scene, and a
multi-rank dry run of the distributed training step.

The port's twin of `__graft_entry__.py`.

entry(device) -> (fn, example_args): the forward render on the flagship
pipeline (CSG scene -> tape -> sphere-trace march -> shading) at 128x128.

dryrun_multichip(n_devices): starts a gloo world of n processes, one rank
each, and runs one sharded frame and the full distributed training step
(row-sharded rays, all-reduced gradients) on tiny shapes, then the
"pallas_fused" step (the cone prepass and the fused backward per band).

Run:  python -m raymarch_tpu_torch.entry [n] [--cpu]
"""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

# The package's parent: a rank process imports the package from there.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 600


def flagship_scene():
    """The flagship scene: a smooth union, a subtraction and a rotated box
    over the floor plane."""
    import raymarch_tpu_torch as rt

    return (
        (
            rt.sphere(center=(-0.6, 0.0, 0.0), radius=0.9)
            | rt.box(center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5)).rotate_axis_angle((0, 1, 0), 0.6)
        ).union(rt.torus(center=(0.0, 0.9, 0.0), major_radius=0.7, minor_radius=0.22), k=0.25)
        - rt.sphere(center=(0.0, 0.3, 0.8), radius=0.45)
    ) | rt.plane(normal=(0, 1, 0), offset=1.5)


def _flagship(cfg=None):
    import raymarch_tpu_torch as rt

    if cfg is None:
        cfg = rt.RenderConfig(aa_samples=2, max_iter=64)
    spec, arrays = rt.compile_scene(flagship_scene())
    cam = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    return spec, arrays, cam, cfg


def entry(device="cuda"):
    """The forward render: fn(arrays, camera) -> image[H, W, 3] on
    `device`, and its example arguments."""
    import raymarch_tpu_torch as rt

    width = height = 128
    spec, arrays, cam, cfg = _flagship()
    render = rt.make_renderer(spec, width, height, cfg, mode="forward", device=device)
    return render, (arrays, cam)


def _rank_program(n_devices: int, device: torch.device) -> dict:
    """One rank's part of the dry run, in an initialized process group."""
    import raymarch_tpu_torch as rt
    from raymarch_tpu_torch.parallel import make_fit_step, make_mesh, make_sharded_renderer

    width = height = 32
    cfg = rt.RenderConfig(aa_samples=2, max_iter=24)
    spec, arrays, cam, _ = _flagship(cfg)
    mesh = make_mesh(n_devices, device=device)

    # Sharded forward render.
    img = make_sharded_renderer(spec, width, height, mesh, cfg)(arrays, cam)
    if tuple(img.shape) != (height, width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the sharded frame is {tuple(img.shape)} or not finite")

    # The full distributed training step: row-sharded rays (interleaved
    # bands), all-reduced gradients, the pose trained too.
    optimizer = functools.partial(torch.optim.Adam, lr=1e-2)
    step = make_fit_step(spec, width, height, mesh, optimizer, cfg, mode="implicit", fit_camera=True,
                         row_interleave=2)
    opt_state = step.init_opt_state(arrays, cam)  # fit_camera => pose state too
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    new_arrays, _, opt_state, loss = step(arrays, cam, opt_state, target)
    if not np.isfinite(float(loss)):
        raise AssertionError("the fit step's loss is not finite")
    if np.allclose(new_arrays.leaf_params.cpu().numpy(), arrays.leaf_params):
        raise AssertionError("the fit step did not update the parameters")

    # The fused kernels' path: the sharded cone-prepass forward and the
    # fused backward per row band.
    spec_s, arrays_s = rt.compile_scene(
        rt.sphere(center=(-0.6, 0.0, 0.0), radius=0.9) | rt.box(center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5)),
        static=True,
    )
    step_f = make_fit_step(spec_s, width, height, mesh, optimizer, cfg, backend="pallas_fused")
    _, _, _, loss_f = step_f(arrays_s, cam, step_f.init_opt_state(arrays_s), target)
    if not np.isfinite(float(loss_f)):
        raise AssertionError("the fused fit step's loss is not finite")
    return {"loss": float(loss), "fused_loss": float(loss_f)}


def _rank_main(rank: int, world: int, port: int, device: str) -> int:
    """A rank of the dry run (`python -m raymarch_tpu_torch.entry --rank R
    --world N --port P --device D`): joins the gloo group, runs
    `_rank_program` on its device and prints its losses as a JSON line."""
    import torch.distributed as dist

    from raymarch_tpu_torch.ops.cuda_prepass import resolve_device
    from raymarch_tpu_torch.parallel import initialize_multihost

    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
        dev = resolve_device("cpu")
    else:
        if not torch.cuda.is_available():
            print("entry rank: CUDA is not available", file=sys.stderr)
            return 2
        dev = resolve_device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    # gloo takes CPU and CUDA tensors, and ranks that share a card.
    initialize_multihost(f"localhost:{port}", world, rank, retries=3, retry_delay=1.0, initialization_timeout=120,
                         backend="gloo", device=dev)
    try:
        print(json.dumps(_rank_program(world, dev)), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One distributed fit step over a gloo world of `n_devices` processes
    on tiny shapes (rank r on cuda:{r % device_count()}, or every rank on
    the CPU with device="cpu"). Raises if a rank fails or does not finish
    within RANK_TIMEOUT_S; no rank is left running."""
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip: {n_devices} devices")
    dev = "cpu" if torch.device(device).type == "cpu" else "cuda"
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    procs = [
        subprocess.Popen([sys.executable, "-m", "raymarch_tpu_torch.entry", "--rank", str(r), "--world",
                          str(n_devices), "--port", str(port), "--device", dev],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(n_devices)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip: rank {r} failed (exit code {p.returncode}):\n{out}{err}")
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    print(f"dryrun_multichip({n_devices}): loss={res['loss']:.6f} fused_loss={res['fused_loss']:.6f} OK")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the port's entry points: a forward render, then dryrun_multichip(n)")
    ap.add_argument("n", type=int, nargs="?", help="ranks of the dry run (default: the cards, or 2 with --cpu)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--device", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        return _rank_main(a.rank, a.world, a.port, a.device)
    device = "cpu" if a.cpu else "cuda"
    fn, args = entry(device)
    out = fn(*args)
    print("entry forward:", tuple(out.shape), float(out.mean()))
    n = a.n if a.n is not None else (2 if a.cpu else torch.cuda.device_count())
    dryrun_multichip(n, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
