"""The five BASELINE.json validation configs on the port.

Run:  python -m raymarch_tpu_torch.examples.configs [1|2|3|4|5|all] [--cpu]

The port's twin of `examples/configs.py`: the same scenes, cameras, sizes
and checks, through `raymarch_tpu_torch` (no jax). Each config takes
`device` ("cuda", the default, or "cpu") and its sizes as keyword
arguments, whose defaults are the published sizes. On the card they take
the reference's accelerator backends; on the CPU its CPU choices, at its
reduced sizes where it has them (`--cpu`).

1. Single sphere + plane, 256x256, Lambertian, fixed camera, validated
   against the CPU tape oracle at 64x64 (the "jnp" renderer on both).
2. Multi-primitive CSG with painted materials (sphere/box/capsule, union
   and a torus subtracted), 512x512: "pallas_prepass" on the card (the
   cone prepass K1 and the fine kernel K2 with its materials build).
3. Smooth-blend scene with a differentiable blend radius; fit the
   perturbed centre and radius to a target image, 48x48, 60 Adam steps:
   "pallas_fused" on the card (K1, K2 with residuals, the backward K8).
4. Camera fly-through at 1920x1080 (192x108 on the CPU), 24 frames, with
   a node-graph edit every frame recompiled to new tape numbers under one
   TapeSpec, so one renderer serves every frame ("pallas_prepass").
5. 64 random spheres (the native encoder) at 3840x2160 (384x216 on the
   CPU), rendered row-sharded over `make_mesh()` ("pallas_prepass"), and
   one distributed fit step at 64x64 whose gradients are all-reduced.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time

import numpy as np
import torch

from ..ops.cuda_prepass import resolve_device


def ascii_dump(img, step=None):
    chars = " .:-=+*#%@"
    lum = np.asarray(img).mean(axis=-1)
    h = lum.shape[0]
    step = step or max(1, h // 24)
    for row in lum[::step]:
        print(
            "".join(
                chars[min(int(v * (len(chars) - 1) * 1.4), len(chars) - 1)]
                for v in row[:: max(1, step // 2)]
            )
        )


def _on_card(dev: torch.device) -> bool:
    """Whether the configs take the card's backends and sizes."""
    return dev.type == "cuda"


def _host(img) -> np.ndarray:
    """A frame as a numpy array (the reference's configs return numpy)."""
    return img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)


def config1_scene():
    """(scene, camera) of config 1."""
    import raymarch_tpu_torch as rt

    scene = rt.sphere(radius=1.0) | rt.plane(normal=(0, 1, 0), offset=1.5)
    return scene, rt.Camera.looking_at(position=(0.0, 1.0, 4.0), target=(0, 0, 0))


def config2_scene():
    """(scene, camera) of config 2."""
    import raymarch_tpu_torch as rt

    scene = (
        rt.sphere(center=(-0.6, 0, 0), radius=0.9, material=(0.7, 0.2, 0.15))
        | rt.box(center=(0.8, 0, 0), half_extents=(0.5, 0.5, 0.5),
                 material=(0.2, 0.4, 0.8)).rotate_axis_angle((0, 1, 0), 0.5)
        | rt.capsule(center=(0.0, -0.6, 0.9), radius=0.25, half_height=0.4,
                     material=(0.8, 0.7, 0.2))
    ) - rt.torus(center=(0, 0.8, 0), major_radius=0.7, minor_radius=0.25)
    return scene, rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0, 0, 0))


def config3_scene():
    """(scene, camera, cfg) of config 3."""
    import raymarch_tpu_torch as rt

    scene = rt.sphere(center=(-0.5, 0, 0)).union(rt.sphere(center=(0.5, 0, 0)), k=0.4)
    cam = rt.Camera.looking_at(position=(0.0, 0.6, 3.5), target=(0, 0, 0))
    return scene, cam, rt.RenderConfig(aa_samples=2, max_iter=48)


def config4_graph():
    """(graph, the sphere's node) of config 4: a sphere and a box in a
    union under the root."""
    from ..models.graph import CSGNodeGraph

    g = CSGNodeGraph()
    root = g.add_root()
    s = g.add_node("Sphere", center=(-0.6, 0.0, 0.0), radius=0.9)
    b = g.add_node("Box", center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5))
    u = g.add_node("Union")
    g.connect(s, u, "A")
    g.connect(b, u, "B")
    g.connect(u, root, "SDF")
    return g, s


def config4_frame(g, s, ctrl, f):
    """Frame `f`'s edit: the camera orbits, the sphere's radius changes.
    Returns the camera."""
    ctrl.orbit(30.0, 8.0)
    g.set_input(s, "radius", 0.9 + 0.2 * np.sin(f * 0.4))
    return ctrl.camera()


def config5_tape():
    """(wire tape, camera) of config 5: 64 random spheres (seed 7) in one
    hard union, through the native encoder."""
    import raymarch_tpu_torch as rt

    rng = np.random.default_rng(7)
    spheres = np.zeros((64, 4), np.float32)
    spheres[:, :3] = rng.uniform(-3, 3, (64, 3))
    spheres[:, 1] = rng.uniform(-1.0, 1.5, 64)
    spheres[:, 3] = rng.uniform(0.15, 0.5, 64)
    tape = rt.native.build_sphere_union(spheres)  # native encoder fast path
    return tape, rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0, 0, 0))


def config1(device="cuda", *, width=256, height=256, oracle_size=64):
    """Sphere + plane at 256^2, checked against the CPU oracle."""
    import raymarch_tpu_torch as rt

    dev = resolve_device(device)
    scene, cam = config1_scene()
    spec, arrays = rt.compile_scene(scene)
    render = rt.make_renderer(spec, width, height, mode="forward", chunk=1 << 16, device=dev)
    t0 = time.perf_counter()
    img = _host(render(arrays, cam))
    print(f"config1: rendered {width}x{height} in {time.perf_counter() - t0:.2f}s (with set-up)")
    # Oracle check on a subsampled grid (a full-size f64 oracle is slow).
    n = oracle_size
    img_o = rt.oracle.render(rt.encode_wire(scene), cam, n, n)
    sub = _host(rt.make_renderer(spec, n, n, mode="forward", device=dev)(arrays, cam))
    err = np.abs(sub - img_o).max()
    print(f"config1: max abs err vs oracle ({n}^2): {err:.2e}")
    ascii_dump(img)
    return img


def config2(device="cuda", *, width=512, height=512):
    """Multi-primitive CSG at 512^2 with materials (per-primitive albedos)."""
    import raymarch_tpu_torch as rt

    dev = resolve_device(device)
    on_card = _on_card(dev)
    scene, cam = config2_scene()
    spec, arrays = rt.compile_scene(scene, static=True)
    backend = "pallas_prepass" if on_card else "jnp"
    render = rt.make_renderer(spec, width, height, mode="forward", backend=backend,
                              chunk=None if on_card else 1 << 18, device=dev)
    t0 = time.perf_counter()
    img = _host(render(arrays, cam))
    dt = time.perf_counter() - t0
    print(f"config2: {width}x{height} ({backend}) in {dt:.2f}s (incl. set-up)")
    ascii_dump(img)
    return img


def config3(device="cuda", *, width=48, height=48, steps=60):
    """Inverse rendering: recover a perturbed sphere centre and blend
    radius. Returns the FitResult."""
    import raymarch_tpu_torch as rt

    dev = resolve_device(device)
    on_card = _on_card(dev)
    scene, cam, cfg = config3_scene()
    spec, arrays = rt.compile_scene(scene, static=True)
    target = rt.make_renderer(spec, width, height, cfg, mode="forward", device=dev)(arrays, cam).detach()

    lp = arrays.leaf_params.copy()
    lp[0, 4] -= 0.12  # sphere-0 centre x
    op = arrays.op_param.copy()
    ki = int(np.nonzero(op)[0][0])
    op[ki] = 0.15  # blend radius off
    arrays0 = dataclasses.replace(arrays, leaf_params=lp, op_param=op)

    m_leaf = np.zeros_like(lp)
    m_leaf[0, 4] = 1.0
    m_op = np.zeros_like(op)
    m_op[ki] = 1.0

    res = rt.fit_scene(
        spec, arrays0, cam, target,
        width=width, height=height, cfg=cfg, steps=steps, learning_rate=1e-2,
        leaf_mask=m_leaf, op_mask=m_op, log_every=20,
        backend="pallas_fused" if on_card else "jnp", device=dev,
    )
    cx = float(res.arrays.leaf_params[0, 4])
    k = float(res.arrays.op_param[ki])
    print(
        f"config3: cx {lp[0, 4]:+.3f} -> {cx:+.3f} (truth {arrays.leaf_params[0, 4]:+.3f}); "
        f"k {op[ki]:.3f} -> {k:.3f} (truth 0.400); "
        f"loss {res.losses[0]:.5f} -> {res.losses[-1]:.5f}; "
        f"{res.steps_per_sec:.1f} steps/s"
    )
    return res


def config4(device="cuda", *, width=None, height=None, frames=24, check_stride=64):
    """A 1080p fly-through with a scene edit every frame and no rebuild.
    Returns each frame's check: the mean of every `check_stride`-th pixel
    of every `check_stride`-th row."""
    import raymarch_tpu_torch as rt

    dev = resolve_device(device)
    on_card = _on_card(dev)
    if width is None or height is None:
        width, height = (1920, 1080) if on_card else (192, 108)
    backend = "pallas_prepass" if on_card else "jnp"

    g, s = config4_graph()
    spec, arrays = rt.compile_scene(g.evaluate_root(), static=True)
    render = rt.make_renderer(spec, width, height, mode="forward", backend=backend,
                              chunk=None if on_card else 1 << 16, device=dev)
    ctrl = rt.OrbitCameraController(target=(0, 0, 0), radius=4.5)

    t0 = time.perf_counter()
    checks = []
    for f in range(frames):
        camera = config4_frame(g, s, ctrl, f)  # animate the camera, edit the scene
        spec_f, arrays_f = rt.compile_scene(g.evaluate_root(), static=True)
        if spec_f != spec:
            raise AssertionError("an edit must not change the TapeSpec")
        img = render(arrays_f, camera)
        # On the device: the frames queue behind each other.
        checks.append(img[::check_stride, ::check_stride].mean())
    # One read drains the queue (a blocking read a frame would charge the
    # host's round trip to every frame).
    checks = [float(c) for c in checks]
    dt = time.perf_counter() - t0
    rays = width * height * 16 * frames
    print(
        f"config4: {frames} frames at {width}x{height} with live edits in {dt:.2f}s "
        f"({frames / dt:.1f} fps, {rays / dt / 1e6:.0f} Mrays/s), one TapeSpec and one renderer"
    )
    if len(set(np.round(checks, 6))) <= 1:
        raise AssertionError("frames should differ")
    return checks


def config5(device="cuda", *, width=None, height=None, fit_size=64):
    """64 primitives rendered row-sharded over the mesh, then one
    distributed fit step (gradients all-reduced over the ranks)."""
    import raymarch_tpu_torch as rt
    from raymarch_tpu_torch.parallel import make_fit_step, make_mesh, make_sharded_renderer

    dev = resolve_device(device)
    on_card = _on_card(dev)
    tape, cam = config5_tape()
    spec, arrays = rt.compile_wire(tape, static=True)

    mesh = make_mesh(device=dev)
    if width is None or height is None:
        width, height = (3840, 2160) if on_card else (384, 216)
    cfg = rt.DEFAULT_CONFIG if on_card else rt.RenderConfig(aa_samples=2, max_iter=64)
    render = make_sharded_renderer(spec, width, height, mesh, cfg, backend="pallas_prepass" if on_card else "jnp")
    t0 = time.perf_counter()
    img = _host(render(arrays, cam))
    dt = time.perf_counter() - t0
    print(
        f"config5: {width}x{height} 64-primitive render over {mesh.shape} in {dt:.2f}s "
        f"(incl. set-up), finite={bool(np.isfinite(img).all())}"
    )

    # One distributed gradient step (an all_reduce over the mesh).
    small = fit_size
    cfg_fit = rt.RenderConfig(aa_samples=1, max_iter=48)
    target = torch.zeros((small, small, 3), dtype=torch.float32, device=dev)
    step = make_fit_step(spec, small, small, mesh, functools.partial(torch.optim.Adam, lr=1e-2), cfg_fit)
    _, _, _, loss = step(arrays, cam, step.init_opt_state(arrays), target)
    print(f"config5: distributed fit step loss={float(loss):.5f}")
    return img


CONFIGS = {"1": config1, "2": config2, "3": config3, "4": config4, "5": config5}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names = [a for a in argv if not a.startswith("--")]
    which = names[0] if names else "all"
    device = "cpu" if "--cpu" in argv else "cuda"
    for k in CONFIGS if which == "all" else [which]:
        print(f"=== config {k} ===")
        CONFIGS[k](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
