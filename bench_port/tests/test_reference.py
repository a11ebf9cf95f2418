"""The plain reference against the port's CPU path at a small size, on both
configurations: the torch reference renderer ("jnp", the same march from
t = 0) to rounding, the timed paths (the cone prepass, the fused
backward's forward) in their class, and the fit's gradients against the
port's implicit-function gradients."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import raymarch_tpu_torch as rt
from bench_port import program as pg
from bench_port import reference as ref
from bench_port import scene as sc

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[2]
W, H = 48, 27


def _config(name):
    with open(ROOT / "bench_port/configs" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name, seed, angle", [("config2", 0, 0.0), ("config2", 0, 1.1), ("spheres64", 7, 0.4),
                                               ("spheres64", 2**31 + 5, 2.0)])
def test_frames_match_the_port(name, seed, angle):
    cfg = _config(name)
    desc = sc.describe(cfg["scene"], seed)
    cam = sc.orbit_camera(cfg["camera"], angle)
    want, work = ref.render(ref.Scene(desc, torch.float32, "cpu"), cam, cfg["render"], W, H)
    assert work.rays == W * H * 16 and work.hits + work.misses == work.rays and work.steps > 0
    spec, arrays = pg.port_scene(desc)
    camera = rt.Camera(position=cam[0], rotation=cam[1])
    rc = pg.render_config(cfg["render"])
    jnp = rt.make_renderer(spec, W, H, rc, mode="forward", backend="jnp", device="cpu")(arrays, camera)
    d = (jnp - want).abs()
    assert float(d.mean()) < 1e-5 and float((d.amax(-1) > 0.1).float().mean()) == 0.0
    fast = rt.make_renderer(spec, W, H, rc, mode="forward", backend="pallas_prepass", device="cpu")(arrays, camera)
    d = (fast - want).abs()
    assert float(d.mean()) < 2e-3


def test_the_published_spheres():
    """Seed 7 draws config 5's published spheres."""
    from raymarch_tpu_torch.examples.configs import config5_tape

    cfg = _config("spheres64")
    tape, _ = config5_tape()
    spec, arrays = pg.port_scene(sc.describe(cfg["scene"], 7))
    spec5, arrays5 = rt.compile_wire(tape, static=True)
    assert spec == spec5 and np.array_equal(arrays.leaf_params, arrays5.leaf_params)


def test_fit_gradients_match_the_port_implicit_gradients():
    cfg = _config("config2")
    truth = sc.describe(cfg["scene"], 0)
    start = sc.perturb(truth, np.random.default_rng(4), 0.05)
    r = cfg["render"]
    cam = sc.orbit_camera(cfg["camera"], 0.0)
    target, _ = ref.render(ref.Scene(truth, torch.float32, "cpu"), cam, r, W, H)
    loss, grads, _ = ref.loss_and_grad(ref.Scene(start, torch.float32, "cpu"), cam, target, r, W, H)
    spec, arrays = pg.port_scene(start)
    slots = pg.leaf_slots(start, arrays.leaf_params)
    lp = torch.tensor(arrays.leaf_params, requires_grad=True)
    a = dataclasses.replace(arrays, leaf_params=lp, op_param=torch.tensor(arrays.op_param))
    img = rt.make_renderer(spec, W, H, pg.render_config(r), mode="implicit", backend="jnp", device="cpu")(
        a, rt.Camera(position=cam[0], rotation=cam[1]))
    port_loss = torch.mean((img - target) ** 2)
    port_loss.backward()
    assert abs(float(port_loss.detach()) - loss) <= 1e-4 * loss
    scale = max(float(g.abs().max()) for g in grads.values())
    for k, (row, cols) in slots.items():
        np.testing.assert_allclose(lp.grad[row, cols].numpy(), grads[k].numpy(), atol=1e-3 * scale)


def test_adam_is_torch_adam():
    p = {"a": torch.tensor([1.0, -2.0, 0.5])}
    mine = ref.Adam(0.01)
    t = torch.tensor([1.0, -2.0, 0.5], requires_grad=True)
    opt = torch.optim.Adam([t], lr=0.01)
    for g in ([0.3, -0.1, 0.0], [0.2, 0.4, -1e-3], [-0.5, 0.1, 2.0]):
        p = mine.step(p, {"a": torch.tensor(g)})
        t.grad = torch.tensor(g)
        opt.step()
    torch.testing.assert_close(p["a"], t.detach(), rtol=0, atol=1e-7)
