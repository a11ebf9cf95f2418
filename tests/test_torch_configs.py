"""The five BASELINE configs on the port (`raymarch_tpu_torch.examples.
configs`), on the CPU at small sizes, against the JAX package.

tests/test_configs.py's checks, plus the JAX renderer on the same scene:
each config's scene is built once with the port, and the JAX package
renders its wire tape (`rm.compile_wire(rt.encode_wire(scene))`: the two
encoders give bit-identical tapes, tests/test_torch_tape.py) through
`raymarch_tpu.make_renderer` at the same size, the CPU's "jnp" renderer of
both packages, in the exact-semantics class (max|d| < 1e-3). Config 1 is
also held against the port's f64 oracle (tests/test_configs.py:30-36),
config 3 must recover the blend's centre within 0.1 and halve its loss,
config 4 must give 24 distinct, finite frames under one TapeSpec, and
config 5's sharded frame and distributed step run on a world of one.
"""

import numpy as np
import torch

import jax

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu_torch.examples import configs

torch.set_num_threads(1)

W, H = 64, 48


def _check_image(img):
    img = np.asarray(img)
    assert img.ndim == 3 and img.shape[2] == 3
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # something visible was rendered


def _jax_frame(wire, cam, width, height, cfg=None, static=False):
    """The JAX package's jnp frame of a wire tape."""
    spec, arrays = rm.compile_wire(wire, static=static)
    cfg = rm.DEFAULT_CONFIG if cfg is None else rm.RenderConfig(**{f: getattr(cfg, f) for f in
                                                                 cfg.__dataclass_fields__})
    render = rm.make_renderer(spec, width, height, cfg, mode="forward")
    return np.asarray(jax.jit(render)(arrays, rm.Camera(cam.position, cam.rotation)))


def test_config1_sphere_plane_oracle(capsys):
    img = configs.config1("cpu", width=W, height=W)
    out = capsys.readouterr().out
    # config1 prints its oracle check; enforce it here too.
    err = float(out.split("max abs err vs oracle (64^2):")[1].split()[0])
    assert err < 1e-3
    _check_image(img)
    scene, cam = configs.config1_scene()
    ref = _jax_frame(rt.encode_wire(scene), cam, W, W)
    assert np.abs(img - ref).max() < 1e-3


def test_config2_csg_mix():
    img = configs.config2("cpu", width=W, height=H)
    _check_image(img)
    scene, cam = configs.config2_scene()
    ref = _jax_frame(rt.encode_wire(scene), cam, W, H, static=True)
    assert np.abs(img - ref).max() < 1e-3


def test_config3_fit_smooth_blend():
    res = configs.config3("cpu")  # the published 48x48, 60 steps
    # Truths are cx = -0.5, k = 0.4; the run starts at cx = -0.62, k = 0.15.
    cx = float(res.arrays.leaf_params[0, 4])
    assert abs(cx - (-0.5)) < 0.1
    assert res.losses[-1] < res.losses[0] * 0.5
    assert res.backward_info["kind"] == "jnp_implicit"


def test_config4_animated_runtime_edits(capsys):
    stride = 4  # the published 64-pixel stride would leave one pixel of a small frame
    checks = configs.config4("cpu", width=W, height=H, check_stride=stride)
    assert len(checks) == 24 and np.isfinite(checks).all()
    assert len(set(checks)) == 24  # every frame differs
    out = capsys.readouterr().out
    assert "one TapeSpec and one renderer" in out
    # Frame 0 through the JAX package.
    g, s = configs.config4_graph()
    cam = configs.config4_frame(g, s, rt.OrbitCameraController(target=(0, 0, 0), radius=4.5), 0)
    ref = _jax_frame(rt.encode_wire(g.evaluate_root()), cam, W, H, static=True)
    assert abs(checks[0] - float(ref[::stride, ::stride].mean())) < 1e-3


def test_config5_sharded_64_primitives(capsys):
    img = configs.config5("cpu", width=W, height=H, fit_size=16)
    _check_image(img)
    out = capsys.readouterr().out
    assert "over {'rays': 1}" in out  # a world of one
    loss = float(out.split("distributed fit step loss=")[1].split()[0])
    assert np.isfinite(loss) and loss > 0
    tape, cam = configs.config5_tape()
    ref = _jax_frame(tape, cam, W, H, cfg=rt.RenderConfig(aa_samples=2, max_iter=64), static=True)
    assert np.abs(img - ref).max() < 1e-3


def test_cli_picks_configs_and_device(monkeypatch, capsys):
    """`python -m raymarch_tpu_torch.examples.configs [1-5|all] [--cpu]`
    (the configs stubbed: their published sizes take minutes on the CPU)."""
    calls = []
    for k in configs.CONFIGS:
        monkeypatch.setitem(configs.CONFIGS, k, lambda device, k=k: calls.append((k, device)))
    assert configs.main(["3", "--cpu"]) == 0
    assert configs.main(["all"]) == 0
    assert calls == [("3", "cpu")] + [(k, "cuda") for k in "12345"]
    assert capsys.readouterr().out.count("=== config") == 6
