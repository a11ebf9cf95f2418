"""The port's main path end to end: make_renderer(backend="pallas_prepass").

The headline configuration (BASELINE config 2, bound_accel, exit check every
4 steps, 4x4 AA) at a small size, through the port's public entry point on
the CPU, against the JAX renderer (Pallas in interpret mode) and the NumPy
oracle, in the tolerance class of the bench's on-device gate for the
accelerated paths (bench.py:220-253).
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu_torch import _build
from raymarch_tpu_torch.ops import cuda_prepass as cp

from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores (the
# small ops of the plain versions then run ~10x slower).
torch.set_num_threads(1)

W, H = 64, 36
CFG_J = dataclasses.replace(rm.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
CFG = rt.RenderConfig(**dataclasses.asdict(CFG_J))
POS, TARGET = (0.0, 1.6, 4.2), (0.0, 0.0, 0.0)
REPO = Path(__file__).resolve().parent.parent


def _neigh_diff(img, ref):
    """Per-pixel min of |img - ref| over ref's 3x3 neighbourhood (bench.py
    _neigh_diff): absorbs half-pixel silhouette shifts, keeps structural
    errors."""
    h, w, _ = img.shape
    best = np.full((h, w), np.inf, np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = slice(max(0, dy), h + min(0, dy))
            xs = slice(max(0, dx), w + min(0, dx))
            ys2 = slice(max(0, -dy), h + min(0, -dy))
            xs2 = slice(max(0, -dx), w + min(0, -dx))
            dd = np.abs(img[ys, xs] - ref[ys2, xs2]).max(-1)
            best[ys, xs] = np.minimum(best[ys, xs], dd)
    return best


def _assert_gate_class(img, ref):
    # Conservative accelerators (cone prepass): grazing AA samples may flip
    # hit/miss, so bound the mean and the share of pixels that stay off by
    # more than 1e-2 after a 3x3 neighbour match.
    d = np.abs(img - ref)
    frac = float((_neigh_diff(img, ref) > 0.01).mean())
    assert d.mean() < 5e-4 and frac < 0.008, (d.mean(), d.max(), frac)


@pytest.fixture(scope="module")
def frame():
    spec, arrays = rt.compile_scene(SCENES["config2"](rt), static=True)
    render = rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")
    cam = rt.Camera.looking_at(position=POS, target=TARGET)
    img = render(arrays, cam)
    return spec, arrays, render, cam, img


def test_main_path_matches_jax_and_oracle(frame):
    *_, img = frame
    assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    img = img.numpy()
    assert np.isfinite(img).all()
    scene = SCENES["config2"](rm)
    spec_j, arrays_j = rm.compile_scene(scene, static=True)
    cam_j = rm.Camera.looking_at(position=POS, target=TARGET)
    render_j = rm.make_renderer(
        spec_j, W, H, CFG_J, mode="forward", backend="pallas_prepass", interpret=True
    )
    _assert_gate_class(img, np.asarray(render_j(arrays_j, cam_j)))
    _assert_gate_class(img, rm.oracle.render(rm.encode_wire(scene), cam_j, W, H, CFG_J))


def test_runtime_edit_reuses_renderer(frame):
    spec, _, render, cam, img = frame
    spec2, arrays2 = rt.compile_scene(SCENES["config2"](rt).translate((0.3, 0.0, 0.0)), static=True)
    assert spec2 == spec
    misses = cp._cached_renderer.cache_info().misses
    builds = _build.stats["builds"]
    render2 = rt.make_renderer(spec2, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")
    assert render2 is render
    assert cp._cached_renderer.cache_info().misses == misses
    img2 = render2(arrays2, cam)
    assert _build.stats["builds"] == builds
    assert (img2 - img).abs().max() > 0.1  # the geometry moved


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_image", "pallas_full", "pallas_fused"])
def test_unported_backends_raise(frame, backend):
    spec = frame[0]
    if backend == "pallas_fused":
        # Ported; like the reference (march.py:468-469) it has no forward mode.
        with pytest.raises(ValueError, match="implicit"):
            rt.make_renderer(spec, W, H, CFG, mode="forward", backend=backend, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rt.make_renderer(spec, W, H, CFG, mode="forward", backend=backend, device="cpu")
    with pytest.raises(ValueError):
        rt.make_renderer(spec, W, H, CFG, mode="forward", backend="nope", device="cpu")


def test_prepass_backend_is_forward_only(frame):
    with pytest.raises(NotImplementedError, match="forward"):
        rt.make_renderer(frame[0], W, H, CFG, mode="implicit", backend="pallas_prepass", device="cpu")


@pytest.mark.parametrize(
    "kw,cfg_kw",
    [
        (dict(prepass_block=4), {}),
        (dict(prepass_chain=True), {}),
        (dict(n_intervals=2), {}),
        (dict(soft=True), {}),
        (dict(march_only=True), {}),
        (dict(band_rows=16), {}),
        (dict(aa_packed=False), {}),
        # relax > 1 and leaf_cull are ported (tests/test_torch_cull.py); what
        # stays unported of them is the relaxed march inside near intervals
        # and soft culling.
        (dict(n_intervals=2), dict(relax=1.6)),
        (dict(soft=True), dict(leaf_cull=True)),
        ({}, dict(aa_shared_normals=True)),
    ],
    ids=["block4", "chain", "intervals", "soft", "march_only", "band_rows",
         "unpacked", "relax", "leaf_cull", "shared_normals"],
)
def test_unported_options_raise(frame, kw, cfg_kw):
    cfg = dataclasses.replace(CFG, **cfg_kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cp.make_pallas_image_render_aa(frame[0], cfg, W, H, device="cpu", **kw)


@pytest.mark.parametrize("what", ["dynamic", "materials"])
def test_unported_scenes_raise(what):
    if what == "dynamic":
        spec, _ = rt.compile_scene(SCENES["config2"](rt), static=False)
    else:
        spec, _ = rt.compile_scene(SCENES["painted_transformed"](rt), static=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")


def test_cuda_device_raises_without_gpu(frame):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.make_renderer(frame[0], W, H, CFG, mode="forward", backend="pallas_prepass", device="cuda")


def test_device_is_required(frame):
    with pytest.raises(TypeError):
        rt.make_renderer(frame[0], W, H, CFG, mode="forward", backend="pallas_prepass")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import raymarch_tpu_torch, raymarch_tpu_torch.ops.cuda_prepass, raymarch_tpu_torch.ops.cuda_grad\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.')"
        " or m == 'raymarch_tpu' or m.startswith('raymarch_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'jax' in before or 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_package_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|raymarch_tpu)(\s|\.|$)", re.M)
    files = sorted((REPO / "raymarch_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
