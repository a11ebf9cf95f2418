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
from raymarch_tpu_torch.ops import cuda_grad as cg
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
    # Every backend is ported (the "jnp", "pallas", "pallas_image" and
    # "pallas_full" ones: tests/test_torch_march.py, tests/
    # test_torch_surfaces*.py); each raises the reference's ValueError for a
    # mode it does not take (march.py:405-435, 468-469, 489-490).
    spec = frame[0]
    mode = {"jnp": "nope", "pallas": "unrolled", "pallas_fused": "forward"}.get(backend, "implicit")
    with pytest.raises(ValueError, match="mode|implicit|forward-only"):
        rt.make_renderer(spec, W, H, CFG, mode=mode, backend=backend, device="cpu")
    with pytest.raises(ValueError):
        rt.make_renderer(spec, W, H, CFG, mode="forward", backend="nope", device="cpu")


def test_prepass_backend_is_forward_only(frame):
    # The reference's ValueError (march.py:440-441).
    with pytest.raises(ValueError, match="forward"):
        rt.make_renderer(frame[0], W, H, CFG, mode="implicit", backend="pallas_prepass", device="cpu")


@pytest.mark.parametrize(
    "kw,cfg_kw,exc",
    [
        # prepass_block, prepass_chain, n_intervals, band_rows and relax > 1
        # are ported (tests/test_torch_interval.py); these cases keep their
        # ids and take the combinations that still raise: the reference's
        # ValueErrors (pallas_prepass.py:638-641), a band of no rows and
        # more intervals than the kernels keep.
        (dict(prepass_block=4, prepass_chain=True, n_intervals=2), {}, ValueError),
        (dict(prepass_chain=True, no_prepass=True), {}, ValueError),
        (dict(n_intervals=2, no_prepass=True), {}, ValueError),
        # soft is ported (tests/test_torch_soft.py); without no_prepass it
        # raises the reference's ValueError (pallas_prepass.py:642-656).
        (dict(soft=True), {}, ValueError),
        # march_only is ported (tests/test_torch_surfaces.py); with soft it
        # raises the reference's ValueError (pallas_prepass.py:637).
        (dict(march_only=True, soft=True, no_prepass=True), {}, ValueError),
        (dict(band_rows=0), {}, ValueError),
        # The unpacked fine pass K4 is ported (tests/test_torch_unpacked.py):
        # aa_packed=False and aa_shared_normals render (None below).
        (dict(aa_packed=False), {}, None),
        # Any n_intervals renders (tests/test_torch_interval.py): five at
        # relax 1.6 against the JAX frame ("jax" below).
        (dict(n_intervals=cp.MAX_NI + 1), dict(relax=1.6), "jax"),
        # leaf_cull and soft culling are ported (tests/test_torch_cull.py,
        # tests/test_torch_soft.py); soft with relax > 1 raises the
        # reference's ValueError.
        (dict(soft=True, no_prepass=True), dict(leaf_cull=True, relax=1.6), ValueError),
        ({}, dict(aa_shared_normals=True), None),
    ],
    ids=["block4", "chain", "intervals", "soft", "march_only", "band_rows",
         "unpacked", "relax", "leaf_cull", "shared_normals"],
)
def test_unported_options_raise(frame, kw, cfg_kw, exc):
    cfg = dataclasses.replace(CFG, **cfg_kw)
    if exc == "jax":
        from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as render_aa_j

        spec_j, arrays_j = rm.compile_scene(SCENES["config2"](rm), static=True)
        cv = np.asarray(rt.cam_vec(frame[3], device="cpu"))
        ref = render_aa_j(spec_j, dataclasses.replace(CFG_J, **cfg_kw), W, H, interpret=True, bm_coarse=8,
                          aa_packed=True, prepass_block=1, **kw)(arrays_j, cv)
        img = cp.make_pallas_image_render_aa(frame[0], cfg, W, H, device="cpu", **kw)(
            frame[1], rt.cam_vec(frame[3], device="cpu"))
        _assert_gate_class(img.numpy(), np.asarray(ref))
        return
    if exc is None:  # ported: the call renders, through K4
        rp = cp.make_pallas_image_render_aa(frame[0], cfg, W, H, device="cpu", **kw)
        assert rp.params.unpacked and rp.params.shared_normals == cfg.aa_shared_normals
        img = rp(frame[1], rt.cam_vec(frame[3], device="cpu"))
        assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
        assert float((img - frame[4]).abs().mean()) < 5e-3
        return
    with pytest.raises(exc, match="ROADMAP" if exc is NotImplementedError else None):
        cp.make_pallas_image_render_aa(frame[0], cfg, W, H, device="cpu", **kw)


@pytest.mark.parametrize("what", ["dynamic", "materials"])
def test_unported_scenes_raise(what):
    if what == "dynamic":
        # The dynamic tape in K1/K2 is ported (tests/test_torch_dynamic.py):
        # it renders the static frame of the same scene, in bench.py's class
        # of its dynamic-tape gate (bench.py:273-276): the dynamic spec's
        # scene bound keeps its bank's padding rows, as the reference's does
        # (pallas_march.py:1228-1240), so the rays start elsewhere.
        spec, arrays = rt.compile_scene(SCENES["config2"](rt), static=False)
        cam = rt.Camera.looking_at(position=POS, target=TARGET)
        img = rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")(arrays, cam)
        spec_s, arrays_s = rt.compile_scene(SCENES["config2"](rt), static=True)
        ref = rt.make_renderer(spec_s, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")(
            arrays_s, cam)
        _assert_gate_class(img.numpy(), ref.numpy())
        return
    # The painted forward is ported (tests/test_torch_blend.py), and so is
    # the legacy backward's albedo words, which a painted scene without
    # leaf_cull takes (tests/test_torch_legacy.py).
    spec, arrays = rt.compile_scene(SCENES["painted_transformed"](rt), static=True)
    img = rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")(
        arrays, rt.Camera.looking_at(position=POS, target=TARGET))
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    fused = rt.make_renderer(spec, W, H, CFG, mode="implicit", backend="pallas_fused", device="cpu")
    assert (fused.backward_info["kind"], fused.backward_info["reason"]) == (
        "pallas_legacy_unrolled", "leaf_cull disabled")


def test_cuda_device_raises_without_gpu(frame):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.make_renderer(frame[0], W, H, CFG, mode="forward", backend="pallas_prepass", device="cuda")


def test_device_is_required(frame):
    """`device` defaults to the card: without a GPU, leaving it out raises
    naming CUDA, and never renders on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the machine without one")
    spec = frame[0]
    entry_points = (
        lambda: rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass"),
        lambda: rt.make_renderer(spec, W, H, CFG, mode="soft", backend="pallas_fused"),
        lambda: cp.make_pallas_image_render_aa(spec, CFG, W, H),
        lambda: cg.make_fused_render_vjp(spec, CFG, W, H),
        lambda: rt.make_fit_step(spec, W, H, optimizer=torch.optim.SGD, cfg=CFG, backend="pallas_fused"),
        lambda: rt.fit_scene(spec, frame[1], rt.Camera.looking_at(position=POS, target=TARGET),
                             np.zeros((H, W, 3), np.float32), width=W, height=H, cfg=CFG, steps=1,
                             backend="pallas_fused"),
    )
    for call in entry_points:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


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
