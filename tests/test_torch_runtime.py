"""The port's tiered runtime (`raymarch_tpu_torch.runtime.TieredRenderer`).

Case by case the tests of tests/test_runtime.py, on the CPU (`device="cpu"`:
the "jnp" backend, and the gated `renderer_factory`), plus the pins of the
port's claims: a parameter edit builds no new renderer, a topology edit
inside the dynamic tape's bucket reuses the dynamic renderer, the kernel
backend ("pallas_prepass", its plain versions here) serves both tiers, and
the runtime leaves every global and environment setting as it found it
(the reference's `persistent_cache` sets JAX's cache directory; the port
compiles nothing per topology, and its `enable_persistent_cache` keeps the
kernel library's directory that is already set).
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

import raymarch_tpu_torch as rt
from raymarch_tpu_torch import _build
from raymarch_tpu_torch.runtime import TieredRenderer

# One torch thread per process (see tests/test_torch_prepass.py).
torch.set_num_threads(1)

CFG = dataclasses.replace(rt.DEFAULT_CONFIG, aa_samples=2, max_iter=60)
W, H = 48, 32

SCENE_A = rt.sphere(center=(0, 0, 0), radius=1.0)
SCENE_B = rt.sphere(center=(0, 0, 0), radius=1.0) | rt.box(center=(1.2, 0, 0), half_extents=(0.4, 0.4, 0.4))
# SCENE_B plus one sphere: a topology edit inside the dynamic bucket.
SCENE_C = SCENE_B | rt.sphere(center=(0.0, 1.3, 0.0), radius=0.3)
CAM = rt.Camera.looking_at(position=(0.0, 1.2, 4.0), target=(0.0, 0.0, 0.0))


def _factory(gate: threading.Event, calls: list, backend="jnp", cfg=CFG):
    """Renderer factory that blocks STATIC-tier builds on `gate` (a slow
    build, so the dynamic tier must serve) and records every build."""

    def factory(spec):
        if spec.static_tape is not None:
            gate.wait(timeout=30.0)
        calls.append(spec)
        return rt.make_renderer(spec, W, H, cfg, mode="forward", backend=backend, device="cpu")

    return factory


class TestSynchronous:
    """background=False: static tiers build inline, deterministic."""

    @pytest.fixture()
    def tiered(self):
        return TieredRenderer(W, H, CFG, backend="jnp", background=False, device="cpu")

    def test_first_frame_compiles_static_and_serves_it(self, tiered):
        img = tiered.render(SCENE_A, CAM)
        assert isinstance(img, np.ndarray) and img.shape == (H, W, 3)
        assert tiered.tier == "static"
        assert tiered.static_compiles == 1

    def test_param_edit_stays_static_no_recompile(self, tiered):
        tiered.render(SCENE_A, CAM)
        img2 = tiered.render(rt.sphere(center=(0, 0, 0), radius=1.3), CAM)
        assert tiered.tier == "static"
        assert tiered.static_compiles == 1  # same TapeSpec: buffer swap only
        img1 = tiered.render(SCENE_A, CAM)
        assert np.abs(img1 - img2).max() > 1e-3  # the edit was visible

    def test_topology_edit_compiles_new_tier_and_caches(self, tiered):
        tiered.render(SCENE_A, CAM)
        tiered.render(SCENE_B, CAM)
        assert tiered.static_compiles == 2
        # Revisiting topology A is instant (cached tier, no new build).
        tiered.render(SCENE_A, CAM)
        assert tiered.static_compiles == 2
        assert tiered.tier == "static"

    def test_empty_scene(self, tiered):
        img = tiered.render(None, CAM)
        assert np.isfinite(img).all()


class TestBackground:
    def test_dynamic_serves_until_static_ready_then_switches(self):
        gate = threading.Event()
        calls = []
        tiered = TieredRenderer(W, H, CFG, background=True, renderer_factory=_factory(gate, calls), device="cpu")
        img_dyn = tiered.render(SCENE_B, CAM)
        assert tiered.tier == "dynamic"  # static build still gated
        assert tiered.dynamic_frames == 1
        # More frames while the build is "running" stay dynamic and do not
        # spawn duplicate builds.
        tiered.render(SCENE_B, CAM)
        assert tiered.tier == "dynamic"
        gate.set()
        assert tiered.wait(timeout=60.0)
        img_sta = tiered.render(SCENE_B, CAM)
        assert tiered.tier == "static"
        assert [s.static_tape is not None for s in calls] == [False, True]
        # The tier switch is visually seamless: same scene, same camera.
        assert np.abs(img_dyn - img_sta).max() < 1e-4

    def test_stats_shape(self):
        gate = threading.Event()
        gate.set()
        tiered = TieredRenderer(W, H, CFG, background=True, renderer_factory=_factory(gate, []), device="cpu")
        tiered.render(SCENE_A, CAM)
        tiered.wait(timeout=60.0)
        s = tiered.stats()
        assert s["frames"] == 1
        assert s["pending_compiles"] == 0
        assert s["static_cached"] == 1


class TestNoRebuild:
    """The live path's pins: edits that keep a TapeSpec build nothing."""

    def test_parameter_edit_builds_no_new_renderer(self):
        gate = threading.Event()
        calls = []
        tiered = TieredRenderer(W, H, CFG, background=True, renderer_factory=_factory(gate, calls), device="cpu")
        tiered.render(SCENE_B, CAM)  # dynamic tier built, static tier gated
        moved = rt.sphere(center=(0, 0.2, 0), radius=0.9) | rt.box(center=(1.1, 0, 0), half_extents=(0.5, 0.4, 0.4))
        tiered.render(moved, CAM)
        assert len(calls) == 1 and tiered.tier == "dynamic"
        gate.set()
        assert tiered.wait(timeout=60.0)
        n = len(calls)
        img = tiered.render(moved, CAM)
        img_b = tiered.render(SCENE_B, CAM)
        assert tiered.tier == "static" and len(calls) == n == 2
        assert np.abs(img - img_b).max() > 1e-3

    def test_topology_edit_in_bucket_reuses_dynamic_renderer(self):
        gate = threading.Event()
        calls = []
        tiered = TieredRenderer(W, H, CFG, background=True, renderer_factory=_factory(gate, calls), device="cpu")
        img_b = tiered.render(SCENE_B, CAM)
        dynamic = dict(tiered._dynamic)
        img_c = tiered.render(SCENE_C, CAM)  # one more sphere: same dynamic TapeSpec
        assert tiered.tier == "dynamic" and tiered._dynamic == dynamic
        assert [s.static_tape is None for s in calls] == [True]
        assert np.abs(img_c - img_b).max() > 1e-3  # the new sphere shows at once
        gate.set()
        assert tiered.wait(timeout=60.0)

    def test_kernel_backend_serves_both_tiers(self):
        """The default backend of the port's live path, "pallas_prepass"
        (its plain versions on the CPU): the dynamic tier runs the DYN
        builds' interpreter, the static tier the static tape, and the two
        frames agree in bench.py's dynamic-tape class."""
        cfg = dataclasses.replace(CFG, bound_accel=True, exit_check_every=4)
        gate = threading.Event()
        calls = []
        tiered = TieredRenderer(W, H, cfg, background=True,
                                renderer_factory=_factory(gate, calls, "pallas_prepass", cfg), device="cpu")
        img_dyn = tiered.render(SCENE_B, CAM)
        assert tiered.tier == "dynamic"
        assert calls[0].static_tape is None
        gate.set()
        assert tiered.wait(timeout=60.0)
        img_sta = tiered.render(SCENE_B, CAM)
        assert tiered.tier == "static"
        d = np.abs(img_dyn - img_sta)
        assert d.mean() < 5e-4 and (d.max(-1) > 1e-2).mean() < 0.008

    def test_default_backend_follows_the_device(self):
        assert TieredRenderer(W, H, CFG, device="cpu").backend == "jnp"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                TieredRenderer(W, H, CFG)


class TestViewerIntegration:
    def test_viewer_tiered_mode(self):
        from raymarch_tpu_torch.viewer import ViewerApp

        app = ViewerApp(width=W, height=H, cfg=CFG, backend="jnp", tiered=True, device="cpu")
        img0 = app.frame()
        assert img0.shape == (H, W, 3)
        assert app.state()["tier"] in ("dynamic", "static")
        # Converge to the static tier and re-render.
        assert app._tiered.wait(timeout=120.0)
        img1 = app.frame()
        assert app.state()["tier"] == "static"
        assert np.abs(img0 - img1).max() < 1e-4

    def test_viewer_default_single_tier_on_jnp(self):
        from raymarch_tpu_torch.viewer import ViewerApp

        app = ViewerApp(width=W, height=H, cfg=CFG, backend="jnp", device="cpu")
        app.frame()
        assert app.state()["tier"] == "single"


def _settings():
    """Every global and environment setting a runtime could touch."""
    return dict(
        environ=dict(os.environ),
        cwd=os.getcwd(),
        sys_path=list(sys.path),
        threads=torch.get_num_threads(),
        dtype=torch.get_default_dtype(),
        matmul=torch.get_float32_matmul_precision(),
        tf32=(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32),
        deterministic=torch.are_deterministic_algorithms_enabled(),
        grad=torch.is_grad_enabled(),
        build_dir=str(_build.BUILD_DIR),
        builds=_build.stats["builds"],
    )


class TestPersistentCache:
    """The reference's `persistent_cache` points JAX's compilation cache at a
    directory (utils/cache.py, ROADMAP §3 fault 3). The port's tiers
    compile nothing per topology; the keyword calls the port's
    `enable_persistent_cache()`, which keeps the kernel library's directory
    already in place and changes no setting: fault 3 is repaired by
    construction."""

    @pytest.mark.parametrize("persistent_cache", [True, False])
    def test_leaves_every_setting_as_it_found_it(self, persistent_cache):
        before = _settings()
        tiered = TieredRenderer(W, H, CFG, backend="jnp", background=False, persistent_cache=persistent_cache,
                                device="cpu")
        tiered.render(SCENE_A, CAM)
        assert _settings() == before

    def test_background_tiers_leave_settings(self):
        before = _settings()
        tiered = TieredRenderer(W, H, CFG, backend="jnp", device="cpu")
        tiered.render(SCENE_B, CAM)
        assert tiered.wait(timeout=60.0)
        tiered.render(SCENE_B, CAM)
        assert tiered.tier == "static"
        assert _settings() == before


def test_build_load_runs_once_across_threads(monkeypatch):
    """The tiered runtime's foreground and background threads may both make
    a process's first launch: `_build.load` builds and loads the library
    once and hands every thread the same one (a check-then-act without the
    lock would build twice and publish two libraries)."""
    import time

    calls, got = [], []

    def slow_load():
        calls.append(threading.get_ident())
        time.sleep(0.02)  # a build that takes a while
        _build._lib = object()
        return _build._lib

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_load_locked", slow_load)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(_build.load())) for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == len(threads) and all(g is got[0] for g in got)
