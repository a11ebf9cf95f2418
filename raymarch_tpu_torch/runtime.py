"""Tiered scene execution: instant edits, a warmed static tier per topology.

The port of `raymarch_tpu/runtime.py`. The reference's headline property is
that any scene edit is a buffer write, never a shader recompile (reference
README.md:7; renderer.rs:230-239 rewrites the tape buffer per frame).
`TieredRenderer` serves every frame from the best tier available now:

- **Dynamic tier** (always available): the dynamic tape
  (`compile_scene(scene)`), interpreted by the kernels' DYN builds. A
  topology edit within the tape's bucket keeps the `TapeSpec`, so the next
  frame renders through the same renderer at once.
- **Static tier** (per topology): the static tape of the scene. The first
  frame of a new topology builds and warms its renderer, on a background
  thread by default; once warmed it serves the frames of that topology.
  Parameter, material and camera edits never leave the static tier (buffer
  swaps in both tiers).

In the reference a static tier is an XLA program that compiles for seconds,
which is why the dynamic tier exists. Here every tier runs the same kernel
library, built once per process by the digest of its sources
(`_build.load`), so a static tier's set-up is building a renderer object
and one warm-up frame, and no tier compiles anything. The tiers are kept
because their frames differ in speed: the static builds interpret the
static tape, the DYN builds the bucket-padded dynamic one (PERF.md).
Static tiers are cached per `TapeSpec`, so revisiting a topology (undo,
toggling a node) is instant.
"""

from __future__ import annotations

import atexit
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from .config import DEFAULT_CONFIG, RenderConfig
from .ops.tape import compile_scene

# Live tier threads across all TieredRenderer instances, joined at
# interpreter exit so that no thread is killed in the middle of a frame
# on the card.
_LIVE_THREADS: list = []
_LIVE_LOCK = threading.Lock()


def _drain_threads_at_exit():  # pragma: no cover - exit path
    with _LIVE_LOCK:
        threads = list(_LIVE_THREADS)
    for t in threads:
        t.join(timeout=600.0)


atexit.register(_drain_threads_at_exit)


def to_numpy(img) -> np.ndarray:
    """A renderer's frame (a tensor on any device, or an array) as numpy."""
    if hasattr(img, "detach"):
        return img.detach().cpu().numpy()
    return np.asarray(img)


class TieredRenderer:
    """Render scenes through the best available execution tier.

    Parameters
    ----------
    width, height : image size.
    cfg : RenderConfig shared by both tiers.
    backend : `ops.march.make_renderer` backend for both tiers (default:
        "pallas_prepass", the cone-prepass kernels, on the card; "jnp" only
        when the caller asks for the CPU, the reference's heuristic keyed on
        the device asked for).
    chunk, interpret : passed to `make_renderer` (`interpret` has no effect).
    background : build and warm static tiers on a daemon thread (default).
        False builds them inside `render`, the deterministic mode of the
        tests.
    renderer_factory : optional override `(spec) -> fn(arrays, camera)`
        replacing make_renderer entirely (tests inject gated factories).
    persistent_cache : call `utils.cache.enable_persistent_cache()` (the
        default), which keeps the kernel library's directory if one was
        chosen, else takes $RAYMARCH_TPU_CACHE_DIR or the default
        `build/raymarch_tpu_torch/`. The port compiles no per-topology
        program (its kernel library is built once, by digest), so that
        directory is the whole cache; no torch setting and no environment
        variable is touched.
    device : "cuda" (the default) or "cpu" (the kernels' plain versions);
        "cuda" without a GPU raises RuntimeError.

    Frames come back as numpy arrays f32[H, W, 3], as the reference's do.

    Thread model: `render` may be called from one thread at a time (the
    viewer's frame lock). Background builds touch only per-spec slots
    guarded by `_lock` and publish completed tiers atomically. Both threads
    launch on the device's default stream, so their kernels run in turn.
    """

    def __init__(
        self,
        width: int,
        height: int,
        cfg: RenderConfig = DEFAULT_CONFIG,
        backend: Optional[str] = None,
        chunk: Optional[int] = None,
        background: bool = True,
        interpret: bool = False,
        renderer_factory: Optional[Callable[[Any], Any]] = None,
        persistent_cache: bool = True,
        *,
        device="cuda",
    ):
        from .ops.cuda_prepass import resolve_device

        if persistent_cache:
            from .utils.cache import enable_persistent_cache

            enable_persistent_cache()
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.cfg = cfg
        if backend is None:
            backend = "pallas_prepass" if self.device.type == "cuda" else "jnp"
        self.backend = backend
        self.chunk = chunk
        self.background = background
        self.interpret = interpret
        self._factory = renderer_factory
        self._lock = threading.Lock()
        # One gate serialises static-tier builds, so that rapid topology
        # edits warm one tier at a time behind the foreground's frames.
        self._compile_gate = threading.Lock()
        # spec -> render fn. Dynamic tiers are built on demand; static tiers
        # appear here only once built AND warmed.
        self._dynamic: Dict[Any, Any] = {}
        self._static: Dict[Any, Any] = {}
        self._pending: Dict[Any, threading.Thread] = {}
        # Telemetry.
        self.frames = 0
        self.dynamic_frames = 0
        self.static_compiles = 0
        self.last_tier = "none"

    # -- tier construction ---------------------------------------------------

    def _build(self, spec):
        if self._factory is not None:
            return self._factory(spec)
        from .ops.march import make_renderer

        return make_renderer(
            spec,
            self.width,
            self.height,
            self.cfg,
            mode="forward",
            backend=self.backend,
            chunk=self.chunk,
            interpret=self.interpret,
            device=self.device,
        )

    def _dynamic_for(self, spec):
        rnd = self._dynamic.get(spec)
        if rnd is None:
            rnd = self._build(spec)
            self._dynamic[spec] = rnd
        return rnd

    def _compile_static(self, spec, arrays, camera):
        """Build + warm the static tier for `spec`, then publish it.

        The warm-up frame runs the tier once (the kernel library's first
        load, the renderer's uploads) and waits for it, so the first static
        frame served to a user is full speed. Runs on the calling thread
        (synchronous mode) or a daemon thread.
        """
        try:
            with self._compile_gate:
                rnd = self._build(spec)
                to_numpy(rnd(arrays, camera))  # runs and waits for the frame
        except Exception:  # pragma: no cover - surfaced via telemetry
            with self._lock:
                self._pending.pop(spec, None)
            raise
        with self._lock:
            self._static[spec] = rnd
            self._pending.pop(spec, None)
            self.static_compiles += 1

    def _kick_static(self, spec, arrays, camera):
        with self._lock:
            if spec in self._static or spec in self._pending:
                return
            if not self.background:
                self._pending[spec] = None  # claimed; released in _compile
            else:
                t = threading.Thread(
                    target=self._compile_static,
                    args=(spec, arrays, camera),
                    daemon=True,
                    name="raymarch-static-tier",
                )
                self._pending[spec] = t
                with _LIVE_LOCK:
                    _LIVE_THREADS[:] = [lt for lt in _LIVE_THREADS if lt.is_alive()]
                    _LIVE_THREADS.append(t)
                t.start()
                return
        self._compile_static(spec, arrays, camera)

    # -- public API ------------------------------------------------------------

    def render(self, scene, camera) -> np.ndarray:
        """Render `scene` (CSG node or None) from `camera` via the best
        available tier; kicks off a static build for new topologies as a
        side effect."""
        spec_s, arrays_s = compile_scene(scene, static=True)
        with self._lock:
            static_rnd = self._static.get(spec_s)
        self.frames += 1
        if static_rnd is not None:
            self.last_tier = "static"
            return to_numpy(static_rnd(arrays_s, camera))
        if not self.background:
            self._kick_static(spec_s, arrays_s, camera)  # builds inline
            with self._lock:
                static_rnd = self._static.get(spec_s)
            self.last_tier = "static"
            return to_numpy(static_rnd(arrays_s, camera))
        # Serve THIS frame from the dynamic tier before kicking the static
        # build, so that the frame does not queue behind the warm-up.
        spec_d, arrays_d = compile_scene(scene)
        img = to_numpy(self._dynamic_for(spec_d)(arrays_d, camera))
        self.last_tier = "dynamic"
        self.dynamic_frames += 1
        self._kick_static(spec_s, arrays_s, camera)
        return img

    @property
    def tier(self) -> str:
        """Tier that served the most recent frame."""
        return self.last_tier

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every in-flight static build finishes. Returns False
        if `timeout` elapsed with builds still pending."""
        while True:
            with self._lock:
                threads = [t for t in self._pending.values() if t is not None]
            if not threads:
                return True
            for t in threads:
                t.join(timeout)
                if timeout is not None and t.is_alive():
                    return False

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            pending = len(self._pending)
            cached = len(self._static)
        return {
            "frames": self.frames,
            "dynamic_frames": self.dynamic_frames,
            "static_compiles": self.static_compiles,
            "static_cached": cached,
            "pending_compiles": pending,
            "last_tier": self.last_tier,
        }
