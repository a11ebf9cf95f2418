"""Profiling helpers: the renderers' spans and counters, a device trace, and
the timing harness of the rays/s numbers.

Spans. While a torch.profiler session records (`trace()` below, or any
profiler an operator starts), the renderers mark their host work with
spans. Each is a `record_function` range named `rmt.<name>`, so it lies in
the profiler's trace on the same clock as the card's kernels and copies
(an idle gap of the card shows which span the host was in), and an
in-memory `Span` record that `spans()` returns:

- `rmt.frame`: one call of a renderer that `make_renderer` or
  `make_sharded_renderer` returned (the outermost only: a sharded frame
  is one frame, not one a band); it carries the launches and `h2d_bytes`
  its work added;
- `rmt.band`: one band of the sharded frame, with its first row;
- `rmt.upload`: the host-to-device work of a frame (the camera vector,
  the scene's parameters and bound, the sharded frame's pose);
- `rmt.cull`: the culling masks and lists of a culled frame;
- `rmt.launch.<wrapper>`: a kernel's launch wrapper (its checks, output
  allocation, argument packing and the launch call; on the CPU the plain
  version it runs instead);
- `rmt.gather`: the sharded frame's all_reduce, as the host queues it.

While no profiler records, a span site costs one check of the profiler's
state and records nothing. On or off, a span adds no synchronization,
device work or allocation to a frame, and reads nothing from the card.

Counters. `counters()` gives every launch count of the kernels' wrappers
(the `launches`-style attributes each wrapper carries) and `h2d_bytes`,
the bytes the frames' upload sites sent to the card. They are plain
integer adds on the host, always on.

The timing protocol of `time_fn` is the reference's
(`raymarch_tpu/utils/profiling.py` 21-53): best of `iters` calls after
`warmup`, each fenced by reading a scalar of every output on the host. A
CUDA output is first fenced with `torch.cuda.synchronize()` on its device,
so the time covers the kernels the call queued, not only their launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

# True while a torch.profiler (or autograd profiler) session records.
_recording = torch._C._autograd._profiler_enabled
_record_function = torch.profiler.record_function


@dataclasses.dataclass
class Span:
    """One span of host work: `rmt.<name>` from `start_ns` to `end_ns`
    (time.perf_counter_ns), inside the span at index `parent` of `spans()`
    (None at the top), in the frame numbered `frame` (None outside any
    frame). `attrs`: a band's first `row`; a frame's `launches` and
    `h2d_bytes`, the counters' growth over it."""

    name: str
    start_ns: int
    end_ns: int = 0
    parent: Optional[int] = None
    frame: Optional[int] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


_SPANS: list = []
_local = threading.local()  # each thread's open spans (indices into _SPANS)
_next_frame = 0
_COUNTED: list = []  # (module, wrapper, names of its counts)
_h2d_bytes = 0


def _open() -> list:
    stack = _local.__dict__.get("stack")
    if stack is None:
        stack = _local.stack = []
    return stack


def _launches() -> int:
    return sum(getattr(fn, n) for _, fn, names in _COUNTED for n in names)


class _Off:
    """The span of a site while no profiler records: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "is_frame", "index", "rf", "c0")

    def __init__(self, name: str, attrs: dict, is_frame: bool = False):
        self.name, self.attrs, self.is_frame = name, attrs, is_frame

    def __enter__(self):
        global _next_frame
        stack = _open()
        parent = stack[-1] if stack else None
        frame = _SPANS[parent].frame if parent is not None else None
        if self.is_frame:
            frame, _next_frame = _next_frame, _next_frame + 1
            self.c0 = (_launches(), _h2d_bytes)
        self.index = len(_SPANS)
        _SPANS.append(Span(self.name, time.perf_counter_ns(), parent=parent, frame=frame, attrs=self.attrs))
        stack.append(self.index)
        self.rf = _record_function("rmt." + self.name)
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        rec = _SPANS[self.index]
        rec.end_ns = time.perf_counter_ns()
        _open().pop()
        if self.is_frame:
            rec.attrs["launches"] = _launches() - self.c0[0]
            rec.attrs["h2d_bytes"] = _h2d_bytes - self.c0[1]
        return False


def span(name: str, **attrs):
    """`with span("upload"): ...` records the block as `rmt.<name>` while a
    profiler records; otherwise it does nothing."""
    if not _recording():
        return _OFF
    return _Span(name, attrs)


def frame():
    """The span of one renderer call, `rmt.frame`: recorded only while a
    profiler records and no frame of this thread is open already."""
    if not _recording():
        return _OFF
    stack = _open()
    if any(_SPANS[i].name == "frame" for i in stack):
        return _OFF
    return _Span("frame", {}, is_frame=True)


def spanned(name: str):
    """Decorator: every call of the function is a span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _recording():
                return fn(*args, **kw)
            with _Span(name, {}):
                return fn(*args, **kw)

        return call

    return wrap


def framed(fn):
    """Decorator: every call of the function is a frame (`frame`)."""

    @functools.wraps(fn)
    def call(*args, **kw):
        if not _recording():
            return fn(*args, **kw)
        with frame():
            return fn(*args, **kw)

    return call


def spans() -> list:
    """The spans recorded since the last `reset()`, in the order they
    opened (a span's `parent` is an index into this list)."""
    return list(_SPANS)


def reset() -> None:
    """Drop the recorded spans (between frames: an open span's record goes
    too)."""
    _SPANS.clear()


def count_launches(module: str, fn, names) -> None:
    """Put the counts `names` of the launch wrapper `fn` (attributes of
    it) into `counters()` as `<module>.<wrapper>.<name>`."""
    _COUNTED.append((module, fn, tuple(names)))


def uploaded(t: torch.Tensor) -> torch.Tensor:
    """Adds the bytes of `t`, just uploaded from the host, to `h2d_bytes`
    when it lies on the card; returns `t`."""
    global _h2d_bytes
    if t.device.type != "cpu":
        _h2d_bytes += t.nbytes
    return t


def counters() -> dict:
    """{"<module>.<wrapper>.<count>": launches} of every counted launch
    wrapper, and "h2d_bytes"."""
    out = {f"{m}.{fn.__name__}.{n}": getattr(fn, n) for m, fn, names in _COUNTED for n in names}
    out["h2d_bytes"] = _h2d_bytes
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a trace of the host's torch operations and the renderers'
    `rmt.*` spans, and of the card's kernels when CUDA is available, into a
    Chrome trace file under `log_dir` (default: a new directory under the
    temporary directory, made for this call; open the file in Perfetto or
    chrome://tracing):

        with profiling.trace("traces"): render(...)

    Yields `log_dir`; the file, `trace.<pid>.<ns>.json`, is written when the
    block ends."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="raymarch_tpu_torch_trace.")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def _leaves(out):
    """The tensors and arrays of `out` (nested tuples, lists, dicts and
    dataclasses such as TapeArrays, Camera or FitResult)."""
    if isinstance(out, (tuple, list)):
        for x in out:
            yield from _leaves(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _leaves(x)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _leaves(getattr(out, f.name))
    elif out is not None:
        yield out


def _force(out) -> None:
    """Wait for `out`: synchronize the card of every CUDA tensor, then read
    one scalar of every output on the host."""
    for leaf in _leaves(out):
        if torch.is_tensor(leaf):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            leaf.detach().reshape(-1)[:1].cpu()
        else:
            np.asarray(leaf).ravel()[:1]


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Best-of-`iters` wall time of `fn(*args)`, after `warmup` calls, each
    fenced by `_force`; returns seconds per call."""
    for _ in range(warmup):
        _force(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _force(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times)


def rays_per_second(fn: Callable, n_rays: int, *args, **kw) -> float:
    return n_rays / time_fn(fn, *args, **kw)
