"""Profiling helpers: a device trace, and the timing harness of the rays/s
numbers.

Port of `raymarch_tpu/utils/profiling.py` (21-53) on torch.profiler. The
timing protocol is the reference's: best of `iters` calls after `warmup`,
each fenced by reading a scalar of every output on the host. A CUDA output
is first fenced with `torch.cuda.synchronize()` on its device, so the time
covers the kernels the call queued, not only their launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a trace of the host's torch operations, and of the card's
    kernels when CUDA is available, into a Chrome trace file under
    `log_dir` (default `raymarch_tpu_torch_trace` in the temporary
    directory; open it in Perfetto or chrome://tracing):

        with profiling.trace("traces"): render(...)

    Yields `log_dir`; the file, `trace.<pid>.<ns>.json`, is written when the
    block ends."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "raymarch_tpu_torch_trace")
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
