"""The traced window: torch.profiler over a stretch of the same loop, reduced
to what the per-layer metrics read.

The benchmark's own host spans are `record_function` annotations named
"bench.<what>" (camera, enqueue, wait, loss_read); the device events are
every operation the profiler saw on the card (kernels, copies, fills; no
user annotations). Times are the profiler's, in seconds.
"""

from __future__ import annotations

import collections
import dataclasses
import re

from . import yardstick

WINDOW = "bench.window"
NCCL = re.compile(r"(?i)nccl")


@dataclasses.dataclass
class Trace:
    window_s: float  # length of the traced window
    units: int  # frames or steps completed in it
    device: list  # (name, start_s, end_s) of each device operation
    host: list  # (name, start_s, end_s) of each bench.* host span
    start: float
    end: float

    @property
    def busy_s(self) -> float:
        return yardstick.busy([(a, b) for _, a, b in self.device])

    @property
    def compute_busy_s(self) -> float:
        """Busy time without NCCL's kernels, which spin on the card while
        they wait for the other ranks (the gather's own metric holds them)."""
        return yardstick.busy([(a, b) for n, a, b in self.device if not NCCL.search(n)])

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches `pattern`
        (a regular expression), intervals merged."""
        rx = re.compile(pattern)
        return yardstick.busy([(a, b) for n, a, b in self.device if rx.search(n)])

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, each named by the innermost bench.* host span
        open at its middle."""
        by = collections.Counter()
        for name, a, b in self.device:
            by[short(name)] += b - a
        ops = [[k, v] for k, v in by.most_common(n)]
        gaps = yardstick.gaps([(a, b) for _, a, b in self.device], self.start, self.end)
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            open_ = [(h1 - h0, nm) for nm, h0, h1 in self.host if h0 <= mid <= h1]
            idle.append([min(open_)[1] if open_ else "outside the benchmark's spans", b - a])
        return {"device_ops": ops, "idle_gaps": idle}


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


def traced(loop, units_fn, cuda: bool = True, align=None):
    """Run `loop()` under torch.profiler inside a bench.window span and
    reduce the trace; `units_fn()` gives the units completed so far.
    `align()`, where given, runs once the profiler records and before the
    window opens (the ranks of a mesh meet there), so its wait lies outside
    the window. Without `cuda` (the CPU tests) only the host is traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    u0 = units_fn()
    with profile(activities=activities) as prof:
        if align is not None:
            align()
        with record_function(WINDOW):
            loop()
            sync()
    units = units_fn() - u0
    device, host, win = [], [], None
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and b > a:
                device.append((e.name, a, b))
        elif e.name == WINDOW:
            win = (a, b)
        elif e.name.startswith("bench."):
            host.append((e.name[6:], a, b))
    if win is None:
        raise RuntimeError("the profiler recorded no bench.window span")
    device = [(n, max(a, win[0]), min(b, win[1])) for n, a, b in device if b > win[0] and a < win[1]]
    return Trace(win[1] - win[0], units, device, host, win[0], win[1])
