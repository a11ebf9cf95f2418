"""The traced result line's device time: `device.busy_s` and `window_s` come
from rank 0's one trace, NCCL's kernels left out, so busy never exceeds the
window; and the ranks' meeting before the traced window (`traced`'s
`align`) lies outside it. CPU only, no card."""

import time
import types

import torch

from bench_port import run as bench_run
from bench_port import tracewin


def _part(busy_s, compute_busy_s, window_s):
    return {"busy_s": busy_s, "compute_busy_s": compute_busy_s, "trace_window_s": window_s, "readings": {},
            "failed": 0, "attempted": 10, "memory_peak_bytes": 1, "metrics": {}, "breakdown": {}}


def _summary(trace):
    fake = types.SimpleNamespace(readings={}, failed=0, units=trace.units, memory_peak_bytes=1, reference_s=0.0,
                                 window_s=20.0, trace=trace)
    return bench_run.summarize({"per_layer": []}, fake, True)


def test_busy_and_window_are_rank_0s_when_another_rank_reads_longer():
    """Rank 1's busy time (2.698 s) exceeds rank 0's window (2.378 s), as in
    a 4-card run whose ranks' traces started apart: the line takes rank 0's
    compute busy time and window, and busy stays within the window."""
    parts = [_part(2.31, 2.05, 2.378), _part(2.698, 2.21, 3.035)]
    busy, window = bench_run.device_time(parts)
    assert (busy, window) == (2.05, 2.378)
    assert 0 < busy <= window


def test_the_line_assembles_rank_0s_device_time(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a card")
    monkeypatch.setattr(bench_run, "power_limit_w", lambda: None)
    parts = [_part(2.31, 2.05, 2.378), _part(2.698, 2.21, 3.035), _part(2.5, 2.1, 2.9), _part(2.6, 2.2, 3.1)]
    line = bench_run.assemble({"limits": {}}, parts, True, [])
    assert (line["device"]["busy_s"], line["device"]["window_s"]) == (2.05, 2.378)
    assert line["device"]["count"] == 4 and list(line)[-1] == "checks"
    untraced = bench_run.assemble({"limits": {}}, parts, False, [])
    assert "busy_s" not in untraced["device"] and "breakdown" not in untraced


def test_an_nccl_kernel_is_left_out_of_the_lines_busy_time():
    """A trace that holds NCCL's all_reduce gives the line's busy time
    without it; a single rank without NCCL gives its whole device time,
    what the mean over its one rank gave before."""
    nccl = tracewin.Trace(4.0, 2, [("k", 0.0, 1.0), ("ncclDevKernel_AllReduce_Sum_f32(ncclDevKernelArgs)", 0.5, 3.0)],
                          [], 0.0, 4.0)
    assert bench_run.device_time([_summary(nccl)]) == (1.0, 4.0)
    alone = tracewin.Trace(6.0, 3, [("void rmt::fine_kernel<0>(int)", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)],
                           [], -1.0, 5.0)
    part = _summary(alone)
    assert part["busy_s"] == part["compute_busy_s"] == 3.0
    assert bench_run.device_time([part]) == (alone.busy_s, alone.window_s)


def test_the_alignment_runs_once_before_the_loop_and_outside_the_window():
    calls = []

    def hook():
        calls.append(("align", time.perf_counter()))
        time.sleep(0.2)

    def loop():
        calls.append(("loop", time.perf_counter()))
        time.sleep(0.05)

    tr = tracewin.traced(loop, lambda: len(calls), cuda=False, align=hook)
    assert [c[0] for c in calls] == ["align", "loop"]
    assert calls[1][1] - calls[0][1] >= 0.2
    assert 0.05 <= tr.window_s < 0.15
