"""idle_share.step: the card's idle share over the traced window,
1 - (merged device busy time) / (the traced window's length), in %
(chip_smoke.py's device_idle_share arithmetic, over the profiler's device
operations; NCCL's kernels, which spin while they wait for the other
ranks, are not counted as busy). Busy time and window come from the same
trace, so the share lies in [0, 100] without clipping."""


def read(run):
    t = run.trace
    if run.kind != "fit" or t is None or t.window_s <= 0 or t.compute_busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.compute_busy_s / t.window_s)
