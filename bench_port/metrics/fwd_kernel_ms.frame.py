"""fwd_kernel_ms.frame: the device time a frame of the forward kernels K1
(coarse_kernel) and K2 (fine_kernel), from torch.profiler's trace of the
traced window, in ms."""

PATTERN = r"\bcoarse_kernel|\bfine_kernel"


def read(run):
    t = run.trace
    if run.kind != "frames" or t is None or t.units == 0:
        return None
    s = t.kernel_s(PATTERN)
    return s / t.units * 1e3 if s > 0 else None
