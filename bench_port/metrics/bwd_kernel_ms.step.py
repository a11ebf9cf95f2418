"""bwd_kernel_ms.step: the device time a step of the backward kernels K8
(fused_bwd_kernel), K9 (compact_bwd_kernel) and bwd_finalize_kernel, from
torch.profiler's trace of the traced window, in ms."""

PATTERN = r"fused_bwd_kernel|compact_bwd_kernel|bwd_finalize_kernel"


def read(run):
    t = run.trace
    if run.kind != "fit" or t is None or t.units == 0:
        return None
    s = t.kernel_s(PATTERN)
    return s / t.units * 1e3 if s > 0 else None
