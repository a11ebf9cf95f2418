"""gather_ms.frame4k_x4: the device time a frame of NCCL's float all_reduce on
rank 0 (the sharded frame's gather; the window's integer stop flag is not
counted), from torch.profiler's trace of the traced window, in ms. The
kernel runs on NCCL's stream and spins until the other ranks arrive, so it
holds the wait for the slowest rank and can overlap rank 0's next frame."""

PATTERN = r"(?i)nccl.*all_?reduce.*f32"


def read(run):
    t = run.trace
    if run.kind != "frames" or t is None or t.units == 0:
        return None
    s = t.kernel_s(PATTERN)
    return s / t.units * 1e3 if s > 0 else None
