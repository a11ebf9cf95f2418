"""roofline.frame: the least time the card could take for a frame over the
time it was busy with one, in %. The least time is max(operations / 67
TFLOP/s, bytes / 3.35 TB/s) of the work the benchmark's reference march
needed for the checked frames (yardstick.frame_work: steps, taps and
shading of hit rays, the floor of missed ones, the image written once and
the scene read once), never the program's own count, on the cards that
share the frame; the busy time is the merged device time a frame of the
traced window, whatever ran, but NCCL's kernels (which spin while they
wait for the other ranks)."""


def read(run):
    t = run.trace
    if run.kind != "frames" or t is None or t.units == 0 or not run.bound_ms or t.compute_busy_s <= 0:
        return None
    return 100.0 * run.bound_ms / run.ranks / (t.compute_busy_s / t.units * 1e3)
