"""frame_p95_ms: the 95th percentile, over every frame of the measured
window, of the time from the previous frame's completion on the card to
this one's (CUDA events, the card's clock), in ms: the stutter a viewer
sees."""

import statistics


def read(run):
    if run.kind != "frames" or len(run.intervals_ms) < 20:
        return None
    return statistics.quantiles(run.intervals_ms, n=20)[18]
