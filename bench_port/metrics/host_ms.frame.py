"""host_ms.frame: the host's time in each call of the entry (the benchmark's
own span around it; for a step the loss read is outside it), mean a frame,
in ms. It holds any wait of the program's own for the card."""

import statistics


def read(run):
    if run.kind != "frames" or not run.host_s:
        return None
    return statistics.mean(run.host_s) * 1e3
