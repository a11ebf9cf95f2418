"""launches.frame: the port's kernel launches a frame, the growth of its
launch counts over each `rmt.frame` span, mean over the traced window's
frames."""

from bench_port.spans import mean_over_frames


def read(run):
    return mean_over_frames(run, lambda f: f.rec.attrs["launches"])
