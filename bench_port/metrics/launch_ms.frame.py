"""launch_ms.frame: the host's time a frame in the port's kernel launch
wrappers (`rmt.launch.*` spans: checks, output allocation, argument packing,
the launch call), mean over the traced window's frames, in ms."""

from bench_port.spans import mean_over_frames


def read(run):
    return mean_over_frames(run, lambda f: f.time_in(lambda name: name.startswith("launch.")))
