"""band_host_ms.frame4k_x4: the host's time a frame in the sharded frame's
`rmt.band` spans (each band's uploads and launches, and its copy into the
frame), rank 0's, mean over the traced window's frames, in ms."""

from bench_port.spans import mean_over_frames


def read(run):
    return mean_over_frames(run, lambda f: f.time_in(lambda name: name == "band"))
