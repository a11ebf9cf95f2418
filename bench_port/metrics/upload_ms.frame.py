"""upload_ms.frame: the host's time a frame in the port's `rmt.upload` spans
(the camera vector, the scene's parameters and bound sent to the card),
mean over the traced window's frames, in ms."""

from bench_port.spans import mean_over_frames


def read(run):
    return mean_over_frames(run, lambda f: f.time_in(lambda name: name == "upload"))
