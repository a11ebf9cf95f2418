"""frame_ms: the measured window's seconds over the frames completed in it
(host clock), in ms."""


def read(run):
    if run.kind != "frames" or run.units == 0:
        return None
    return run.window_s / run.units * 1e3
