"""step_ms: the measured window's seconds over the fit steps completed in
it (host clock; each step ends with its loss read to the host), in ms."""


def read(run):
    if run.kind != "fit" or run.units == 0:
        return None
    return run.window_s / run.units * 1e3
