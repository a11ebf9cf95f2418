"""renderer_self_ms.frame: the port's `rmt.frame` span less what its child
spans cover (the renderer's own host work outside uploads and launches),
mean over the traced window's frames, in ms. Where a frame's children are
its uploads and launches, as in make_renderer's frame, it and
upload_ms.frame and launch_ms.frame add up to the frame's span."""

from bench_port.spans import mean_over_frames


def read(run):
    return mean_over_frames(run, lambda f: f.self_ms())
