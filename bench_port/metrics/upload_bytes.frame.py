"""upload_bytes.frame: the bytes the port sends from the host to the card a
frame, the growth of its `h2d_bytes` counter over each `rmt.frame` span,
mean over the traced window's frames."""

from bench_port.spans import mean_over_frames


def read(run):
    return mean_over_frames(run, lambda f: f.rec.attrs["h2d_bytes"])
