"""frame4k_ms: frame_ms of the cell spheres64.view4k, a metric of its own so that its bound
follows that cell's own spread."""

from bench_port.metrics.frame_ms import read  # noqa: F401
