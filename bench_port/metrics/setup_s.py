"""setup_s: from the process's start to the measured window's: imports,
the card, the kernel library (built by nvcc in a checkout's first run),
the scene, the renderer or fit step, a fit's first steps, and the warm-up
frames, in s (host clock). The reference's own work (a fit's target) is
not in it."""


def read(run):
    return run.setup_s
