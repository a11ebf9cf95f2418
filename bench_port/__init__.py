"""The benchmark of raymarch_tpu_torch, the PyTorch and CUDA port: one cell
run once by `python3 -m bench_port.run` (see run.py), its configurations,
traffic mixes, limits and metric readers in files of their own (spec.py),
and its yardstick: the plain reference (reference.py), the prices and the
roofline (yardstick.py). It imports neither jax nor the JAX package."""
