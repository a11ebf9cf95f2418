from . import cuda_march, cuda_prepass, opcodes, oracle, raygen, sdf, tape
from .march import make_renderer

__all__ = ["cuda_march", "cuda_prepass", "opcodes", "oracle", "raygen", "sdf", "tape", "make_renderer"]
