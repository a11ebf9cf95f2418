"""raymarch_tpu_torch: the PyTorch/CUDA port of raymarch_tpu.

Sphere-traced rendering of a runtime-editable CSG scene compiled to a flat
tape, on an NVIDIA GPU: the scene DSL and tape compiler (numpy, copied from
`raymarch_tpu`), and the cone-prepass forward renderer whose two kernels are
CUDA C++ (`csrc/`, built with nvcc at first use). On the CPU the kernels'
plain torch versions run instead. This package imports neither jax nor
`raymarch_tpu`.
"""

from .config import DEFAULT_CONFIG, RenderConfig
from .models import csg
from .models.csg import box, capsule, cone, cylinder, plane, sphere, torus
from .ops.march import make_renderer
from .ops.tape import TapeArrays, TapeSpec, compile_scene, compile_wire, encode_wire
from .utils.camera import Camera, OrbitCameraController, cam_vec

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "RenderConfig",
    "csg",
    "sphere",
    "box",
    "torus",
    "plane",
    "cylinder",
    "capsule",
    "cone",
    "make_renderer",
    "TapeArrays",
    "TapeSpec",
    "compile_scene",
    "compile_wire",
    "encode_wire",
    "Camera",
    "OrbitCameraController",
    "cam_vec",
]
