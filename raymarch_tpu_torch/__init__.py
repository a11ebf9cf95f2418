"""raymarch_tpu_torch: the PyTorch/CUDA port of raymarch_tpu.

Sphere-traced, differentiable rendering of a runtime-editable CSG scene
compiled to a flat tape, on an NVIDIA GPU: the scene DSL and tape compiler
(numpy, copied from `raymarch_tpu`), the torch reference renderer (march,
shading, implicit and soft gradients), the flat march kernels, the
cone-prepass forward renderer, the fused forward+backward renderer and the
scene fit, whose kernels are CUDA C++ (`csrc/`, built with nvcc at first
use), and the live-editing layer: the node graph, the tiered runtime and
the viewer. On the CPU the kernels' plain torch versions run instead. The
numpy layer is the reference's, copied: the scene model and tape compiler,
`io`, the f64 `oracle` and `ops.oracle_grad`, and `native`, the binding of
the C++ tape core. This package imports neither jax nor `raymarch_tpu`.
"""

from . import io, native
from .config import DEFAULT_CONFIG, RenderConfig
from .fit import FitResult, fit_scene
from .models import csg, graph
from .models.csg import box, capsule, cone, cylinder, plane, sphere, torus
from .models.graph import CSGNodeGraph
from .ops import oracle
from .ops.march import make_march, make_renderer, render_rays
from .ops.raygen import camera_rays_np, raygen_flat
from .ops.sdf import make_scene_fn
from .ops.tape import TapeArrays, TapeSpec, compile_scene, compile_wire, encode_wire
from .parallel import make_fit_step
from .utils.camera import Camera, OrbitCameraController, cam_vec
from .utils.stats import MarchStats, march_stats
from .viewer import ViewerApp
from .runtime import TieredRenderer

__version__ = "0.1.0"

__all__ = [
    "io",
    "native",
    "graph",
    "CSGNodeGraph",
    "MarchStats",
    "march_stats",
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
    "oracle",
    "make_march",
    "make_renderer",
    "render_rays",
    "camera_rays_np",
    "raygen_flat",
    "make_scene_fn",
    "make_fit_step",
    "fit_scene",
    "FitResult",
    "TapeArrays",
    "TapeSpec",
    "compile_scene",
    "compile_wire",
    "encode_wire",
    "Camera",
    "OrbitCameraController",
    "cam_vec",
    "ViewerApp",
    "TieredRenderer",
]
