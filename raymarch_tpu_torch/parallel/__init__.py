"""The multi-device layer: row-sharded rendering and training over
`torch.distributed` ranks (the whole world, or a mesh of part of it), and
fit-run recovery."""

from .elastic import FitCheckpointer, Watchdog
from .mesh import RAY_AXIS, Mesh, all_reduce_sum, initialize_multihost, make_mesh
from .render import FitOptState, make_fit_step, make_sharded_renderer

__all__ = [
    "RAY_AXIS",
    "Mesh",
    "initialize_multihost",
    "make_mesh",
    "all_reduce_sum",
    "make_fit_step",
    "make_sharded_renderer",
    "FitCheckpointer",
    "FitOptState",
    "Watchdog",
]
