"""The multi-device layer: row-sharded rendering and training over
`torch.distributed` ranks, and fit-run recovery."""

from .elastic import FitCheckpointer, Watchdog
from .mesh import RAY_AXIS, Mesh, initialize_multihost, make_mesh
from .render import FitOptState, make_fit_step, make_sharded_renderer

__all__ = [
    "RAY_AXIS",
    "Mesh",
    "initialize_multihost",
    "make_mesh",
    "make_fit_step",
    "make_sharded_renderer",
    "FitCheckpointer",
    "FitOptState",
    "Watchdog",
]
