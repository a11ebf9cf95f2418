"""Training around the fused renderer: the fit step and fit-run recovery,
on one device (multi-device: ROADMAP §1 item 7)."""

from .elastic import FitCheckpointer, Watchdog
from .render import FitOptState, make_fit_step

__all__ = ["FitCheckpointer", "FitOptState", "Watchdog", "make_fit_step"]
