from . import camera, math3d

__all__ = ["camera", "math3d"]
