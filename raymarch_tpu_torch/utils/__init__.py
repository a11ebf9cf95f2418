from . import camera, image, math3d

__all__ = ["camera", "image", "math3d"]
