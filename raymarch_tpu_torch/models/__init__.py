from . import csg

__all__ = ["csg"]
