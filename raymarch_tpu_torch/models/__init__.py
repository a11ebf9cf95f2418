from . import csg, graph

__all__ = ["csg", "graph"]
