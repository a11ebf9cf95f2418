from . import cache, camera, image, math3d, profiling
from .cache import enable_persistent_cache
from .profiling import rays_per_second, time_fn, trace

__all__ = ["cache", "camera", "image", "math3d", "profiling", "enable_persistent_cache", "rays_per_second",
           "time_fn", "trace"]
