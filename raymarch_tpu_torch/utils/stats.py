"""March statistics: a numpy copy of `raymarch_tpu.utils.stats`.

The march kernels emit a per-ray step count (K5, K6: csrc/march.cu), and
this module aggregates it into the numbers that matter for performance
tuning (average steps, percentiles, hit rate) plus a per-tile divergence
measure (how much work a tile-granular early exit wastes relative to a
per-ray exit). Steps and hits may be numpy arrays or tensors on any device
(read to the host once). tests/test_torch_tape.py guards the copy against
drift.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class MarchStats:
    n_rays: int
    hit_rate: float
    avg_steps: float
    p50_steps: float
    p99_steps: float
    max_steps: int
    # Ratio of (sum over tiles of tile-max steps * tile size) to sum of
    # per-ray steps: the SIMD-divergence overhead factor (1.0 = perfect).
    tile_divergence: Optional[float] = None

    def __str__(self) -> str:
        s = (
            f"rays={self.n_rays} hit_rate={self.hit_rate:.3f} "
            f"steps avg={self.avg_steps:.1f} p50={self.p50_steps:.0f} "
            f"p99={self.p99_steps:.0f} max={self.max_steps}"
        )
        if self.tile_divergence is not None:
            s += f" tile_divergence={self.tile_divergence:.2f}x"
        return s


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def march_stats(steps, hit, tile_size: Optional[int] = None) -> MarchStats:
    """Aggregate per-ray march outputs. `tile_size` (rays per tile, e.g. 32
    for a warp of K6) adds the divergence factor."""
    steps = _host(steps).reshape(-1)
    hit = _host(hit).reshape(-1)
    div = None
    if tile_size and steps.size >= tile_size:
        n_full = (steps.size // tile_size) * tile_size
        tiles = steps[:n_full].reshape(-1, tile_size)
        per_ray = max(float(tiles.sum()), 1.0)
        tile_cost = float((tiles.max(axis=1) * tile_size).sum())
        div = tile_cost / per_ray
    return MarchStats(
        n_rays=int(steps.size),
        hit_rate=float((hit > 0.5).mean()),
        avg_steps=float(steps.mean()),
        p50_steps=float(np.percentile(steps, 50)),
        p99_steps=float(np.percentile(steps, 99)),
        max_steps=int(steps.max()) if steps.size else 0,
        tile_divergence=div,
    )
