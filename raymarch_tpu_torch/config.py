"""Render configuration.

The reference hard-codes every rendering constant; this frozen dataclass carries
exactly those defaults as the behavioral spec (see SURVEY.md §5 "Config / flag
system"). Sources in the reference:

- march limits min_dist=0.01, max_dist=100.0, max_iter=100
  (src/ray_marching/renderer.rs:130-140)
- aa_samples=4 => 4x4 = 16 rays/pixel (src/ray_marching/ray_marching.wgsl:34)
- perspective fovy=pi/4, near=1.0, far=10000.0 (src/ray_marching/renderer.rs:206-207)
- light at (2,-5,3), ambient floor 0.02, albedo (0.4,0.7,0.1)
  (src/ray_marching/ray_marching.wgsl:100-105)
- floor plane y=-1.5, checkerboard base (0.1,0.1,0.2) + 0.2*parity
  (src/ray_marching/ray_marching.wgsl:119-127)
- value-stack depth 32 (src/ray_marching/ray_marching.wgsl:173)
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Sphere-tracing march limits.
    min_dist: float = 0.01
    max_dist: float = 100.0
    max_iter: int = 100

    # Anti-aliasing: aa_samples x aa_samples sub-pixel grid.
    aa_samples: int = 4

    # Perspective projection.
    fovy: float = math.pi / 4
    near: float = 1.0
    far: float = 10000.0

    # Shading.
    light_position: tuple[float, float, float] = (2.0, -5.0, 3.0)
    ambient: float = 0.02
    albedo: tuple[float, float, float] = (0.4, 0.7, 0.1)

    # Floor plane (rendered analytically on ray miss).
    floor_y: float = -1.5
    floor_base: tuple[float, float, float] = (0.1, 0.1, 0.2)
    floor_checker: float = 0.2

    # Normal estimation (tetrahedron central differences).
    normal_eps: float = 1e-4

    # Implicit-function VJP: lower bound on |grad_x f . d| (the IFT
    # denominator). Grazing rays have |denominator| -> 0 and would amplify
    # gradients unboundedly (1/denom); this caps the amplification at
    # 1/clamp. Biased at grazing incidence, bounded everywhere.
    grad_denom_clamp: float = 0.05

    # CSG evaluation.
    stack_depth: int = 32

    # March early-exit check interval (Pallas kernels): the "any ray still
    # live" reduction + scalar branch stalls the VPU pipeline, so it runs
    # every K iterations with K pure masked vector steps in between. Masked
    # lanes do cheap no-op work; a tile does at most K-1 extra (masked)
    # scene evals past its natural exit. 1 = check every step.
    exit_check_every: int = 1

    # Over-relaxed sphere tracing (Keinert et al. 2014): step omega*d with a
    # per-ray fallback to plain stepping when consecutive safe spheres fail
    # to overlap, which keeps hits exact. 1.0 = classic sphere tracing
    # (reference semantics); ~1.4-1.6 cuts step counts 20-40% on typical
    # scenes. Pallas kernels only.
    relax: float = 1.0

    # Soft-coverage (silhouette) gradients, mode="soft" renderers/fit: the
    # binary hit mask becomes alpha = exp(-max(s_min - min_dist, 0)/beta)
    # with s_min the ray's closest approach to the scene, so pixel losses
    # carry gradients through silhouette COVERAGE (a translation whose only
    # signal is the outline moving is fittable — impossible with the
    # interior-only implicit VJP). beta is the falloff length in world
    # units; forward images differ from the hard renderer by an O(beta)
    # halo outside silhouettes.
    coverage_beta: float = 0.02

    # Soft-mode cull/bound inflation, in units of coverage_beta: a culled
    # leaf (or a bound-skipped ray) is guaranteed alpha <= exp(-X) where
    # X = soft_cull_log_alpha. The default 104 makes the cut BITWISE exact
    # (exp(-104) underflows f32 to 0.0), but inflates every soft bound by
    # 104*beta — 2.1 world units at beta=0.02, which defeats leaf culling
    # entirely on many-primitive scenes (no leaf ever culls), so the
    # default is exact but slow at scale. Lowering to e.g. 24 bounds the
    # DIRECTLY dropped alpha by exp(-24) ~ 4e-11 and makes culling
    # effective (~2.5x faster soft fwd+bwd at 64 leaves measured), at the
    # cost of the same SAMPLE-PHASE tolerance class as the hard path's
    # accelerators: culling perturbs off-surface march step sizes, so the
    # SAMPLED closest approach — and with it alpha — shifts by
    # O(step/beta) on grazing silhouette rays (measured mean ~8e-5, max
    # ~0.1 on isolated edge pixels at 64 leaves/beta=0.02; interior and
    # background pixels unchanged). Keep 104 when bitwise parity with the
    # un-culled soft path matters more than speed.
    soft_cull_log_alpha: float = 104.0

    # Bounding-sphere march acceleration (the kernels): rays missing a
    # conservative scene bound skip the march; the rest march from t = 0
    # (the flat kernels K5-K7; the cone prepass starts its cones at the
    # bound's entry) and escape at its exit. Exact (hit/t unchanged) — only
    # step counts drop. Auto-disables for unbounded scenes (planes). Off by
    # default so step statistics match the reference's march semantics.
    bound_accel: bool = False

    # Per-tile leaf culling (cone-prepass Pallas renderer + fused VJP): each
    # image-rectangle kernel tile tests every leaf's inflated bounding sphere
    # against the tile's view cone and skips culled leaves' distance blocks
    # entirely (they contribute a constant FAR). Conservative and exact for
    # hits/shading/gradients (see ops.culling); breaks the O(n_leaves) cost
    # of every distance query, which is what makes many-primitive scenes
    # fast. Off by default so small-scene step statistics and kernel
    # signatures match round-1 behavior exactly.
    leaf_cull: bool = False

    # Share the tetrahedron normal across the AA samples of a pixel
    # (cone-prepass renderer only): the first sample that hits computes the
    # 4-tap normal; later samples of the same pixel reuse it (diffuse is
    # still recomputed at each sample's own hit point). Approximate at
    # silhouettes (the reference evaluates normals per sample, wgsl:135-144)
    # and off by default. Measured effect on a v5e at 1080p: only ~1-3%
    # faster (4-leaf and 64-leaf scenes) — the tap block is skipped per
    # TILE, and a 16K-pixel tile almost always contains some newly-hit lane
    # at every AA sample, so the skip rarely fires; the fine march, not the
    # taps, bounds the fine kernel. Kept as a documented experiment.
    aa_shared_normals: bool = False


DEFAULT_CONFIG = RenderConfig()
