"""The benchmark's yardstick: peaks, operation prices, the roofline bound, and
the arithmetic that turns a device trace into busy and idle time.

Frozen copies, so that no change to the program moves them:

- the prices and `roofline` of `chip_smoke.py:406-475` (PEAK_F32,
  PEAK_BYTES, LEAF_OPS, COMBINE_OPS, STEP_OPS, RAY_OPS, SHADE_OPS,
  FLOOR_OPS), each an f32 operation count (add, mul, min/max, abs, sqrt,
  compare; an FMA = 2) of the formula it prices;
- the merge of device intervals of `chip_smoke.py:659-704`
  (`device_idle_share`) and the per-kernel device time of `:710-731`
  (`kernel_device_ms`), here over events already taken from a trace.

The work priced here is never the program's own count: `frame_work` takes
the steps, hits and misses that the benchmark's reference march needed
(`reference.WorkCount`) for the same inputs under the cell's settings.
"""

from __future__ import annotations

# An H100 SXM's published peaks (NVIDIA's H100 datasheet): f32 outside the
# tensor cores, and HBM, at the card's full 700 W.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# Leaf types of the benchmark's scene descriptions, priced by the
# operations of their formula.
LEAF_OPS = {"sphere": 11, "box": 25, "plane": 6, "torus": 17, "cylinder": 21, "capsule": 17, "cone": 44}
COMBINE_OPS = {"union": 1, "intersect": 1, "subtract": 2}
STEP_OPS = 14  # one march step: the point (3 FMA), the tests, the update
RAY_OPS = 60  # screen coordinates, the view ray, the bound clip
SHADE_OPS = 60  # normal, light, Lambert, gamma of a hit ray
FLOOR_OPS = 40  # the checker floor and gamma of a ray that misses
TAPS = 4  # scene evaluations of the tetrahedron normal of a hit ray
F32_BYTES = 4


def roofline(flops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the operations over the f32 peak
    and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def frame_work(work, eval_ops: float, width: int, height: int, tape_bytes: int) -> tuple[float, float]:
    """(operations, bytes) a frame needs at least, whatever marches it:
    every AA ray its raygen (with the bound test), and each one that
    enters the scene's bounding sphere the one step and scene evaluation
    that end it; every pixel the march of one ray, as many steps as its
    samples take in the reference's march on average (a march a pixel can
    share among its samples, as a cone prepass does); every hit ray the 4
    taps and the shading; every missed ray the floor. Bytes: the image
    written once and the scene read once."""
    step = STEP_OPS + eval_ops
    flops = (work.rays * RAY_OPS + work.marched * step + work.steps / work.samples * step
             + work.hits * (TAPS * eval_ops + SHADE_OPS) + work.misses * FLOOR_OPS)
    nbytes = width * height * 3 * F32_BYTES + tape_bytes
    return float(flops), float(nbytes)


def merge(spans) -> list[tuple[float, float]]:
    """Sorted (start, end) intervals -> their union as disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(spans) -> float:
    """Length of the union of the intervals (the device's busy time)."""
    return sum(b - a for a, b in merge(spans))


def gaps(spans, start: float, end: float) -> list[tuple[float, float]]:
    """The intervals of [start, end] that no span covers (the idle gaps)."""
    out, cur = [], start
    for a, b in merge(spans):
        if a > cur:
            out.append((cur, min(a, end)))
        cur = max(cur, b)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(a, b) for a, b in out if b > a]
