#!/usr/bin/env python3
"""Smoke run of raymarch_tpu_torch's main path on one CUDA card.

Run from the repository root: `python3 chip_smoke.py`. It

1. prints the card's name and power limit (nvidia-smi) and exits non-zero
   when CUDA is not available;
2. builds the CUDA kernels from raymarch_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain torch version on the card at the
   256x144 gate frame (bench.py's gate camera), for the headline config and
   for the strict no-prepass path;
4. renders BASELINE config 2 at 1920x1080 with 4x4 AA through
   `make_renderer(..., backend="pallas_prepass", device="cuda")`, times it
   with CUDA events, counts the kernel launches of that run, and compares the
   frame with the plain path on the card;
5. checks that a numeric scene edit re-renders with no rebuild;
6. holds the fine kernel's residual output (t, hit per AA ray) and the
   fused backward kernel against their plain versions at the 256x144 gate,
   for the headline scene, a smooth-union scene and a scene with every leaf
   type and op;
7. runs the training path at 1920x1080 with 4x4 AA: loss = mean(img^2)
   backpropagated through `make_renderer(..., backend="pallas_fused",
   mode="implicit", device="cuda")`, timed with CUDA events, its launches
   counted and its gradients compared with the plain backward;
8. fits the headline scene's sphere centre at 1920x1080 with 16 AA rays per
   pixel through `fit_scene(..., device="cuda")`, and BASELINE config 3 (a
   smooth union's centre and blend radius) at 48x48;
9. many-primitive training (bench.py's `fwdbwd_64leaf_compact` row: 64
   random spheres in one hard union, leaf_cull=True, relax=1.6, no
   intervals): gates at 256x144 of the culled coarse and fine kernels (item
   lists of pool and seg1 plans, the gated tape of `rich`; fine with and
   without residuals), of the compact backward kernel (the 64-sphere scene
   and a rotated pool of mixed types) and of `rich`'s culled forward
   followed by the legacy backward, each against its plain version; then at
   1920x1080 with 4x4 AA the fwd+bwd step of mean(img^2) through
   `make_renderer(..., backend="pallas_fused")` (CUDA events, launch counts,
   device idle share, mean active leaves per fine tile, hit fraction), its
   kernels alone against their plain versions, the device operations of
   the per-frame masks and lists (and of their pairwise path loop), the
   culled frames of the
   64-sphere scene and config 2 against the un-culled plain path, the
   64-leaf forward frame ("cull + relax, no intervals") and a 5-step fit;
10. training of scenes with smooth blends, subtractions and painted
   materials (bench.py's 64-leaf smooth chain, a seg1 plan; the cluster
   scene of `fwdbwd_64leaf_cluster`, a stream plan in two groups; the
   painted spheres of `fwdbwd_64leaf_painted`, a painted pool): gates at
   256x144 of the fine kernel with materials (culled and un-culled) and of
   the compact backward for config 2 culled (seg1) and the three scenes,
   each against its plain version; then for each scene the 1080p fwd+bwd
   step (CUDA events, launches, idle share, the kernels alone, the device
   operations of the masks and lists), the compact backward against its
   plain version at full size with its bound; the painted forward frame
   against the un-culled plain path; a 5-step fit of the cluster scene;
11. the many-primitive forward as bench.py configures it: gates at 256x144
   of the interval scan of the coarse kernel (ni = 1, 2, 3), the coarse
   kernel at B = 4, the chained pixel kernel K3, the fine kernel on block
   planes and through intervals (plain and relaxed), and the culled
   interval kernels of the 64-sphere, chain, cluster and 256-leaf scenes,
   each against its plain version; then, under bench.py's row names, the
   1080p/16 AA frames of `interval_relax_static`, `64leaf_cull_intervals`,
   `64leaf_smooth_chain`, `64leaf_mixed_cluster`, `256leaf_compact` and
   `1024leaf_compact` (B = 4) and the 3840x2160 frame of `64leaf_4k_3band`
   as three 720-row bands (frame ms, Grays/s, launches, idle share,
   `cull_args` alone, active items per fine tile, the kernels alone and
   against their plain versions: at full size, the 4K row on its middle
   720-row band, the 256/1024-leaf scenes' costliest passes on one 64-row
   band), and
   K3 timed at 1080p on config 2 with B = 4; K3's planes (t0, status) equal
   to its plain version's at every pixel in every gate, static and DYN, on
   config 2 and on 64 spheres (stack depth 8: the shared-memory route), at
   256x144 and 1920x1080;
12. the legacy backward (K8) of every static scene the reference sends to
   it, at 1920x1080 with 16 AA rays per pixel: (a) the 64 painted spheres
   of `fwdbwd_64leaf_painted` without culling and (b) bench.py's smooth
   chain with every sphere painted (seed 19), both through K8's warp-row build
   with the albedo words; (c) the 64 spheres intersected with a box (129
   instructions, 1,176 gradient words: the warp-row build); (d) config 2 at
   `prepass_block=4` (the fine kernel with residuals on block planes, then
   the headline's per-thread build); (e) 16 painted spheres (294 gradient
   words: the warp-row build with the albedo words): for each the fwd+bwd step of mean(img^2) (CUDA
   events, launches), the reference's backward_info, K8 alone, K8 against
   `bwd_plain` on the whole frame (the albedo and flag words of (a), (b),
   (e), and the op words of (b), non-zero and within 0.01 of their own
   class's largest word) and its bound; a 5-step 1080p
   fit of (a)'s albedos; an `aa_samples=8` frame of config 2 against its
   plain path;
13. soft coverage (silhouette gradients): gates at 256x144 of the fine
   kernel's soft build (un-culled, lists, gated tape; with materials) and
   of the soft builds of K8 (per-thread and warp rows, with and without the
   albedo words) and K9 (pool, seg1 chain, stream in two groups), each
   against its plain version, with a camera that shows no horizon; then
   bench.py's three soft rows at 1920x1080 with 16 AA rays per pixel
   through `make_renderer(mode="soft", backend="pallas_fused")`:
   `fwdbwd_soft` (config 2, K8), `fwdbwd_64leaf_soft` and
   `fwdbwd_64leaf_soft_la24` (64 spheres culled, K9): the step (CUDA
   events, launches of the soft builds and of nothing else, the
   reference's backward_info, idle share), the soft fine kernel and the
   soft backward alone, against their plain versions (the frame; K9's on
   one 64-row band) with their bounds; a 5-step soft pose fit of the
   64-sphere row;
14. the render surfaces of the reference's make_renderer: gates at 256x144
   of the flat march kernels K5 (raygen_flat rays of the gate camera, a
   count that is no multiple of 128), K6, K7 per AA ray and K7's pixel
   build (config 2 static and as compile_scene's default dynamic tape, the
   empty dynamic scene, `rich` and 16 painted spheres as dynamic tapes,
   config 2 at relax 1.6, 64 spheres and 16 painted spheres static at
   stack depth 8: every stack route and flag), and of the pixel build at
   aa 2, 3, 4 and 8, each against its plain version (hit and steps equal
   on every ray, t within 1e-5 on hits, images max|d| < 1e-3), of K2's
   march-only build (B = 1;
   n_intervals=2 at relax 1.6) against fine_res_plain's (t, hit), of K5
   alone (t, hit and steps equal on every ray at 1, 31, 33 and 2^20 + 5
   rays of the camera and of seeded incoherent rays, on config 2's dynamic
   tape, at relax 1.6 and on 64 spheres), and of
   make_renderer(backend="pallas", mode="implicit")'s gradients against
   backend "jnp"'s (without bound_accel and with it: both start every ray
   at t = 0 and march the same samples); then at 1920x1080 with 16 AA
   rays per pixel bench.py's `march_only` (K6; static and dynamic tapes;
   march_stats; K6 alone), `march_only_fast` (K1's interval scan and K2's
   march-only build, relax 1.6), the `pallas_full` frame (K7's pixel
   build; static and dynamic; against its plain version and the
   no-prepass fine kernel's frame, both in the exact class), K6 with
   bound_accel against K6 without it (hit and t on hits equal, steps no
   larger), K7 per AA ray through
   make_pallas_image_render, the make_renderer frames of backends "pallas"
   and "jnp" (dynamic tape) and `fwdbwd_jnp` (backend "pallas", implicit,
   chunk 2^20: step, K5 launches, peak memory), K5 alone in the step's
   2^20-ray launches (CUDA events and torch.profiler's device time a
   launch) against its plain version, each
   kernel's time alone, plain time and bound;
15. live editing: gates at 256x144 of the DYN builds of the coarse and
   fine kernels (the dynamic tape: config 2 un-culled, gated and at relax
   1.6, the empty scene, `rich` gated at relax 1.6, 16 painted spheres
   un-culled and gated), of the unpacked fine pass K4 (aa 1-6 with and
   without shared normals on both tapes, every prepass form, relax 1.6, 16
   painted spheres, culled frames whose blocks cross a list tile's edge,
   aa 12; its residuals t and hit equal to the plain version's on every
   ray), of K8 on K4's residuals at aa = 3, and the dynamic frame
   against the static one in bench.py's dynamic-tape class; then at
   1920x1080 with 16 AA rays per pixel bench.py's `dynamic_tape_prepass`
   against the static headline (S D D S in one call: frame ms, Grays/s,
   launches, the DYN kernels alone, their bounds and plain times), the
   `aa_shared_normals` frame (K4 alone, bound, plain) and an aa = 3 fwd+bwd
   step (K1, K4 with residuals, K8; its gradients against `bwd_plain`);
   then a `TieredRenderer` at 960x540 (the viewer's size on an
   accelerator) with its static tier built in the background: a topology
   edit's first (dynamic) frame, the static tier's readiness, each tier's
   steady frames, a numeric edit that builds nothing and a topology edit
   within the bucket that keeps the dynamic renderer; and a `ViewerApp`
   through `make_server` on localhost: an `/edit` adding a node and a
   `frame.png`, timed;
16. the render options repaired for dynamic tapes and for any
   n_intervals, and the scenes past a block's shared gradient row: gates at
   256x144 of K3's DYN build (config 2's dynamic tape, B = 4, chained), of
   K2's DYN march-only build (equal bit for bit to the DYN fine kernel's
   (t, hit), and against fine_res_plain) and DYN soft build (un-culled and
   gated), of the coarse scan and the fine passes that keep more than MAX_NI
   intervals in the planes (coaxial tori at B = 4: ni = 6 static and
   dynamic relaxed, K2's march-only build, K4 at ni = 5, aa = 3), of K9 on
   a 4,096-sphere pool (96x54) and of K8 on a 3,600-leaf tape (64x36), each after
   a training step through make_renderer; then at 1920x1080 with 16 AA rays
   per pixel the chained dynamic frame, `march_only_fast` on the dynamic
   tape, the dynamic soft frame and the ni = 6 frame of the tori (frame ms,
   launches, the kernels alone, plain, bound);
17. the headline path against the port's own f64 oracle
   (`raymarch_tpu_torch.oracle.render`, numpy, no jax) at 96x54 from
   bench.py's gate camera: the headline frame in bench.py's accelerated
   class, the frames without a prepass (K2's no-prepass build, the
   headline and the strict-reference configs) within max|d| < 1e-3;
18. multi-device, the row-sharded renderer and fit step
   (`raymarch_tpu_torch.parallel`): (a) one rank in an NCCL group of one
   at 1920x1080 with 16 AA rays per pixel: `make_sharded_renderer(backend=
   "pallas_prepass", row_interleave=4)` against `make_renderer`'s frame
   (max|d| < 1e-3) with its ms/frame and launches (K1 and K2 once a band),
   a `make_fit_step(backend="pallas_fused", row_interleave=4)` step's loss
   and reduced gradients against the single-band step's (K1, K2 with
   residuals and K8 once a band), both steps' ms, and K1, K2 and K8 alone
   on the middle band against their plain versions; (b) the same step on
   the 64 spheres of `fwdbwd_64leaf_compact` (K9 once a band, against the
   single-band step), `cull_args` a band, the culled kernels alone on the
   middle band, and at the 256x144 gate the sharded step against the
   single-band step and the port's f64 gradient oracle (`ops/oracle_grad.py`)
   on seeded hit pixels; (c) two ranks of this script (`--rank`) on the one
   card through gloo with CUDA tensors, 2 bands each: their gathered frame
   bit-equal to (a)'s, their loss, gradients and SGD-updated parameters
   equal to each other and to (a)'s (rtol 1e-5; gradients in their
   class); beside them a world of three ranks (`--mesh 2`) in which every
   rank calls `make_mesh(2)`: ranks 0 and 1, the mesh's, must give the
   two-rank world's results bit for bit, and rank 2, outside it, must get
   the ValueError of `make_sharded_renderer`, `make_fit_step`,
   `FitCheckpointer` and `all_reduce_sum` without blocking; (d) while
   they run, the band kernels against their plain versions at the 256x144
   gate on a band of 37 rows (K1, K2 with
   residuals, K8 on config 2; the culled K1, K2 and K9 on 64 spheres; K4
   with shared normals) and a band reaching past the image (finite);
19. the five BASELINE configs through `raymarch_tpu_torch.examples.configs`
   at their published sizes, twice each (host seconds, launches of each
   run): config 1 (256x256, the "jnp" march) against the port's f64
   oracle at 64x64; config 2 (512x512, K1 and K2's materials build)
   against its plain path; config 3's 48x48 fit (60 steps of K1, K2 with
   residuals and K8) recovering the blend; config 4's 24 frames at
   1920x1080 with an edit each (K1, K2 once a frame), distinct, its frame
   0 again against the config's check and its plain path; config 5's
   3840x2160 sharded frame (K1, K2) and distributed step;
20. prints one JSON line of per-kernel records (time, plain time, launches,
   the roofline bound from this run's counted work) for the headline
   builds, the culled builds of the 64-leaf path, the compact backward per
   plan kind, the fine kernel with materials, the interval and block
   builds of the coarse and fine kernels and K3, K8's builds of phase 12,
   the fine kernel at B = 4 with residuals and at aa = 8, the soft builds
   of phase 13, K5, K6, K7 (per AA ray and per pixel) and K2's march-only build of phase 14, the DYN
   builds and K4 of phase 15, the band builds of phase 18, then the script's total seconds and, last,
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time

GATE_W, GATE_H = 256, 144
WIDTH, HEIGHT = 1920, 1080
WARMUP, FRAMES = 3, 20
KERNEL_REPS = 10
BWD_WARMUP, BWD_STEPS = 2, 10
FIT_STEPS = 5
PLAIN_BAND = 64  # rows of the band on which the 256/1024-leaf plain versions run
IDLE_PAUSE_S = 0.25  # the pause between the profiled warm-up run and the measured runs
DEVICE = "cuda"
T_START = time.perf_counter()  # reset at the start of main()
Q = (0.9, 0.2, -0.3, 0.25)


def log(msg: str) -> None:
    print(msg, flush=True)


def scene_config2(m):
    """BASELINE config 2 (bench.py:93-100): (sphere | box) - torus."""
    return (
        m.sphere(center=(-0.6, 0.0, 0.0), radius=0.9)
        | m.box(center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5))
    ) - m.torus(center=(0.0, 0.8, 0.0), major_radius=0.7, minor_radius=0.25)


def scene_smooth(m):
    """tests/test_pallas_grad.py:195-202: smooth union minus a torus."""
    return (
        m.sphere(center=(-0.55, 0.0, 0.1), radius=0.85).union(
            m.box(center=(0.7, 0.05, -0.1), half_extents=(0.45, 0.5, 0.4)), k=0.35
        )
    ) - m.torus(center=(0.0, 0.75, 0.0), major_radius=0.65, minor_radius=0.22)


def scene_rich(m):
    """tests/test_torch_cuda.py:32-43: every leaf type, rotations, every
    smooth op, round and onion."""
    a = m.sphere(center=(-0.3, 0.0, 0.0), radius=0.8)
    b = m.box(center=(0.4, 0.1, 0.0), half_extents=(0.5, 0.5, 0.5), rotation=Q)
    c = m.torus(center=(0.0, 0.5, 0.0), major_radius=0.6, minor_radius=0.2, rotation=Q)
    d = m.cylinder(center=(0.0, -0.4, 0.2), radius=0.3, half_height=0.9, rotation=Q)
    e = m.capsule(center=(0.9, 0.3, -0.5), radius=0.25, half_height=0.4, rotation=Q)
    f = m.cone(center=(-0.9, 0.2, 0.4), half_height=0.5, r_bottom=0.4, r_top=0.1, rotation=Q)
    return (
        a.union(b, k=0.2).subtract(c, k=0.15).intersect(d.round(0.05), k=0.1)
        | (e & f.round(0.3)) - c.onion(0.03)
        | (e | f).round(0.02)
    )


def scene_spheres(m, n=64):
    """bench.py:357-368: n random spheres (seed 7) in one hard union."""
    import numpy as np

    rng = np.random.default_rng(7)
    parts = []
    for _ in range(n):
        c = rng.uniform(-3, 3, 3)
        c[1] = rng.uniform(-1.0, 1.5)
        parts.append(m.sphere(center=tuple(c), radius=float(rng.uniform(0.15, 0.5))))
    scene = parts[0]
    for p in parts[1:]:
        scene = scene | p
    return scene


def scenes_bench64(m, chain_rgb=None):
    """bench.py:357-480's 64-leaf scenes, drawn in bench.py's order from its
    one generator (seed 7): (the 64 spheres, the smooth chain of
    `64leaf_smooth_chain`: 48 spheres, 8 smooth unions, 4 subtractions and
    4 smooth subtractions; the cluster scene of `fwdbwd_64leaf_cluster`: 16
    clusters of a base sphere, a smooth-union blob and a smooth-subtract
    dent, and 16 bare spheres). With `chain_rgb` (a numpy generator) every
    sphere of the chain is painted `chain_rgb.uniform(0.1, 0.9, 3)` in build
    order; the geometry stays bench.py's."""
    import numpy as np

    rng = np.random.default_rng(7)

    def mat():
        return None if chain_rgb is None else tuple(chain_rgb.uniform(0.1, 0.9, 3))

    def union_all(parts):
        scene = parts[0]
        for p in parts[1:]:
            scene = scene | p
        return scene

    def centre(lo, hi, ylo, yhi):
        c = rng.uniform(lo, hi, 3)
        c[1] = rng.uniform(ylo, yhi)
        return tuple(c)

    spheres = union_all([m.sphere(center=centre(-3, 3, -1.0, 1.5), radius=float(rng.uniform(0.15, 0.5)))
                         for _ in range(64)])
    chain = union_all([m.sphere(center=centre(-3, 3, -1.0, 1.5), radius=float(rng.uniform(0.15, 0.5)),
                                material=mat())
                       for _ in range(48)])
    for _ in range(8):
        c = centre(-2.5, 2.5, -0.8, 1.2)
        chain = chain.union(m.sphere(center=c, radius=float(rng.uniform(0.2, 0.45)), material=mat()),
                            k=float(rng.uniform(0.1, 0.3)))
    for _ in range(4):
        chain = chain - m.sphere(center=centre(-2.5, 2.5, -0.8, 1.2), radius=float(rng.uniform(0.3, 0.6)),
                                 material=mat())
    for _ in range(4):
        c = centre(-2.5, 2.5, -0.8, 1.2)
        chain = chain.subtract(m.sphere(center=c, radius=float(rng.uniform(0.3, 0.6)), material=mat()),
                               k=float(rng.uniform(0.1, 0.25)))
    parts = []
    for _ in range(16):
        c = np.asarray(centre(-3, 3, -1.0, 1.5))
        base = m.sphere(center=tuple(c), radius=float(rng.uniform(0.25, 0.5)))
        off = rng.uniform(-0.35, 0.35, 3)
        blob = m.sphere(center=tuple(c + off), radius=float(rng.uniform(0.15, 0.3)))
        dent = m.sphere(center=tuple(c - off), radius=float(rng.uniform(0.15, 0.3)))
        parts.append(base.union(blob, k=float(rng.uniform(0.1, 0.25))).subtract(
            dent, k=float(rng.uniform(0.1, 0.2))))
    for _ in range(16):
        parts.append(m.sphere(center=centre(-3, 3, -1.0, 1.5), radius=float(rng.uniform(0.15, 0.5))))
    return spheres, chain, union_all(parts)


def scene_balanced(m, n, seed, span, y_hi):
    """n random spheres in a balanced binary tree of hard unions, as
    bench.py builds its 256- and 1024-leaf scenes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n):
        c = rng.uniform(-span, span, 3)
        c[1] = rng.uniform(-1.0, y_hi)
        parts.append(m.sphere(center=tuple(c), radius=float(rng.uniform(0.15, 0.45))))
    while len(parts) > 1:
        parts = [parts[i] | parts[i + 1] if i + 1 < len(parts) else parts[i] for i in range(0, len(parts), 2)]
    return parts[0]


def scene_bench256(m):
    """bench.py:499-512, the scene of `256leaf_compact` (seed 21)."""
    return scene_balanced(m, 256, 21, 6, 2.0)


def scene_bench1024(m):
    """bench.py:541-554, the scene of `1024leaf_compact` (seed 33)."""
    return scene_balanced(m, 1024, 33, 12, 2.5)


def scene_painted(m, n=64):
    """bench.py:805-820: n painted random spheres (seed 17) in one hard
    union, the scene of `fwdbwd_64leaf_painted`."""
    import numpy as np

    rng = np.random.default_rng(17)
    parts = []
    for _ in range(n):
        c = rng.uniform(-3, 3, 3)
        c[1] = rng.uniform(-1.0, 1.5)
        parts.append(m.sphere(center=tuple(c), radius=float(rng.uniform(0.15, 0.5)),
                              material=tuple(rng.uniform(0.1, 0.9, 3))))
    scene = parts[0]
    for p in parts[1:]:
        scene = scene | p
    return scene


def scene_rotated_mixed(m):
    """tests/test_pallas_grad.py:362-376: a rotated pool of mixed types."""
    return (
        m.sphere(center=(-1.0, 0.1, 0.0), radius=0.6)
        | m.box(center=(0.9, 0.0, -0.1), half_extents=(0.45, 0.35, 0.4),
                rotation=(0.9238795, 0.0, 0.3826834, 0.0))
        | m.torus(center=(0.0, 0.8, 0.1), major_radius=0.55, minor_radius=0.18,
                  rotation=(0.9689124, 0.2474040, 0.0, 0.0))
        | m.capsule(center=(1.6, 0.4, 0.6), radius=0.22, half_height=0.45)
    )


# --- the roofline bound -------------------------------------------------------
# An H100 SXM's published peaks (NVIDIA's H100 datasheet): f32
# outside the tensor cores, and HBM. Operation counts come from this run's
# inputs: the plain versions count the scene and leaf evaluations each pass
# needs (`cuda_prepass.WorkCount`), the residuals count the hit rays, and the
# fine lists the leaves each hit ray's tile keeps. Each evaluation is priced
# by the f32 operations (add, mul, min/max, abs, sqrt, compare; an FMA = 2)
# of its formula in csrc/scene_eval.cuh, csrc/scene_grad.cuh and the kernels.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
LEAF_OPS = {0: 11, 1: 25, 2: 6, 3: 17, 4: 21, 5: 17, 6: 44}  # ops/opcodes.py LEAF_*
ROT_OPS = 30  # the inverse quaternion rotation of a rotated leaf
COMBINE_OPS = {2: 1, 3: 1, 4: 2, 5: 10, 6: 12, 7: 12, 8: 1, 9: 2}  # COP_* ops
STEP_OPS = 14  # one march step: the point (3 FMA), the tests, the update
RAY_OPS = 60  # screen coordinates, the view ray, the bound clip
SHADE_OPS = 60  # normal, light, Lambert, gamma of a hit ray (fine kernel)
FLOOR_OPS = 40  # the checker floor and gamma of every ray
ADJ_RAY_OPS = 230  # the shading adjoint and the camera adjoint of a hit ray
# The reverse of a formula whose forward values are at hand: ~2x its
# operations. A backward needs, per hit ray, the scene at the 4 taps and the
# hit point once each and the reverse of those 5 evaluations (the one at the
# hit point gives grad_x F and, scaled by w, dF/dtheta); the kernels' extra
# forward replays and their sixth reverse pass are their own redundant work.
ADJ_FACTOR = 2


def row_ops(spec):
    """{leaf row: ops of one evaluation of that leaf} of a static spec."""
    return {r: LEAF_OPS[t] + (ROT_OPS if spec.rotated_types[t] else 0)
            for t, start, stop in spec.type_slices for r in range(start, stop)}


def scene_cost(spec):
    """(pushed leaves, mean ops of one leaf evaluation, ops of the combine
    instructions of one tape evaluation) of a static spec."""
    rows = row_ops(spec)
    pushed = [a for c, a, _ in spec.static_tape if c == 1]
    comb = sum(COMBINE_OPS.get(c, 0) for c, _, _ in spec.static_tape if c != 1)
    return len(pushed), sum(rows[a] for a in pushed) / max(len(pushed), 1), comb


def stack_of(sc) -> str:
    """K1/K2's value-stack route for the scene buffers `sc` (csrc/scene_eval.cuh,
    cuda_march.stack_route) and its stack depth; the packed words and leaf
    rows are read through L1 (no staging in shared memory)."""
    from raymarch_tpu_torch.ops import cuda_march as cm

    return (f"{cm.route_name(cm.stack_route(sc.spec))}, stack depth {sc.spec.stack_depth}; words and leaf rows "
            "through L1, unstaged")


def roofline(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the f32 peak
    and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def march_flops(work, rays, spec, compact, hit_rays=0.0, fine=False):
    """Operations of a forward pass from its counted work: per ray the
    raygen (and, fine, the floor and gamma), per point a march step and the
    tape's combine (a compact fold: one min per leaf), per leaf evaluation
    its formula, per hit ray the shading."""
    n_push, leaf_ops, comb = scene_cost(spec)
    points, leaf_evals = float(work.points), float(work.leaf_evals)
    per_point = STEP_OPS + (0 if compact else comb)
    per_leaf = leaf_ops + (1 if compact else 0)
    flops = rays * (RAY_OPS + (FLOOR_OPS if fine else 0)) + points * per_point + leaf_evals * per_leaf
    return flops + hit_rays * SHADE_OPS


def card_clocks() -> str:
    """The card's SM and memory clocks, their maxima, temperature and power
    draw now, as nvidia-smi reads them (logged beside the headline times)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,clocks.max.mem,temperature.gpu,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() if out.returncode == 0 else f"not read ({out.stderr.strip()})"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def neigh_diff(img, ref):
    """Per-pixel min of |img - ref| over ref's 3x3 neighbourhood (bench.py
    _neigh_diff), on torch tensors f32[H, W, 3]."""
    import torch

    h, w, _ = img.shape
    best = torch.full((h, w), float("inf"), device=img.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = slice(max(0, dy), h + min(0, dy))
            xs = slice(max(0, dx), w + min(0, dx))
            ys2 = slice(max(0, -dy), h + min(0, -dy))
            xs2 = slice(max(0, -dx), w + min(0, -dx))
            dd = (img[ys, xs] - ref[ys2, xs2]).abs().amax(-1)
            best[ys, xs] = torch.minimum(best[ys, xs], dd)
    return best


def image_class(name, img, ref):
    """Accelerated-path class (bench.py:249-253): mean |d| < 5e-4 and under
    0.8% of pixels off by > 1e-2 after the 3x3 neighbour match."""
    d = (img - ref).abs()
    mean, mx = float(d.mean()), float(d.max())
    frac = float((neigh_diff(img, ref) > 0.01).float().mean())
    ok = mean < 5e-4 and frac < 0.008
    log(f"{name}: mean|d|={mean:.3e} max|d|={mx:.3e} frac_n>1e-2={frac:.5f} "
        f"(need mean<5e-4, frac<0.008) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")
    return mx


def coarse_agreement(name, k, p, strict, exact=False):
    """Coarse planes of kernel vs plain: status agrees on >= 99.9% of pixels,
    and t0 agrees within rtol 1e-4 where both statuses are 1 — at every such
    pixel when `strict`, else at all but 0.1% of them (a centre ray whose
    slack lands within rounding of min_dist takes one step of ~min_dist more
    or less in one of the two). With `exact`, both planes must also be
    equal at every pixel (the kernel rounds as its plain version: K3).
    Returns max |t0 diff| where both statuses are 1."""
    (t0k, stk), (t0p, stp) = k, p
    agree = float((stk == stp).float().mean())
    both = (stk == 1) & (stp == 1)
    n = int(both.sum())
    dt = (t0k - t0p).abs()[both]
    rel = dt / t0p.abs()[both].clamp_min(1e-30)
    rel_max = float(rel.max()) if n else 0.0
    off = float((rel > 1e-4).float().mean()) if n else 0.0
    mx = float(dt.max()) if n else 0.0
    ok = agree >= 0.999 and n > 0 and (rel_max <= 1e-4 if strict else off < 1e-3)
    need = "rel<=1e-4 everywhere" if strict else "share rel>1e-4 < 1e-3"
    if exact:
        n_st, n_t0 = int((stk != stp).sum()), int((t0k != t0p).sum())
        ok = ok and n_st == 0 and n_t0 == 0
        need += f"; equal at every pixel: status differs at {n_st}, t0 at {n_t0} of {stk.numel()}"
    log(f"{name}: status agree={agree:.6f} (need >=0.999) t0 max rel={rel_max:.3e} "
        f"share rel>1e-4={off:.3e} max|d|={mx:.3e} over {n} px (need {need}) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")
    return mx


def interval_agreement(name, k, p):
    """Interval planes of kernel vs plain (starts then ends, 3.0e38 for "no
    interval"): each plane's finite pattern agrees on >= 99.9% of blocks,
    and where both are finite the values agree within rtol 1e-4 on all but
    0.1% of them, as `coarse_agreement` holds t0. Returns max |diff| there."""
    agree, n, off, mx = 1.0, 0, 0, 0.0
    for a, b in zip(k, p):
        fa, fb = a < 9e37, b < 9e37
        agree = min(agree, float((fa == fb).float().mean()))
        both = fa & fb
        n += int(both.sum())
        if bool(both.any()):
            d = (a - b).abs()[both]
            off += int((d / b.abs()[both].clamp_min(1e-30) > 1e-4).sum())
            mx = max(mx, float(d.max()))
    share = off / max(n, 1)
    ok = len(k) == len(p) and agree >= 0.999 and n > 0 and share < 1e-3
    log(f"{name}: {len(k)} planes, pattern agree={agree:.6f} (need >=0.999) share rel>1e-4={share:.3e} "
        f"max|d|={mx:.3e} over {n} finite values (need share < 1e-3) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")
    return mx


def residual_agreement(name, k, p, strict):
    """Residuals of the fine kernel vs fine_res_plain: hit agrees on >= 99.9%
    of AA rays, and t within rtol 1e-4 where both hit — at every such ray
    when `strict`, else at all but 0.1% of them (a ray whose slack lands
    within rounding of min_dist takes one step of ~min_dist more or less in
    one of the two, as the coarse planes do). Returns max |t diff|."""
    (tk, hk), (tp, hp) = k, p
    agree = float((hk == hp).float().mean())
    both = (hk == 1) & (hp == 1)
    n = int(both.sum())
    dt = (tk - tp).abs()[both]
    rel = dt / tp.abs()[both].clamp_min(1e-30)
    rel_max = float(rel.max()) if n else 0.0
    off = float((rel > 1e-4).float().mean()) if n else 0.0
    mx = float(dt.max()) if n else 0.0
    ok = agree >= 0.999 and n > 0 and (rel_max <= 1e-4 if strict else off < 1e-3)
    need = "rel<=1e-4 everywhere" if strict else "share rel>1e-4 < 1e-3"
    log(f"{name}: hit agree={agree:.6f} (need >=0.999) t max rel={rel_max:.3e} share rel>1e-4={off:.3e} "
        f"max|d|={mx:.3e} over {n} hit rays (need {need}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")
    return mx


def grad_class(name, got, ref):
    """Backward kernel vs bwd_plain, the reference's class for two f32
    implementations of this backward (tests/test_pallas_grad.py:78-105):
    |d| <= 0.01 max|d_lp| for the leaf and op words, <= 0.02 max|d_cam| for
    the camera; d_cam[7] == 0. Returns the max abs error."""
    scale = float(ref[0].abs().max())
    cscale = float(ref[2][:7].abs().max())
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    rels = [errs[0] / scale, errs[1] / scale, errs[2] / cscale]
    ok = (scale > 0 and errs[0] <= 0.01 * scale and errs[1] <= 0.01 * scale
          and errs[2] <= 0.02 * cscale and float(got[2][7]) == 0.0
          and all(bool(torch_isfinite(g)) for g in got))
    log(f"{name}: max|d| lp {errs[0]:.3e} op {errs[1]:.3e} cam {errs[2]:.3e}; relative to "
        f"max|g| (lp/op {scale:.4e}, cam {cscale:.4e}): {rels[0]:.3e} {rels[1]:.3e} {rels[2]:.3e} "
        f"(need <=0.01, <=0.01, <=0.02; d_cam[7]={float(got[2][7])}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")
    return max(errs)


def torch_isfinite(x):
    import torch

    return torch.isfinite(x).all()


def seeded_cotangent(h, w, dev, seed):
    import numpy as np
    import torch

    g = np.random.default_rng(seed).uniform(-1.0, 1.0, (h, w, 3)).astype(np.float32)
    return torch.tensor(g, device=dev)


def cuda_ms(fn, reps):
    """Mean device ms of `fn` over `reps` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_idle_share(fn, steps, step_ms):
    """(idle share, device ms per run) of `fn`, or (None, None) when the
    profiler saw no device time. One torch.profiler session runs `fn`
    once, pauses IDLE_PAUSE_S, then runs it `steps` times: the profiler
    can lose device events, a session's first run's among them, so every
    event before the pause is dropped (callers check the device time
    against the kernels alone). The device time is that of the device
    events (kernels, copies, fills; no user annotations) of the `steps`
    runs, intervals merged; the share is 1 - that time / `step_ms`, the
    CUDA-event time of one run in the timed loop (the profiler stretches
    its own runs' wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(IDLE_PAUSE_S)
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and e.time_range.end > e.time_range.start
    )
    end = None
    for k, (a, b) in enumerate(spans):
        if end is not None and a - end > 0.8 * IDLE_PAUSE_S * 1e6:
            spans = spans[k:]
            break
        end = b if end is None else max(end, b)
    if not spans:
        return None, None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    busy_ms = busy / steps / 1e3
    return max(0.0, 1.0 - busy_ms / step_ms), busy_ms


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def kernel_device_ms(fn, kernel, reps=30):
    """Mean device ms of one launch of the kernel whose symbol holds
    `kernel`, over the launches torch.profiler recorded in `reps` runs of
    `fn` after one warm-up, or None when it recorded none. The profiler can
    lose a session's events (some runs' or all), so the mean is taken over
    the launches it kept, never a sum divided by `reps`. For a kernel too
    short for CUDA events over back-to-back launches, which then time the
    host's calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
             and e.time_range.end > e.time_range.start]
    return sum(spans) / len(spans) / 1e3 if spans else None


def device_ops(fn):
    """Operations (kernels, copies, fills) that torch.profiler sees on the
    card in one synchronised run of `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def cull_ops(rp, sc, cam):
    """(device operations of one frame's masks and lists, of the
    pairwise path loop `culling._pairwise_path_ksum` within them)."""
    from raymarch_tpu_torch.ops import culling

    orig = culling._pairwise_path_ksum
    args = []

    def spy(*a):
        args.append(a)
        return orig(*a)

    culling._pairwise_path_ksum = spy
    try:
        n_all = device_ops(lambda: rp.cull_args(sc, cam))
    finally:
        culling._pairwise_path_ksum = orig
    return n_all, device_ops(lambda: orig(*args[0]))


def culling_depth(spec):
    """The longest root path of the scene's tree: the pairwise path loop's
    trip count."""
    from raymarch_tpu_torch.ops import culling

    pd = culling._leaf_path_data(spec)
    return None if pd is None else pd["path_op"].shape[1]


def hit_pixels(hit):
    """Pixels with at least one AA ray that hit: the backward reads their
    cotangent, and no other's."""
    return float((hit.amax(-1) > 0).sum())


def many_leaf(rt, cp, cg, dev, smi, cfg, gcam_pos):
    """Phase 9: the culled forward, the compact backward and the 64-leaf
    training step (see the module docstring). Returns the kernel records
    of the compact backward and the numbers the summary prints."""
    import numpy as np
    import torch

    cfg64 = dataclasses.replace(cfg, relax=1.6, leaf_cull=True)
    clamp = float(cfg64.grad_denom_clamp)

    # -- 9a. gates at 256x144 ---------------------------------------------
    gates = (
        ("spheres64", scene_spheres, (0.0, 2.5, 9.0)),
        ("rotated_mixed", scene_rotated_mixed, (0.3, 1.8, 5.0)),
        ("config2", scene_config2, gcam_pos),
        ("rich", scene_rich, gcam_pos),
    )
    for gname, build, pos in gates:
        spec_g, arrays_g = rt.compile_scene(build(rt), static=True)
        cv_g = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0, 0, 0)), device=dev)
        rp = cp.make_pallas_image_render_aa(spec_g, cfg64, GATE_W, GATE_H, device=dev)
        sc, cam, bnd = rp.scene_args(arrays_g, cv_g)
        cc, fc = rp.cull_args(sc, cam)
        how = "item lists" if fc.compact else "gated tape"
        pre_k = cp.coarse(sc, cam, bnd, rp.params, cc)
        coarse_agreement(f"gate culled coarse kernel vs coarse_plain, {gname} ({how})", pre_k,
                         cp.coarse_plain(sc, cam, bnd, rp.params, cc), strict=True)
        img_k = cp.fine(sc, cam, bnd, rp.params, *pre_k, cull=fc)
        image_class(f"gate culled relaxed fine kernel vs fine_plain, {gname} ({how})", img_k,
                    cp.fine_plain(sc, cam, bnd, rp.params, *pre_k, cull=fc))
        img_r, t_k, hit_k = cp.fine_res(sc, cam, bnd, rp.params, *pre_k, cull=fc)
        if not torch.equal(img_r, img_k):
            raise AssertionError("the residual output changed the culled fine kernel's image")
        img_p, t_p, hit_p = cp.fine_res_plain(sc, cam, bnd, rp.params, *pre_k, cull=fc)
        image_class(f"gate culled fine kernel with residuals vs fine_res_plain, {gname}", img_r, img_p)
        residual_agreement(f"gate culled residuals vs fine_res_plain, {gname}", (t_k, hit_k), (t_p, hit_p),
                           strict=False)
        g_img = seeded_cotangent(GATE_H, GATE_W, dev, 11)
        if gname in ("spheres64", "rotated_mixed"):
            fr = cg.make_fused_render_vjp(spec_g, cfg64, GATE_W, GATE_H, device=dev)
            if fr.backward_info["kind"] != "pallas_compact":
                raise AssertionError(f"{gname} did not take the compact backward: {fr.backward_info}")
            got = cg.compact_bwd(sc, fc, cam, rp.params, clamp, t_k, hit_k, g_img)
            again = cg.compact_bwd(sc, fc, cam, rp.params, clamp, t_k, hit_k, g_img)
            ref = cg.compact_bwd_plain(sc, fc, cam, rp.params, clamp, t_k, hit_k, g_img)
            grad_class(f"gate compact_bwd kernel vs compact_bwd_plain, {gname} ({int(hit_k.sum())} hit "
                       f"rays, mean {float(fc.counts.sum(1).float().mean()):.3f} active leaves per fine tile)",
                       got, ref)
            rerun = max(float((a - b).abs().max()) for a, b in zip(got, again)) / float(ref[0].abs().max())
            log(f"  compact_bwd run to run (shared atomics): max|d| / max|g| = {rerun:.3e}")
        elif gname == "rich":
            fr = cg.make_fused_render_vjp(spec_g, cfg64, GATE_W, GATE_H, device=dev)
            if fr.backward_info["kind"] != "pallas_legacy_unrolled":
                raise AssertionError(f"rich should take the legacy backward: {fr.backward_info}")
            grad_class("gate culled forward then fused_bwd kernel vs bwd_plain, rich "
                       f"({fr.backward_info['reason']})",
                       cg.bwd(sc, cam, rp.params, fr.layout, t_k, hit_k, g_img),
                       cg.bwd_plain(sc, cam, rp.params, fr.layout, t_k, hit_k, g_img))
    torch.cuda.synchronize()

    # -- 9b. the 64-leaf fwd+bwd step at full size ------------------------
    spec64, arrays64 = rt.compile_scene(scene_spheres(rt), static=True)
    camera64 = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
    cv64 = rt.cam_vec(camera64, device=dev)
    render64 = rt.make_renderer(spec64, WIDTH, HEIGHT, cfg64, mode="implicit", backend="pallas_fused", device=dev)
    if render64.backward_info["kind"] != "pallas_compact" or render64.backward_info["reason"] is not None:
        raise AssertionError(f"the 64-leaf scene must take the compact backward: {render64.backward_info}")
    lp64 = torch.tensor(arrays64.leaf_params, device=dev)
    op64 = torch.tensor(arrays64.op_param, device=dev)
    n_rays = WIDTH * HEIGHT * cfg64.aa_samples ** 2

    def fwd_bwd():
        lp = lp64.clone().requires_grad_(True)
        opp = op64.clone().requires_grad_(True)
        cv = cv64.clone().requires_grad_(True)
        img = render64.renderer(dataclasses.replace(arrays64, leaf_params=lp, op_param=opp), cv)
        loss = torch.mean(img * img)
        loss.backward()
        return img, loss, (lp.grad, opp.grad, cv.grad)

    cp.reset_launch_counts()
    cg.reset_launch_counts()
    for _ in range(BWD_WARMUP):
        fwd_bwd()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    e0.record()
    for _ in range(BWD_STEPS):
        img64, loss64, grads64 = fwd_bwd()
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / BWD_STEPS
    step_ms = e0.elapsed_time(e1) / BWD_STEPS
    launches = {"coarse_kernel": cp.coarse.launches, "fine_kernel_residuals": cp.fine_res.launches,
                "compact_bwd_kernel": cg.compact_bwd.launches, "fused_bwd_kernel": cg.bwd.launches}
    log(f"64-leaf training step (fwdbwd_64leaf_compact: cull + relax, no intervals) {WIDTH}x{HEIGHT} "
        f"x{cfg64.aa_samples ** 2} AA, fwd+bwd of mean(img^2): {step_ms:.4f} ms/step (CUDA events, "
        f"{BWD_STEPS} steps after {BWD_WARMUP} warm-up; host clock {host_ms:.4f} ms), "
        f"{n_rays / (step_ms * 1e-3) / 1e9:.4f} Grays/s on {smi}")
    log(f"launches in the 64-leaf training run: {launches}")
    if min(launches[k] for k in ("coarse_kernel", "fine_kernel_residuals", "compact_bwd_kernel")) <= 0:
        raise AssertionError(f"a kernel of the 64-leaf training path never launched: {launches}")
    if launches["fused_bwd_kernel"] != 0:
        raise AssertionError("the 64-leaf step ran the legacy backward")
    if not all(bool(torch.isfinite(g).all()) for g in grads64) or float(grads64[0].abs().max()) <= 0:
        raise AssertionError("the 64-leaf gradients are not finite or all zero")
    idle, busy = device_idle_share(fwd_bwd, 3, step_ms)
    log(f"64-leaf step device idle share (device time of 3 profiled steps against the timed step): "
        f"{'not measured (no device events)' if idle is None else f'{idle:.4f} ({busy:.4f} ms busy a step)'} "
        f"({smi})")

    fr64 = render64.renderer
    rp64 = fr64.prepass
    p64 = rp64.params
    sc, cam, bnd = rp64.scene_args(arrays64, cv64)
    cc, fc = rp64.cull_args(sc, cam)
    active_mean = float(fc.counts.sum(1).float().mean())
    pre_k = cp.coarse(sc, cam, bnd, p64, cc)
    img_r, t_k, hit_k = cp.fine_res(sc, cam, bnd, p64, *pre_k, cull=fc)
    hit_frac = float(hit_k.mean())
    g_img = 2.0 * img_r / img_r.numel()  # the cotangent of mean(img^2)
    log(f"64-leaf frame: mean {active_mean:.4f} active leaves per {cp.FINE_TILE}x{cp.FINE_TILE} fine tile "
        f"({fc.counts.shape[0]} tiles, max {int(fc.counts.sum(1).max())}), coarse tiles "
        f"{float(cc.counts.sum(1).float().mean()):.4f}; hit fraction {hit_frac:.4f} of {n_rays} AA rays")
    coarse_ms = cuda_ms(lambda: cp.coarse(sc, cam, bnd, p64, cc), KERNEL_REPS)
    fine_res_ms = cuda_ms(lambda: cp.fine_res(sc, cam, bnd, p64, *pre_k, cull=fc), KERNEL_REPS)
    cbwd_ms = cuda_ms(lambda: cg.compact_bwd(sc, fc, cam, p64, clamp, t_k, hit_k, g_img), KERNEL_REPS)
    cull_ms = cuda_ms(lambda: rp64.cull_args(sc, cam), KERNEL_REPS)
    log(f"64-leaf kernels alone: coarse {coarse_ms:.4f} ms, fine with residuals {fine_res_ms:.4f} ms, "
        f"compact_bwd {cbwd_ms:.4f} ms; per-frame masks and lists (torch ops) {cull_ms:.4f} ms ({smi})")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    n_cull, n_ksum = cull_ops(rp64, sc, cam)
    log(f"64-leaf masks and lists: {n_cull} device operations per frame (torch.profiler), of which the "
        f"pairwise path loop (_pairwise_path_ksum, path depth {culling_depth(spec64)}) {n_ksum}")

    got = cg.compact_bwd(sc, fc, cam, p64, clamp, t_k, hit_k, g_img)
    torch.cuda.synchronize()
    e0.record()
    ref = cg.compact_bwd_plain(sc, fc, cam, p64, clamp, t_k, hit_k, g_img, band_rows=32)
    e1.record()
    torch.cuda.synchronize()
    cbwd_plain_ms = e0.elapsed_time(e1)
    cbwd_err = grad_class("full-size compact_bwd kernel vs compact_bwd_plain (32-row bands)", got, ref)
    grad_class("64-leaf training-path gradients vs compact_bwd_plain", grads64, ref)
    del ref
    work_c = cp.WorkCount()
    e0.record()
    pre_p = cp.coarse_plain(sc, cam, bnd, p64, cc, work=work_c)
    e1.record()
    torch.cuda.synchronize()
    coarse_plain_ms = e0.elapsed_time(e1)
    coarse_err = coarse_agreement("full-size culled coarse kernel vs coarse_plain, 64 leaves", pre_k, pre_p,
                                  strict=False)
    work_f = cp.WorkCount()
    e0.record()
    img_p, t_p, hit_p = cp.fine_res_plain(sc, cam, bnd, p64, *pre_k, cull=fc, work=work_f)
    e1.record()
    torch.cuda.synchronize()
    fine_res_plain_ms = e0.elapsed_time(e1)
    fine_err = image_class("full-size culled fine kernel with residuals vs fine_res_plain, 64 leaves", img_r,
                           img_p)
    residual_agreement("full-size culled residuals vs fine_res_plain, 64 leaves", (t_k, hit_k), (t_p, hit_p),
                       strict=False)
    del img_p, t_p, hit_p

    # Bounds of the 64-leaf kernels from this run's counted work.
    n_px = WIDTH * HEIGHT
    list_bytes = 4 * (fc.lists.numel() + fc.counts.numel())
    *cbwd_bound, cbwd_flops, cbwd_bytes = k9_bound(sc, fc, p64, cam, t_k, hit_k, n_rays)
    coarse_bound = roofline(march_flops(work_c, n_px, spec64, True), n_px * 8 + 4 * (cc.lists.numel() + cc.counts.numel()))
    fine_bound = roofline(march_flops(work_f, n_rays, spec64, True, float(work_f.hits), fine=True),
                       n_px * 20 + n_rays * 8 + list_bytes)
    log(f"64-leaf counted work: coarse {float(work_c.leaf_evals):.6e} leaf evaluations, fine "
        f"{float(work_f.leaf_evals):.6e}, compact_bwd {cbwd_flops:.6e} operations, {cbwd_bytes:.6e} bytes "
        f"at 5 points of {float(hit_k.sum()):.0f} hit rays; bounds coarse "
        f"{coarse_bound[0]:.4f} ms, fine with residuals {fine_bound[0]:.4f} ms, compact_bwd "
        f"{cbwd_bound[0]:.4f} ms ({cbwd_bound[1]})")

    # -- 9c. full-size culled frames against the un-culled plain path -------
    render_f64 = rt.make_renderer(spec64, WIDTH, HEIGHT, cfg64, mode="forward", backend="pallas_prepass", device=dev)
    frame64 = render_f64(arrays64, camera64)
    for fname, spec_c, arrays_c, camera_c, frame_c in (
        ("64 leaves", spec64, arrays64, camera64, frame64),
        ("config 2", *rt.compile_scene(scene_config2(rt), static=True),
         rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0, 0, 0)), None),
    ):
        if frame_c is None:
            frame_c = rt.make_renderer(spec_c, WIDTH, HEIGHT, cfg64, mode="forward", backend="pallas_prepass",
                                       device=dev)(arrays_c, camera_c)
        off = cp.make_pallas_image_render_aa(spec_c, dataclasses.replace(cfg64, leaf_cull=False), WIDTH, HEIGHT,
                                             device=dev)
        image_class(f"full-size culled frame vs the un-culled plain path, {fname}", frame_c,
                    off.render_plain(arrays_c, rt.cam_vec(camera_c, device=dev)))
    torch.cuda.synchronize()

    # -- 9d. the 64-leaf forward frame -----------------------------------
    for _ in range(WARMUP):
        render_f64(arrays64, camera64)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(FRAMES):
        frame64 = render_f64(arrays64, camera64)
    e1.record()
    torch.cuda.synchronize()
    fwd64_ms = e0.elapsed_time(e1) / FRAMES
    log(f"64-leaf forward frame (cull + relax, no intervals; not the reference's 64leaf_cull_intervals row) "
        f"{WIDTH}x{HEIGHT} x{cfg64.aa_samples ** 2} AA through make_renderer(backend='pallas_prepass'): "
        f"{fwd64_ms:.4f} ms/frame, {n_rays / (fwd64_ms * 1e-3) / 1e9:.4f} Grays/s on {smi}")

    # -- 9e. a 5-step 1080p fit of one sphere's centre --------------------
    truth = arrays64.leaf_params
    lpn = np.asarray(truth)
    row = int(np.argmax(lpn[:, 7]))  # the largest sphere
    start = truth.copy()
    start[row, 4] -= 0.12
    mask = np.zeros_like(truth)
    mask[row, 4] = 1.0
    fit_kw = dict(width=WIDTH, height=HEIGHT, cfg=cfg64, learning_rate=1e-2, leaf_mask=mask,
                  backend="pallas_fused", device=dev)
    rt.fit_scene(spec64, dataclasses.replace(arrays64, leaf_params=start), camera64, frame64, steps=1,
                 log_fn=lambda m: None, **fit_kw)
    res = rt.fit_scene(spec64, dataclasses.replace(arrays64, leaf_params=start), camera64, frame64,
                       steps=FIT_STEPS, log_fn=lambda m: None, **fit_kw)
    cx = float(res.arrays.leaf_params[row, 4])
    log(f"64-leaf fit at {WIDTH}x{HEIGHT} ({FIT_STEPS} Adam steps, lr 1e-2, sphere row {row}): loss "
        f"{res.losses[0]:.6e} -> {res.losses[-1]:.6e}; cx {start[row, 4]:+.4f} -> {cx:+.4f} (truth "
        f"{truth[row, 4]:+.4f}); {1.0 / res.steps_per_sec:.4f} s/step; backward {res.backward_info} ({smi})")
    if res.backward_info["kind"] != "pallas_compact":
        raise AssertionError("the 64-leaf fit did not train through the compact backward")
    if not (res.losses[-1] < res.losses[0] and abs(cx - truth[row, 4]) < abs(start[row, 4] - truth[row, 4])):
        raise AssertionError("the 64-leaf fit did not move toward the truth")

    # The culled builds' records: launches of the 64-leaf training run,
    # times and errors of the full-size checks above.
    records = [
        dict(name="coarse_kernel (culled lists)", route="cuda", source="raymarch_tpu_torch/csrc/prepass.cu",
             replaces="raymarch_tpu/ops/pallas_prepass.py:885", launches=launches["coarse_kernel"],
             max_abs_err=coarse_err, ms=coarse_ms, plain_ms=coarse_plain_ms, bound_ms=coarse_bound[0],
             bound_by=coarse_bound[1], library_ms=None),
        dict(name="fine_kernel (culled, relax, residuals)", route="cuda",
             source="raymarch_tpu_torch/csrc/fine_culled.cu", replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
             launches=launches["fine_kernel_residuals"], max_abs_err=fine_err, ms=fine_res_ms,
             plain_ms=fine_res_plain_ms, bound_ms=fine_bound[0], bound_by=fine_bound[1], library_ms=None),
        dict(name="compact_bwd_kernel", route="cuda", source="raymarch_tpu_torch/csrc/compact_bwd.cu",
             replaces="raymarch_tpu/ops/pallas_grad.py:256", launches=launches["compact_bwd_kernel"],
             max_abs_err=cbwd_err, ms=cbwd_ms, plain_ms=cbwd_plain_ms, bound_ms=cbwd_bound[0],
             bound_by=cbwd_bound[1], library_ms=None),
    ]
    summary = dict(step_ms=step_ms, fwd64_ms=fwd64_ms, idle=idle, active_mean=active_mean, hit_frac=hit_frac,
                   cull_ms=cull_ms, n_cull=n_cull, n_ksum=n_ksum)
    return records, summary


FOLD_OPS = 12  # one ordered fold step of a smooth item (scene_eval.cuh fold_step)
SELECT_OPS = 2  # a pool or free item, or a hard ordered step: compare and select (a min or max)
COLOR_OPS = 20  # a leaf's colour in the colour pass: the flag mix and the select


def k9_work(sc, cull, p, cam, t, hit, band_rows=64):
    """(forward, reverse) operations of the compact scene at the point o +
    d t of every AA ray where `hit` > 0 (the hit rays; in soft mode any ray
    mask and point parameter), summed over the frame, as
    `scene_compact_plain` itself records its items (cuda_march.FoldWork). Forward: each active list item
    at its leaf's operations plus a select or a smooth fold step. Reverse:
    ADJ_FACTOR x the same for each item whose leaf value the distance's
    cotangent reaches (the pool's or a free prefix's winner, and the items
    of the winning ordered source that its steps pass it to)."""
    import torch

    from raymarch_tpu_torch.ops import cuda_march as cm
    from raymarch_tpu_torch.ops import cuda_prepass as cp

    ops = row_ops(sc.spec)
    plan = cm.build_compact_plan(sc.spec)
    fwd = rev = torch.zeros((), dtype=torch.float64, device=cam.device)
    for i0 in range(0, p.rows, band_rows):
        n = min(band_rows, p.rows - i0)
        h = hit[i0:i0 + n] > 0
        if not bool(h.any()):
            continue
        x, y = cp.aa_screen(p, cam, i0, n)
        dx, dy, dz = cp._view_dirs(x, y, cam, p)
        tt = t[i0:i0 + n]
        px, py, pz = (cam[0] + dx * tt)[h], (cam[1] + dy * tt)[h], (cam[2] + dz * tt)[h]
        i = torch.arange(i0, i0 + n, device=cam.device)[:, None, None]
        j = torch.arange(p.width, device=cam.device)[None, :, None]
        tid = cull.tile_index(i, j).expand(h.shape)[h]
        work = cm.FoldWork()
        d = cm.scene_compact_plain(sc, plan, cp.tile_active(sc.spec, cull, tid), px, py, pz, work=work)
        for (row, smooth, active, _), reached in zip(work.items, work.reached(d)):
            cost = ops[row] + (FOLD_OPS if smooth else SELECT_OPS)
            fwd = fwd + cost * active.sum()
            rev = rev + ADJ_FACTOR * cost * reached.sum()
    return float(fwd), float(rev)


def k9_bound(sc, cull, p, cam, t, hit, n_rays):
    """(bound_ms, bound_by, operations, bytes) of the compact backward on
    this run's residuals, counting the function's need: the scene at the 4
    taps and the hit point once each and the reverse of the winning source
    at those 5 points (`k9_work`), the ray's shading and camera adjoint, and
    on a painted scene the winner's albedo; hit read for every AA ray, t for
    the hit rays, the cotangent of their pixels, the lists once, one
    gradient row written. The kernel's replays are its own redundant work."""
    spec = sc.spec
    fwd, rev = k9_work(sc, cull, p, cam, t, hit)
    n_hits = float(hit.sum())
    flops = 5 * (fwd + rev) + n_hits * (ADJ_RAY_OPS + (COLOR_OPS if spec.has_materials else 0))
    nbytes = (n_rays * 4 + n_hits * 4 + hit_pixels(hit) * 12 + 4 * (cull.lists.numel() + cull.counts.numel())
              + 4 * (16 * spec.n_leaves + spec.n_instr + 7))
    ms, by = roofline(flops, nbytes)
    return ms, by, flops, nbytes


def blends(rt, cp, cg, dev, smi, cfg, gcam_pos):
    """Phase 10: training of many-primitive scenes with smooth blends,
    subtractions and painted materials (see the module docstring). Returns
    the kernel records of K9 per plan kind and of K2 with materials, and
    the numbers the summary prints."""
    import numpy as np
    import torch

    cfg64 = dataclasses.replace(cfg, relax=1.6, leaf_cull=True)
    clamp = float(cfg64.grad_denom_clamp)
    _, scene_chain, scene_cl = scenes_bench64(rt)
    camera64 = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
    cv64 = rt.cam_vec(camera64, device=dev)
    built = {name: rt.compile_scene(s, static=True)
             for name, s in (("cluster", scene_cl), ("chain", scene_chain), ("painted", scene_painted(rt)))}

    # -- 10a. gates at 256x144 --------------------------------------------
    gates = (
        ("config2", *rt.compile_scene(scene_config2(rt), static=True), gcam_pos, "seg1"),
        ("chain", *built["chain"], (0.0, 2.5, 9.0), "seg1"),
        ("cluster", *built["cluster"], (0.0, 2.5, 9.0), "stream"),
        ("painted", *built["painted"], (0.0, 2.5, 9.0), "pool"),
    )
    for gname, spec_g, arrays_g, pos, kind in gates:
        cv_g = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0, 0, 0)), device=dev)
        if spec_g.has_materials:
            for cull in (False, True):
                rp = cp.make_pallas_image_render_aa(spec_g, dataclasses.replace(cfg64, leaf_cull=cull), GATE_W,
                                                    GATE_H, device=dev)
                sc, cam, bnd = rp.scene_args(arrays_g, cv_g)
                cc, fc = rp.cull_args(sc, cam)
                pre_k = cp.coarse(sc, cam, bnd, rp.params, cc)
                how = "culled lists" if cull else "un-culled"
                image_class(f"gate fine kernel with materials vs fine_plain, {gname} ({how})",
                            cp.fine(sc, cam, bnd, rp.params, *pre_k, cull=fc),
                            cp.fine_plain(sc, cam, bnd, rp.params, *pre_k, cull=fc))
        rp = cp.make_pallas_image_render_aa(spec_g, cfg64, GATE_W, GATE_H, device=dev)
        sc, cam, bnd = rp.scene_args(arrays_g, cv_g)
        cc, fc = rp.cull_args(sc, cam)
        pre_k = cp.coarse(sc, cam, bnd, rp.params, cc)
        _, t_k, hit_k = cp.fine_res(sc, cam, bnd, rp.params, *pre_k, cull=fc)
        fr = cg.make_fused_render_vjp(spec_g, cfg64, GATE_W, GATE_H, device=dev)
        info = (fr.backward_info["kind"], fr.backward_info["reason"])
        if info != ("pallas_compact", None) or cg.plan_kind(spec_g) != kind:
            raise AssertionError(f"{gname} should take K9 as a {kind} plan: {fr.backward_info}")
        g_img = seeded_cotangent(GATE_H, GATE_W, dev, 11)
        got = cg.compact_bwd(sc, fc, cam, rp.params, clamp, t_k, hit_k, g_img)
        ref = cg.compact_bwd_plain(sc, fc, cam, rp.params, clamp, t_k, hit_k, g_img)
        grad_class(f"gate compact_bwd kernel vs compact_bwd_plain, {gname} ({kind} plan, history "
                   f"{cg.history_layout(spec_g)[1]} items, {int(hit_k.sum())} hit rays)", got, ref)
        if gname in ("chain", "cluster") and not float(got[1].abs().max()) > 0:
            raise AssertionError(f"{gname}: the blend radii got no gradient")
        if gname == "painted" and not float(got[0][:, 12:16].abs().max()) > 0:
            raise AssertionError("painted: the albedo and flag words got no gradient")
    torch.cuda.synchronize()

    # -- 10b. the 1080p fwd+bwd steps ---------------------------------------
    n_rays = WIDTH * HEIGHT * cfg64.aa_samples ** 2
    n_px = WIDTH * HEIGHT
    steps, records = {}, []
    labels = {"cluster": "fwdbwd_64leaf_cluster", "painted": "fwdbwd_64leaf_painted",
              "chain": "64leaf_smooth_chain scene, trained; no reference row"}
    for name in ("cluster", "painted", "chain"):
        spec_s, arrays_s = built[name]
        render = rt.make_renderer(spec_s, WIDTH, HEIGHT, cfg64, mode="implicit", backend="pallas_fused",
                                  device=dev)
        if (render.backward_info["kind"], render.backward_info["reason"]) != ("pallas_compact", None):
            raise AssertionError(f"{name} must take the compact backward: {render.backward_info}")
        lp_s = torch.tensor(arrays_s.leaf_params, device=dev)
        op_s = torch.tensor(arrays_s.op_param, device=dev)

        def fwd_bwd(render=render, arrays_s=arrays_s, lp_s=lp_s, op_s=op_s):
            lp = lp_s.clone().requires_grad_(True)
            opp = op_s.clone().requires_grad_(True)
            cv = cv64.clone().requires_grad_(True)
            img = render.renderer(dataclasses.replace(arrays_s, leaf_params=lp, op_param=opp), cv)
            torch.mean(img * img).backward()
            return lp.grad, opp.grad, cv.grad

        cp.reset_launch_counts()
        cg.reset_launch_counts()
        for _ in range(BWD_WARMUP):
            fwd_bwd()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        for _ in range(BWD_STEPS):
            grads = fwd_bwd()
        e1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3 / BWD_STEPS
        step_ms = e0.elapsed_time(e1) / BWD_STEPS
        launches = {"coarse_kernel": cp.coarse.launches, "fine_kernel_residuals": cp.fine_res.launches,
                    "compact_bwd_kernel": cg.compact_bwd.launches, "fused_bwd_kernel": cg.bwd.launches}
        log(f"{labels[name]} training step (cull + relax, no intervals) {WIDTH}x{HEIGHT} x16 AA, fwd+bwd of "
            f"mean(img^2): {step_ms:.4f} ms/step (CUDA events, {BWD_STEPS} steps after {BWD_WARMUP} warm-up; "
            f"host clock {host_ms:.4f} ms), {n_rays / (step_ms * 1e-3) / 1e9:.4f} Grays/s on {smi}")
        log(f"launches in the {name} training run: {launches}")
        if min(launches[k] for k in ("coarse_kernel", "fine_kernel_residuals", "compact_bwd_kernel")) <= 0:
            raise AssertionError(f"a kernel of the {name} training path never launched: {launches}")
        if launches["fused_bwd_kernel"] != 0:
            raise AssertionError(f"the {name} step ran the legacy backward")
        if not all(bool(torch.isfinite(g).all()) for g in grads) or float(grads[0].abs().max()) <= 0:
            raise AssertionError(f"the {name} gradients are not finite or all zero")
        idle, busy = device_idle_share(fwd_bwd, 3, step_ms)

        fr = render.renderer
        rp, p = fr.prepass, fr.prepass.params
        sc, cam, bnd = rp.scene_args(arrays_s, cv64)
        cc, fc = rp.cull_args(sc, cam)
        pre_k = cp.coarse(sc, cam, bnd, p, cc)
        img_r, t_k, hit_k = cp.fine_res(sc, cam, bnd, p, *pre_k, cull=fc)
        g_img = 2.0 * img_r / img_r.numel()  # the cotangent of mean(img^2)
        coarse_ms = cuda_ms(lambda: cp.coarse(sc, cam, bnd, p, cc), KERNEL_REPS)
        fine_ms = cuda_ms(lambda: cp.fine_res(sc, cam, bnd, p, *pre_k, cull=fc), KERNEL_REPS)
        cbwd_ms = cuda_ms(lambda: cg.compact_bwd(sc, fc, cam, p, clamp, t_k, hit_k, g_img), KERNEL_REPS)
        cull_ms = cuda_ms(lambda: rp.cull_args(sc, cam), KERNEL_REPS)
        n_cull, n_ksum = cull_ops(rp, sc, cam)
        log(f"{name} step: device idle share {'not measured' if idle is None else f'{idle:.4f}'} (device time of 3 "
            f"profiled steps against the timed step; {'-' if busy is None else f'{busy:.4f}'} ms busy a step); "
            f"kernels alone: coarse {coarse_ms:.4f} ms, fine with residuals {fine_ms:.4f} ms, compact_bwd "
            f"{cbwd_ms:.4f} ms; masks and lists {cull_ms:.4f} ms in {n_cull} device operations "
            f"({n_ksum} in the pairwise path loop, path depth {culling_depth(spec_s)}); mean "
            f"{float(fc.counts.sum(1).float().mean()):.4f} active items per fine tile (max "
            f"{int(fc.counts.sum(1).max())}); hit fraction {float(hit_k.mean()):.4f}; history "
            f"{cg.history_layout(spec_s)[1]} items ({smi})")
        log(f"  K1/K2 stack route of these times: {stack_of(sc)}")

        # K9 against its plain version at full size, and its bound.
        got = cg.compact_bwd(sc, fc, cam, p, clamp, t_k, hit_k, g_img)
        torch.cuda.synchronize()
        e0.record()
        ref = cg.compact_bwd_plain(sc, fc, cam, p, clamp, t_k, hit_k, g_img,
                                   band_rows=16 if name == "chain" else 32)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        err = grad_class(f"full-size compact_bwd kernel vs compact_bwd_plain, {name}", got, ref)
        grad_class(f"{name} training-path gradients vs compact_bwd_plain", grads, ref)
        del ref
        b_ms, b_by, b_ops, b_bytes = k9_bound(sc, fc, p, cam, t_k, hit_k, n_rays)
        log(f"{name} compact_bwd bound {b_ms:.4f} ms ({b_by}; {b_ops:.6e} operations, {b_bytes:.6e} bytes); "
            f"plain {plain_ms:.2f} ms")
        kind = cg.plan_kind(spec_s)
        records.append(dict(
            name=f"compact_bwd_kernel ({kind} plan: {labels[name].split(' ')[0]})", route="cuda",
            source="raymarch_tpu_torch/csrc/compact_bwd.cu", replaces="raymarch_tpu/ops/pallas_grad.py:256",
            launches=launches["compact_bwd_kernel"], max_abs_err=err, ms=cbwd_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        if name == "painted":
            # K2 with materials: the culled fine kernel with residuals.
            work_f = cp.WorkCount()
            e0.record()
            img_p, t_p, hit_p = cp.fine_res_plain(sc, cam, bnd, p, *pre_k, cull=fc, work=work_f)
            e1.record()
            torch.cuda.synchronize()
            fine_plain_ms = e0.elapsed_time(e1)
            fine_err = image_class("full-size fine kernel with materials (culled, relax, residuals) vs "
                                   "fine_res_plain, painted", img_r, img_p)
            residual_agreement("full-size painted residuals vs fine_res_plain", (t_k, hit_k), (t_p, hit_p),
                               strict=False)
            del img_p, t_p, hit_p
            _, leaf_ops, _ = scene_cost(spec_s)
            hit_tiles = cp.leaves_per_point(sc, fc, fc.tile_index(
                torch.arange(HEIGHT, device=dev)[:, None, None], torch.arange(WIDTH, device=dev)[None, :, None]))
            color_flops = float((hit_k * hit_tiles).sum()) * (leaf_ops + COLOR_OPS)
            f_ms, f_by = roofline(march_flops(work_f, n_rays, spec_s, True, float(work_f.hits), fine=True)
                                  + color_flops, n_px * 20 + n_rays * 8 + 4 * (fc.lists.numel() + fc.counts.numel()))
            log(f"painted fine kernel with materials: {fine_ms:.4f} ms alone, plain {fine_plain_ms:.2f} ms, bound "
                f"{f_ms:.4f} ms ({f_by})")
            records.append(dict(
                name="fine_kernel (materials, culled, relax, residuals)", route="cuda",
                source="raymarch_tpu_torch/csrc/fine_culled.cu", replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
                launches=launches["fine_kernel_residuals"], max_abs_err=fine_err, ms=fine_ms,
                plain_ms=fine_plain_ms, bound_ms=f_ms, bound_by=f_by, library_ms=None))
        steps[name] = dict(step_ms=step_ms, idle=idle, cull_ms=cull_ms, n_cull=n_cull, cbwd_ms=cbwd_ms)
        del t_k, hit_k, img_r, g_img
    torch.cuda.synchronize()

    # -- 10c. the painted forward frame ---------------------------------------
    spec_p, arrays_p = built["painted"]
    render_p = rt.make_renderer(spec_p, WIDTH, HEIGHT, cfg64, mode="forward", backend="pallas_prepass", device=dev)
    cp.reset_launch_counts()
    for _ in range(WARMUP):
        frame_p = render_p(arrays_p, camera64)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(FRAMES):
        frame_p = render_p(arrays_p, camera64)
    e1.record()
    torch.cuda.synchronize()
    fwd_p_ms = e0.elapsed_time(e1) / FRAMES
    launches_p = {"coarse_kernel": cp.coarse.launches, "fine_kernel": cp.fine.launches}
    log(f"painted forward frame (fwdbwd_64leaf_painted's scene; cull + relax, no intervals) {WIDTH}x{HEIGHT} x16 "
        f"AA through make_renderer(backend='pallas_prepass'): {fwd_p_ms:.4f} ms/frame, "
        f"{n_rays / (fwd_p_ms * 1e-3) / 1e9:.4f} Grays/s, launches {launches_p} on {smi}")
    if min(launches_p.values()) <= 0:
        raise AssertionError(f"a kernel of the painted forward never launched: {launches_p}")
    off = cp.make_pallas_image_render_aa(spec_p, dataclasses.replace(cfg64, leaf_cull=False), WIDTH, HEIGHT,
                                         device=dev)
    image_class("full-size painted frame vs the un-culled plain path", frame_p, off.render_plain(arrays_p, cv64))
    torch.cuda.synchronize()

    # -- 10d. a 5-step 1080p fit on the cluster scene -------------------------
    spec_c, arrays_c = built["cluster"]
    truth = arrays_c.leaf_params
    row = int(np.argmax(truth[:, 7]))  # the largest sphere
    start = truth.copy()
    start[row, 4] -= 0.12
    k_idx = np.nonzero(arrays_c.op_param)[0]  # the blend radii
    op_start = arrays_c.op_param.copy()
    op_start[k_idx] *= 0.7
    m_leaf = np.zeros_like(truth)
    m_leaf[row, 4] = 1.0
    m_op = np.zeros_like(op_start)
    m_op[k_idx] = 1.0
    target = rt.make_renderer(spec_c, WIDTH, HEIGHT, cfg64, mode="forward", backend="pallas_prepass",
                              device=dev)(arrays_c, camera64)
    fit_kw = dict(width=WIDTH, height=HEIGHT, cfg=cfg64, learning_rate=1e-2, leaf_mask=m_leaf, op_mask=m_op,
                  backend="pallas_fused", device=dev, log_fn=lambda m: None)
    start_arrays = dataclasses.replace(arrays_c, leaf_params=start, op_param=op_start)
    rt.fit_scene(spec_c, start_arrays, camera64, target, steps=1, **fit_kw)
    res = rt.fit_scene(spec_c, start_arrays, camera64, target, steps=FIT_STEPS, **fit_kw)
    k_err = (float(np.abs(op_start[k_idx] - arrays_c.op_param[k_idx]).mean()),
             float(np.abs(res.arrays.op_param.detach().cpu().numpy()[k_idx] - arrays_c.op_param[k_idx]).mean()))
    log(f"cluster fit at {WIDTH}x{HEIGHT} ({FIT_STEPS} Adam steps, lr 1e-2; sphere row {row}'s centre x and the "
        f"{len(k_idx)} blend radii): loss {res.losses[0]:.6e} -> {res.losses[-1]:.6e}; cx {start[row, 4]:+.4f} -> "
        f"{float(res.arrays.leaf_params[row, 4]):+.4f} (truth {truth[row, 4]:+.4f}); mean |k - truth| "
        f"{k_err[0]:.4f} -> {k_err[1]:.4f}; {1.0 / res.steps_per_sec:.4f} s/step; backward {res.backward_info} "
        f"({smi})")
    if (res.backward_info["kind"], res.backward_info["reason"]) != ("pallas_compact", None):
        raise AssertionError("the cluster fit did not train through the compact backward")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError("the cluster fit did not lower the loss")
    summary = dict(steps=steps, fwd_p_ms=fwd_p_ms, fit_s=1.0 / res.steps_per_sec)
    return records, summary


COLOR_ADJ_OPS = 16  # a binary instruction of the colour walk's reverse: the blend of 3 channels and the weight


def k8_reached(sc, p, cam, t, hit, band_rows=64):
    """Leaves that the distance's cotangent reaches at the points o + d t of
    the rays where `hit` > 0 (the hit points; in soft mode any ray mask and
    point parameter), summed over those rays: the leaves whose distance has
    a non-zero derivative of the scene's there (autograd through the plain
    tape with the leaf distances as its inputs; one leaf under a hard
    union, more where a smooth blend mixes them)."""
    import torch
    from raymarch_tpu_torch.ops import cuda_march as cm
    from raymarch_tpu_torch.ops import cuda_prepass as cp
    from raymarch_tpu_torch.ops import sdf

    spec = sc.spec
    row_types = {r: (ty, rot) for r, ty, rot in cm._leaf_static_rows(spec)}
    pushed = sorted({a for c, a, _ in spec.static_tape if c == 1})
    total = 0.0
    for i0 in range(0, p.rows, band_rows):
        i1 = min(i0 + band_rows, p.rows)
        keep = hit[i0:i1] > 0
        if not bool(keep.any()):
            continue
        x, y = cp.aa_screen(p, cam, i0, i1 - i0)
        dx, dy, dz = cp._view_dirs(x, y, cam, p)
        ox, oy, oz = cp._origin(cam, dx)
        tt = t[i0:i1]
        px, py, pz = ((o + d * tt)[keep] for o, d in ((ox, dx), (oy, dy), (oz, dz)))
        with torch.enable_grad():
            dist = {r: cm._leaf_distance_plain(sc.leaf_params[r], *row_types[r], px, py, pz).detach()
                    .requires_grad_(True) for r in pushed}
            f = sdf._apply_static_tape(spec, sc.op_param, lambda r: dist[r], p.max_dist, px)
            grads = torch.autograd.grad(f.sum(), [dist[r] for r in pushed], allow_unused=True)
        total += sum(float((g != 0).sum()) for g in grads if g is not None)
    return total


def word_class(name, what, got, ref, geo):
    """One class of K8's gradient words against bwd_plain at 0.01 times the
    class's own largest word (a class far below the geometry words would
    pass grad_class's overall scale whatever it held); the class must be
    non-zero in both. `geo` is the largest geometry word, printed beside."""
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = scale > 0 and float(got.abs().max()) > 0 and err <= 0.01 * scale
    log(f"({name}) {what}: max|g| {scale:.4e} (= {scale / geo:.3e} of the largest geometry word {geo:.4e}), "
        f"max|d| {err:.3e} = {err / max(scale, 1e-30):.3e} of the class's max|g| (need <= 0.01, non-zero) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"path ({name}): the {what} are zero or outside the tolerance")


def k8_bound(sc, p, cam, t, hit, lay, n_rays):
    """(bound_ms, bound_by, operations, bytes) of the legacy backward on
    these residuals. Per hit ray: the tape at the 4 taps and the hit point
    once each, the reverse of those 5 evaluations (4 operations per
    instruction, and ADJ_FACTOR x the leaf work of the leaves the cotangent
    reaches, counted at the hit point by `k8_reached`), the ray's adjoint;
    on a painted scene one colour walk of the tape and its reverse over the
    same leaves. Bytes: hit for every ray, t for the hit rays, the cotangent
    of their pixels, the gradient row."""
    spec = sc.spec
    n_push, leaf_ops, comb = scene_cost(spec)
    tape_ops = n_push * leaf_ops + comb
    n_real = len(spec.static_tape)
    n_hits = float(hit.sum())
    reached = k8_reached(sc, p, cam, t, hit)
    flops = n_hits * (5 * tape_ops + 5 * 4 * n_real + ADJ_RAY_OPS) + 5 * ADJ_FACTOR * leaf_ops * reached
    if spec.has_materials:
        flops += (n_hits * (tape_ops + n_push * COLOR_OPS + COLOR_ADJ_OPS * n_real)
                  + ADJ_FACTOR * (leaf_ops + COLOR_OPS) * reached)
    nbytes = n_rays * 4 + n_hits * 4 + hit_pixels(hit) * 12 + lay.nscal * 4
    ms, by = roofline(flops, nbytes)
    return ms, by, flops, nbytes, reached / max(n_hits, 1.0)


def legacy(rt, cp, cg, dev, smi, cfg):
    """Phase 12: the legacy backward (K8) of every static scene the
    reference sends to it, at 1920x1080 with 16 AA rays per pixel (see the
    module docstring). Returns the kernel records of K8's builds, of the
    fine kernel at B = 4 with residuals and at aa_samples = 8, and the
    numbers the summary prints."""
    import numpy as np
    import torch

    cfg64 = dataclasses.replace(cfg, relax=1.6, leaf_cull=True)
    nocull = dataclasses.replace(cfg64, leaf_cull=False)
    camera64 = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
    camera_h = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    _, chain_painted, _ = scenes_bench64(rt, chain_rgb=np.random.default_rng(19))
    # name, what, scene, config, camera, make_fused_render_vjp keywords, the
    # reference's reason, (warp-row build, albedo words)
    paths = (
        ("a", "64 painted spheres of fwdbwd_64leaf_painted, leaf_cull=False", scene_painted(rt), nocull,
         camera64, {}, "leaf_cull disabled", (True, True)),
        ("b", "the 64leaf_smooth_chain scene, every sphere painted, cfg64", chain_painted, cfg64, camera64, {},
         "painted materials on smooth/ordered segments", (True, True)),
        ("c", "64 spheres & box(3.2, 1.2, 3.2), cfg64", scene_spheres(rt) & rt.box(half_extents=(3.2, 1.2, 3.2)),
         cfg64, camera64, {}, "plan has residual (unrolled) subtrees", (True, False)),
        ("d", "config 2 at prepass_block=4, headline camera", scene_config2(rt), cfg, camera_h,
         dict(prepass_block=4), "leaf_cull disabled", (False, False)),
        ("e", "16 painted spheres, leaf_cull=False", scene_painted(rt, 16), nocull, camera64, {},
         "leaf_cull disabled", (True, True)),
    )
    n_rays = WIDTH * HEIGHT * cfg.aa_samples ** 2
    records, steps = [], {}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for name, what, scene, cfg_p, camera, kw, reason, build in paths:
        spec_p, arrays_p = rt.compile_scene(scene, static=True)
        cv = rt.cam_vec(camera, device=dev)
        if kw:
            # The reference's make_renderer takes no prepass_block; its fused
            # VJP does (pallas_grad.py:1228).
            fr = cg.make_fused_render_vjp(spec_p, cfg_p, WIDTH, HEIGHT, device=dev, **kw)
        else:
            fr = rt.make_renderer(spec_p, WIDTH, HEIGHT, cfg_p, mode="implicit", backend="pallas_fused",
                                  device=dev).renderer
        lay = fr.layout
        info = (fr.backward_info["kind"], fr.backward_info["reason"])
        if info != ("pallas_legacy_unrolled", reason) or (lay.long, spec_p.has_materials) != build:
            raise AssertionError(f"path ({name}) routes to {info}, long={lay.long}: expected {reason}, {build}")
        kname = "fused_bwd_kernel" + (" (warp rows)" if lay.long else " (per-thread rows)") + (
            " (albedo words)" if spec_p.has_materials else "")
        lp0 = torch.tensor(arrays_p.leaf_params, device=dev)
        op0 = torch.tensor(arrays_p.op_param, device=dev)

        def fwd_bwd(fr=fr, arrays_p=arrays_p, lp0=lp0, op0=op0, cv=cv):
            lp = lp0.clone().requires_grad_(True)
            opp = op0.clone().requires_grad_(True)
            c = cv.clone().requires_grad_(True)
            img = fr(dataclasses.replace(arrays_p, leaf_params=lp, op_param=opp), c)
            torch.mean(img * img).backward()
            return lp.grad, opp.grad, c.grad

        cp.reset_launch_counts()
        cg.reset_launch_counts()
        for _ in range(BWD_WARMUP):
            fwd_bwd()
        torch.cuda.synchronize()
        e0.record()
        for _ in range(BWD_STEPS):
            grads = fwd_bwd()
        e1.record()
        torch.cuda.synchronize()
        step_ms = e0.elapsed_time(e1) / BWD_STEPS
        launches = {"coarse_kernel": cp.coarse.launches, "fine_kernel_residuals": cp.fine_res.launches,
                    kname: cg.bwd.launches, "compact_bwd_kernel": cg.compact_bwd.launches}
        log(f"({name}) {what}: training step {WIDTH}x{HEIGHT} x16 AA, fwd+bwd of mean(img^2) through "
            f"{'make_fused_render_vjp' if kw else 'make_renderer'}(backend 'pallas_fused'): {step_ms:.4f} ms/step "
            f"(CUDA events, {BWD_STEPS} steps after {BWD_WARMUP} warm-up), backward {info}, "
            f"{lay.n_real} instructions, {lay.nscal} gradient words; launches {launches} on {smi}")
        if min(launches[k] for k in ("coarse_kernel", "fine_kernel_residuals", kname)) <= 0:
            raise AssertionError(f"a kernel of path ({name}) never launched: {launches}")
        if launches["compact_bwd_kernel"] != 0:
            raise AssertionError(f"path ({name}) ran the compact backward")
        if not all(bool(torch.isfinite(g).all()) for g in grads) or float(grads[0].abs().max()) <= 0:
            raise AssertionError(f"path ({name}): the gradients are not finite or all zero")

        # K8 alone, and against bwd_plain on the whole frame.
        rp, p = fr.prepass, fr.params
        sc, cam, bnd = rp.scene_args(arrays_p, cv)
        cc, fc = rp.cull_args(sc, cam)
        pre_k = cp.coarse(sc, cam, bnd, p, cc)
        img_r, t_k, hit_k = cp.fine_res(sc, cam, bnd, p, *pre_k, cull=fc)
        g_img = 2.0 * img_r / img_r.numel()  # the cotangent of mean(img^2)
        k8_ms = cuda_ms(lambda: cg.bwd(sc, cam, p, lay, t_k, hit_k, g_img), KERNEL_REPS)
        got = cg.bwd(sc, cam, p, lay, t_k, hit_k, g_img)
        # Warp-row paths replay long tapes: bands of 32 rows hold twice the
        # 3.7-13.5 GiB that 16-row bands peaked at on the H100.
        band = 32 if lay.long else cg.PLAIN_BAND_ROWS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0.record()
        ref = cg.bwd_plain(sc, cam, p, lay, t_k, hit_k, g_img, band_rows=band)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        err = grad_class(f"({name}) full-size {kname} vs bwd_plain (whole frame, {band}-row bands, peak "
                         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", got, ref)
        grad_class(f"({name}) training-path gradients vs bwd_plain", grads, ref)
        if spec_p.has_materials:
            word_class(name, "albedo and flag words", got[0][:, 12:16], ref[0][:, 12:16],
                       float(ref[0][:, :12].abs().max()))
            if name == "b":  # the blend radii, reached through the smooth weights too
                word_class(name, "op words", got[1], ref[1], float(ref[0][:, :12].abs().max()))
        del ref
        b_ms, b_by, b_ops, b_bytes, reached = k8_bound(sc, p, cam, t_k, hit_k, lay, n_rays)
        log(f"({name}) {kname}: {k8_ms:.4f} ms alone, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{b_ops:.6e} operations, {b_bytes:.6e} bytes; {reached:.4f} leaves reached per hit point; hit "
            f"fraction {float(hit_k.mean()):.4f}) ({smi})")
        records.append(dict(
            name=f"{kname}: ({name}) {what}", route="cuda", source="raymarch_tpu_torch/csrc/fused_bwd.cu",
            replaces="raymarch_tpu/ops/pallas_grad.py:1432", launches=launches[kname], max_abs_err=err,
            ms=k8_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
        if name == "d":
            # The fine kernel with residuals on block planes (PRE 1).
            fine_ms = cuda_ms(lambda: cp.fine_res(sc, cam, bnd, p, *pre_k), KERNEL_REPS)
            work_f = cp.WorkCount()
            e0.record()
            img_p, t_p, hit_p = cp.fine_res_plain(sc, cam, bnd, p, *pre_k, work=work_f)
            e1.record()
            torch.cuda.synchronize()
            fine_plain_ms = e0.elapsed_time(e1)
            fine_err = image_class("(d) full-size fine kernel with residuals on B = 4 planes vs fine_res_plain",
                                   img_r, img_p)
            residual_agreement("(d) residuals vs fine_res_plain", (t_k, hit_k), (t_p, hit_p), strict=False)
            del img_p, t_p, hit_p
            n_px = WIDTH * HEIGHT
            f_ms, f_by = roofline(march_flops(work_f, n_rays, spec_p, False, float(work_f.hits), fine=True),
                                  n_px * 12 + n_rays * 8 + p.brows * p.bcols * 8)
            log(f"(d) fine kernel with residuals on block planes: {fine_ms:.4f} ms alone, plain "
                f"{fine_plain_ms:.2f} ms, bound {f_ms:.4f} ms ({f_by}) ({smi})")
            log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
            records.append(dict(
                name="fine_kernel (residuals, B = 4 block planes)", route="cuda",
                source="raymarch_tpu_torch/csrc/prepass.cu", replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
                launches=launches["fine_kernel_residuals"], max_abs_err=fine_err, ms=fine_ms,
                plain_ms=fine_plain_ms, bound_ms=f_ms, bound_by=f_by, library_ms=None))
        steps[name] = dict(step_ms=step_ms, k8_ms=k8_ms, bound_ms=b_ms, plain_ms=plain_ms,
                           launches=launches[kname], kname=kname)
        del t_k, hit_k, img_r, g_img, got, grads
        torch.cuda.synchronize()

    # -- 12b. a 1080p fit of path (a)'s albedos -----------------------------
    spec_a, arrays_a = rt.compile_scene(scene_painted(rt), static=True)
    truth = arrays_a.leaf_params
    painted = np.nonzero(truth[:, 15] > 0)[0]
    start = truth.copy()
    start[painted, 12:15] = np.clip(truth[painted, 12:15]
                                    + np.random.default_rng(5).uniform(-0.2, 0.2, (len(painted), 3)), 0.05, 0.95)
    m_leaf = np.zeros_like(truth)
    m_leaf[painted, 12:15] = 1.0
    target = rt.make_renderer(spec_a, WIDTH, HEIGHT, nocull, mode="forward", backend="pallas_prepass",
                              device=dev)(arrays_a, camera64)
    fit_kw = dict(width=WIDTH, height=HEIGHT, cfg=nocull, learning_rate=2e-2, leaf_mask=m_leaf,
                  backend="pallas_fused", device=dev, log_fn=lambda m: None)
    start_arrays = dataclasses.replace(arrays_a, leaf_params=start)
    rt.fit_scene(spec_a, start_arrays, camera64, target, steps=1, **fit_kw)
    res = rt.fit_scene(spec_a, start_arrays, camera64, target, steps=FIT_STEPS, **fit_kw)
    got = res.arrays.leaf_params.detach().cpu().numpy()
    err0 = float(np.abs(start[painted, 12:15] - truth[painted, 12:15]).mean())
    err1 = float(np.abs(got[painted, 12:15] - truth[painted, 12:15]).mean())
    fit_s = 1.0 / res.steps_per_sec
    log(f"(a) albedo fit at {WIDTH}x{HEIGHT} ({FIT_STEPS} Adam steps, lr 2e-2, the {len(painted)} painted "
        f"leaves' albedos): loss {res.losses[0]:.6e} -> {res.losses[-1]:.6e}; mean |albedo - truth| {err0:.4f} "
        f"-> {err1:.4f}; {fit_s:.4f} s/step; backward {res.backward_info} ({smi})")
    if res.backward_info["reason"] != "leaf_cull disabled" or not (res.losses[-1] < res.losses[0] and err1 < err0):
        raise AssertionError("the albedo fit did not move toward the truth")

    # -- 12c. an aa_samples = 8 frame of config 2 ----------------------------
    cfg8 = dataclasses.replace(cfg, aa_samples=8)
    spec2, arrays2 = rt.compile_scene(scene_config2(rt), static=True)
    render8 = rt.make_renderer(spec2, WIDTH, HEIGHT, cfg8, mode="forward", backend="pallas_prepass", device=dev)
    cp.reset_launch_counts()
    for _ in range(WARMUP):
        frame8 = render8(arrays2, camera_h)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(FRAMES):
        frame8 = render8(arrays2, camera_h)
    e1.record()
    torch.cuda.synchronize()
    frame8_ms = e0.elapsed_time(e1) / FRAMES
    launches8 = {"coarse_kernel": cp.coarse.launches, "fine_kernel": cp.fine.launches}
    n_rays8 = WIDTH * HEIGHT * 64
    log(f"aa_samples=8 frame of config 2, {WIDTH}x{HEIGHT} x64 AA through make_renderer(backend="
        f"'pallas_prepass'): {frame8_ms:.4f} ms/frame, {n_rays8 / (frame8_ms * 1e-3) / 1e9:.4f} Grays/s, "
        f"launches {launches8} on {smi}")
    if min(launches8.values()) <= 0:
        raise AssertionError(f"a kernel of the aa = 8 frame never launched: {launches8}")
    rp8 = render8.renderer
    sc, cam, bnd = rp8.scene_args(arrays2, rt.cam_vec(camera_h, device=dev))
    pre_k = cp.coarse(sc, cam, bnd, rp8.params)
    fine8_ms = cuda_ms(lambda: cp.fine(sc, cam, bnd, rp8.params, *pre_k), KERNEL_REPS)
    work_f = cp.WorkCount()
    e0.record()
    img_p = cp.fine_plain(sc, cam, bnd, rp8.params, *pre_k, work=work_f)
    e1.record()
    torch.cuda.synchronize()
    fine8_plain_ms = e0.elapsed_time(e1)
    fine8_err = image_class("full-size fine kernel at aa = 8 vs fine_plain (same planes)",
                            cp.fine(sc, cam, bnd, rp8.params, *pre_k), img_p)
    # The frame through make_renderer against the same plain pass (a second
    # plain pass of 133 M rays, render_plain's, does not fit beside it).
    image_class("full-size aa = 8 frame through make_renderer vs fine_plain", frame8, img_p)
    del img_p
    torch.cuda.empty_cache()
    f8_ms, f8_by = roofline(march_flops(work_f, n_rays8, spec2, False, float(work_f.hits), fine=True),
                            WIDTH * HEIGHT * 20)
    log(f"fine kernel at aa = 8: {fine8_ms:.4f} ms alone, plain {fine8_plain_ms:.2f} ms, bound {f8_ms:.4f} ms "
        f"({f8_by}) ({smi})")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    records.append(dict(
        name="fine_kernel (aa_samples = 8: a pixel over two warps)", route="cuda",
        source="raymarch_tpu_torch/csrc/prepass.cu", replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
        launches=launches8["fine_kernel"], max_abs_err=fine8_err, ms=fine8_ms, plain_ms=fine8_plain_ms,
        bound_ms=f8_ms, bound_by=f8_by, library_ms=None))
    summary = dict(steps=steps, fit_s=fit_s, frame8_ms=frame8_ms, fine8_ms=fine8_ms)
    return records, summary


def launch_counts(cp):
    return {"coarse_kernel": cp.coarse.launches, "coarse_kernel_intervals": cp.coarse.interval_launches,
            "coarse_px_kernel": cp.coarse_px.launches, "fine_kernel": cp.fine.launches,
            "fine_kernel_intervals": cp.fine.interval_launches}


def timed_frames(cp, fn):
    """(ms per frame by CUDA events over FRAMES after WARMUP, host ms, the
    launches of that run): the counts are set to 0 just before the run and
    read just after."""
    import torch

    cp.reset_launch_counts()
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    e0.record()
    for _ in range(FRAMES):
        fn()
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / FRAMES
    return e0.elapsed_time(e1) / FRAMES, host_ms, launch_counts(cp)


def plain_ms(fn):
    """(result, device ms) of one run of a plain version."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def forward_rows(rt, cp, dev, smi, cfg, gcam_pos):
    """Phase 11: the many-primitive forward as bench.py configures it (see
    the module docstring). Returns the kernel records of the interval and
    block builds of K1/K2 and of K3, and the rows' numbers."""
    import torch

    cfg_ir = dataclasses.replace(cfg, relax=1.6)
    cfg64 = dataclasses.replace(cfg, relax=1.6, leaf_cull=True)
    spheres, chain, cluster = scenes_bench64(rt)
    built = {name: rt.compile_scene(s, static=True) for name, s in (
        ("config2", scene_config2(rt)), ("spheres", spheres), ("chain", chain), ("cluster", cluster),
        ("256", scene_bench256(rt)), ("1024", scene_bench1024(rt)))}
    cam_of = {"config2": (0.0, 1.6, 4.2), "256": (0.0, 4.0, 16.0), "1024": (0.0, 6.0, 30.0)}

    def camera(name, row=0.0):
        pos = cam_of.get(name, (0.0, 2.5, 9.0))
        return rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), row, device=dev)

    # -- 11a. gates at 256x144 ------------------------------------------------
    spec2, arrays2 = built["config2"]
    gcv = rt.cam_vec(rt.Camera.looking_at(position=gcam_pos, target=(0, 0, 0)), device=dev)
    for ni in (1, 2, 3):
        rp = cp.make_pallas_image_render_aa(spec2, cfg, GATE_W, GATE_H, device=dev, n_intervals=ni)
        sc, cam, bnd = rp.scene_args(arrays2, gcv)
        interval_agreement(f"gate interval coarse kernel vs coarse_plain, config 2, ni={ni}",
                           cp.coarse(sc, cam, bnd, rp.params), cp.coarse_plain(sc, cam, bnd, rp.params))
    for relax in (1.0, 1.6):
        rp = cp.make_pallas_image_render_aa(spec2, dataclasses.replace(cfg, relax=relax), GATE_W, GATE_H,
                                            device=dev, n_intervals=2)
        sc, cam, bnd = rp.scene_args(arrays2, gcv)
        pre = cp.coarse(sc, cam, bnd, rp.params)
        image_class(f"gate interval fine kernel vs fine_plain, config 2, relax {relax}",
                    cp.fine(sc, cam, bnd, rp.params, *pre), cp.fine_plain(sc, cam, bnd, rp.params, *pre))
    rp = cp.make_pallas_image_render_aa(spec2, cfg, GATE_W, GATE_H, device=dev, prepass_block=4,
                                        prepass_chain=True)
    sc, cam, bnd = rp.scene_args(arrays2, gcv)
    blk = cp.coarse(sc, cam, bnd, rp.params)
    coarse_agreement("gate B=4 block coarse kernel vs coarse_plain, config 2", blk,
                     cp.coarse_plain(sc, cam, bnd, rp.params), strict=False)
    px = cp.coarse_px(sc, cam, bnd, rp.params, *blk)
    coarse_agreement("gate coarse_px_kernel (K3) vs coarse_px_plain, config 2", px,
                     cp.coarse_px_plain(sc, cam, bnd, rp.params, *blk), strict=True, exact=True)
    image_class("gate fine kernel on K3's planes vs fine_plain", cp.fine(sc, cam, bnd, rp.params, *px),
                cp.fine_plain(sc, cam, bnd, rp.params, *px))
    # K3 on a tape of stack depth 8: the shared-memory route, static and DYN.
    for static in (True, False):
        spec_d, arrays_d = rt.compile_scene(spheres, static=static)
        rp = cp.make_pallas_image_render_aa(spec_d, cfg, GATE_W, GATE_H, device=dev, prepass_block=4,
                                            prepass_chain=True)
        sc, cam, bnd = rp.scene_args(arrays_d, camera("spheres"))
        blk = cp.coarse(sc, cam, bnd, rp.params)
        coarse_agreement(f"gate {'' if static else 'DYN '}coarse_px_kernel (K3) vs coarse_px_plain, 64 spheres "
                         f"({stack_of(sc)})", cp.coarse_px(sc, cam, bnd, rp.params, *blk),
                         cp.coarse_px_plain(sc, cam, bnd, rp.params, *blk), strict=True, exact=True)
    rp = cp.make_pallas_image_render_aa(spec2, cfg, GATE_W, GATE_H, device=dev, prepass_block=4)
    sc, cam, bnd = rp.scene_args(arrays2, gcv)
    blk = cp.coarse(sc, cam, bnd, rp.params)
    image_class("gate fine kernel on B=4 block planes vs fine_plain", cp.fine(sc, cam, bnd, rp.params, *blk),
                cp.fine_plain(sc, cam, bnd, rp.params, *blk))
    for name, block in (("spheres", 1), ("chain", 1), ("cluster", 1), ("256", 4)):
        spec_g, arrays_g = built[name]
        rp = cp.make_pallas_image_render_aa(spec_g, cfg64, GATE_W, GATE_H, device=dev, prepass_block=block,
                                            n_intervals=2)
        sc, cam, bnd = rp.scene_args(arrays_g, camera(name))
        cc, fc = rp.cull_args(sc, cam)
        pre = cp.coarse(sc, cam, bnd, rp.params, cc)
        interval_agreement(f"gate culled interval coarse kernel (B={block}) vs coarse_plain, {name}", pre,
                           cp.coarse_plain(sc, cam, bnd, rp.params, cc))
        image_class(f"gate culled interval fine kernel (relax) vs fine_plain, {name}",
                    cp.fine(sc, cam, bnd, rp.params, *pre, cull=fc),
                    cp.fine_plain(sc, cam, bnd, rp.params, *pre, cull=fc))
    torch.cuda.synchronize()

    # -- 11b. the rows at full size -------------------------------------------
    rows = (
        ("interval_relax_static", "config2", cfg_ir, 1, WIDTH, HEIGHT, None),
        ("64leaf_cull_intervals", "spheres", cfg64, 1, WIDTH, HEIGHT, None),
        ("64leaf_smooth_chain", "chain", cfg64, 1, WIDTH, HEIGHT, None),
        ("64leaf_mixed_cluster", "cluster", cfg64, 1, WIDTH, HEIGHT, None),
        ("256leaf_compact", "256", cfg64, 4, WIDTH, HEIGHT, None),
        ("1024leaf_compact", "1024", cfg64, 4, WIDTH, HEIGHT, None),
        ("64leaf_4k_3band", "spheres", cfg64, 1, 2 * WIDTH, 2 * HEIGHT, 2 * HEIGHT // 3),
    )
    out, records = {}, []
    for row, name, cfg_r, block, w, h, band in rows:
        spec_r, arrays_r = built[name]
        rp = cp.make_pallas_image_render_aa(spec_r, cfg_r, w, h, device=dev, prepass_block=block, n_intervals=2,
                                            band_rows=band)
        cvs = [camera(name, float(r0)) for r0 in (range(0, h, band) if band else (0,))]

        def frame(rp=rp, arrays_r=arrays_r, cvs=cvs):
            return [rp(arrays_r, cv) for cv in cvs]

        frame_ms, host_ms, launches = timed_frames(cp, frame)
        n_rays = w * h * cfg_r.aa_samples ** 2
        if min(launches["coarse_kernel_intervals"], launches["fine_kernel_intervals"]) <= 0:
            raise AssertionError(f"a kernel of {row} never launched: {launches}")
        if launches["coarse_kernel"] or launches["fine_kernel"]:
            raise AssertionError(f"{row} ran the legacy prepass builds: {launches}")
        idle, busy = device_idle_share(frame, 3, frame_ms)
        img = frame()
        if not all(bool(torch.isfinite(v).all()) and v.shape == (band or h, w, 3) for v in img):
            raise AssertionError(f"{row}: bad frame")
        sc, cam, bnd = rp.scene_args(arrays_r, cvs[len(cvs) // 2])
        cull_ms = cuda_ms(lambda: rp.cull_args(sc, cam), KERNEL_REPS)
        cc, fc = rp.cull_args(sc, cam)
        pre = cp.coarse(sc, cam, bnd, rp.params, cc)
        coarse_ms = cuda_ms(lambda: cp.coarse(sc, cam, bnd, rp.params, cc), KERNEL_REPS)
        fine_ms = cuda_ms(lambda: cp.fine(sc, cam, bnd, rp.params, *pre, cull=fc), KERNEL_REPS)
        active = None if fc is None else float(fc.counts.sum(1).float().mean())
        if idle is not None and not band and busy < 0.95 * (coarse_ms + fine_ms):
            idle = None  # the profiler lost device events: a frame holds at least its kernels
        log(f"{row} ({name}, {w}x{h}{f' as {len(cvs)} bands of {band} rows' if band else ''}, B={block}, ni=2, "
            f"relax {cfg_r.relax}, leaf_cull {cfg_r.leaf_cull}) x16 AA: {frame_ms:.4f} ms/frame (CUDA events, "
            f"{FRAMES} frames after {WARMUP} warm-up; host clock {host_ms:.4f} ms), "
            f"{n_rays / (frame_ms * 1e-3) / 1e9:.4f} Grays/s; launches {launches}; device idle share "
            f"{'not measured' if idle is None else f'{idle:.4f}'} (device time of 3 profiled frames against the "
            f"timed frame; {'-' if busy is None else f'{busy:.4f}'} ms busy a frame); cull_args alone "
            f"{cull_ms:.4f} ms{'' if not band else ' per band'}; mean active items per fine tile "
            f"{'-' if active is None else f'{active:.4f}'}; kernels alone{' (one band)' if band else ''}: "
            f"coarse {coarse_ms:.4f} ms, fine {fine_ms:.4f} ms ({smi})")
        log(f"  K1/K2 stack route of these times: {stack_of(sc)}")

        # The kernels against their plain versions on the row's own inputs
        # (the 4K row's middle band), or on one 64-row band: the coarse pass
        # of the 1024-leaf scene and the fine pass of the 256/1024-leaf
        # scenes (the plain fold takes O(plan items) torch operations a step).
        full = {"coarse": name != "1024", "fine": name not in ("256", "1024")}
        own = f"its {band}-row band at row {len(cvs) // 2 * band}" if band else "full size"
        args = {k: (sc, cam, bnd, rp.params, cc, fc, pre, own) for k, v in full.items() if v}
        if not all(full.values()):
            rb = cp.make_pallas_image_render_aa(spec_r, cfg_r, w, h, device=dev, prepass_block=block,
                                                n_intervals=2, band_rows=PLAIN_BAND)
            r0 = (h - PLAIN_BAND) // 2
            sc_b, cam_b, bnd_b = rb.scene_args(arrays_r, camera(name, float(r0)))
            cc_b, fc_b = rb.cull_args(sc_b, cam_b)
            pre_b = cp.coarse(sc_b, cam_b, bnd_b, rb.params, cc_b)
            for k, v in full.items():
                if not v:
                    args[k] = (sc_b, cam_b, bnd_b, rb.params, cc_b, fc_b, pre_b,
                               f"one {PLAIN_BAND}-row band at row {r0}")
        work_c, work_f = cp.WorkCount(), cp.WorkCount()
        torch.cuda.reset_peak_memory_stats()
        sc_p, cam_p, bnd_p, p_c, cc_p, _, pre_k, where_c = args["coarse"]
        pre_p, c_plain_ms = plain_ms(lambda: cp.coarse_plain(sc_p, cam_p, bnd_p, p_c, cc_p, work=work_c))
        c_err = interval_agreement(f"{row}: interval coarse kernel vs coarse_plain, {where_c}", pre_k, pre_p)
        del pre_p
        sc_p, cam_p, bnd_p, p_f, _, fc_p, pre_k, where_f = args["fine"]
        img_k = cp.fine(sc_p, cam_p, bnd_p, p_f, *pre_k, cull=fc_p)
        img_p, f_plain_ms = plain_ms(lambda: cp.fine_plain(sc_p, cam_p, bnd_p, p_f, *pre_k, cull=fc_p, work=work_f))
        f_err = image_class(f"{row}: interval fine kernel vs fine_plain (same planes), {where_f}", img_k, img_p)
        del img_k, img_p, args
        log(f"{row}: plain on the card: coarse_plain {c_plain_ms:.2f} ms ({where_c}), fine_plain "
            f"{f_plain_ms:.2f} ms ({where_f}); peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        compact = fc is not None and fc.compact
        lists = (lambda c: 0 if c is None or not c.compact else 4 * (c.lists.numel() + c.counts.numel()))
        n_blk = p_c.brows * p_c.bcols
        n_px = p_f.rows * p_f.width
        c_bound = roofline(march_flops(work_c, n_blk, spec_r, compact), n_blk * 16 + lists(cc_p))
        f_bound = roofline(march_flops(work_f, n_px * cfg_r.aa_samples ** 2, spec_r, compact, float(work_f.hits),
                                       fine=True), n_px * 12 + p_f.brows * p_f.bcols * 16 + lists(fc_p))
        log(f"{row}: counted work: coarse ({where_c}) {float(work_c.points):.6e} points, "
            f"{float(work_c.leaf_evals):.6e} leaf evaluations, bound {c_bound[0]:.4f} ms ({c_bound[1]}); fine "
            f"({where_f}) {float(work_f.points):.6e} points, {float(work_f.leaf_evals):.6e} leaf evaluations, "
            f"{float(work_f.hits):.0f} hit rays, bound {f_bound[0]:.4f} ms ({f_bound[1]})")
        out[row] = dict(frame_ms=frame_ms, grays=n_rays / (frame_ms * 1e-3) / 1e9, idle=idle, cull_ms=cull_ms,
                        active=active, coarse_ms=coarse_ms, fine_ms=fine_ms, launches=launches)
        if row in ("interval_relax_static", "64leaf_cull_intervals", "256leaf_compact"):
            how = {"interval_relax_static": "intervals", "64leaf_cull_intervals": "intervals, culled lists",
                   "256leaf_compact": "B=4 blocks, intervals, culled lists"}[row]
            records.append(dict(
                name=f"coarse_kernel ({how}: {row})", route="cuda", source="raymarch_tpu_torch/csrc/prepass.cu",
                replaces="raymarch_tpu/ops/pallas_prepass.py:885", launches=launches["coarse_kernel_intervals"],
                max_abs_err=c_err, ms=coarse_ms, plain_ms=c_plain_ms, bound_ms=c_bound[0], bound_by=c_bound[1],
                library_ms=None))
            if where_f == own:
                records.append(dict(
                    name=f"fine_kernel ({how}, relax: {row})", route="cuda",
                    source=f"raymarch_tpu_torch/csrc/{'prepass' if fc_p is None else 'fine_culled'}.cu",
                    replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
                    launches=launches["fine_kernel_intervals"], max_abs_err=f_err, ms=fine_ms, plain_ms=f_plain_ms,
                    bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None))
        del pre, pre_k, img, rp
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # -- 11c. K3 at 1080p: config 2, B=4, prepass_chain -----------------------
    rp = cp.make_pallas_image_render_aa(spec2, cfg, WIDTH, HEIGHT, device=dev, prepass_block=4, prepass_chain=True)
    cv2 = camera("config2")
    chain_ms, chain_host_ms, launches = timed_frames(cp, lambda: rp(arrays2, cv2))
    if min(launches["coarse_kernel"], launches["coarse_px_kernel"], launches["fine_kernel"]) <= 0:
        raise AssertionError(f"a kernel of the chained frame never launched: {launches}")
    sc, cam, bnd = rp.scene_args(arrays2, cv2)
    blk = cp.coarse(sc, cam, bnd, rp.params)
    k3_ms = cuda_ms(lambda: cp.coarse_px(sc, cam, bnd, rp.params, *blk), KERNEL_REPS)
    k3_dev = kernel_device_ms(lambda: cp.coarse_px(sc, cam, bnd, rp.params, *blk), "coarse_px_kernel")
    blk_ms = cuda_ms(lambda: cp.coarse(sc, cam, bnd, rp.params), KERNEL_REPS)
    work = cp.WorkCount()
    px_p, k3_plain_ms = plain_ms(lambda: cp.coarse_px_plain(sc, cam, bnd, rp.params, *blk, work=work))
    k3_err = coarse_agreement("full-size coarse_px_kernel (K3) vs coarse_px_plain, config 2, B=4",
                              cp.coarse_px(sc, cam, bnd, rp.params, *blk), px_p, strict=True, exact=True)
    n_px = WIDTH * HEIGHT
    # K3 reads the block planes (t0, status) and writes the pixel planes.
    k3_bound = roofline(march_flops(work, n_px, spec2, False), n_px * 8 + rp.params.brows * rp.params.bcols * 8)
    image_class("full-size chained frame vs the plain path", rp(arrays2, cv2), rp.render_plain(arrays2, cv2))
    # K3 at 1080p on a tape of stack depth 8 (the shared-memory route),
    # static and DYN: equal to its plain version at every pixel.
    k3_deep = {}
    for static in (True, False):
        spec_d, arrays_d = rt.compile_scene(spheres, static=static)
        rp_d = cp.make_pallas_image_render_aa(spec_d, cfg, WIDTH, HEIGHT, device=dev, prepass_block=4,
                                              prepass_chain=True)
        sc_d, cam_d, bnd_d = rp_d.scene_args(arrays_d, camera("spheres"))
        blk_d = cp.coarse(sc_d, cam_d, bnd_d, rp_d.params)
        tag = "static" if static else "DYN"
        coarse_agreement(f"full-size {tag} coarse_px_kernel (K3) vs coarse_px_plain, 64 spheres, B=4 "
                         f"({stack_of(sc_d)})", cp.coarse_px(sc_d, cam_d, bnd_d, rp_d.params, *blk_d),
                         cp.coarse_px_plain(sc_d, cam_d, bnd_d, rp_d.params, *blk_d), strict=True, exact=True)
        k3_deep[tag] = cuda_ms(lambda: cp.coarse_px(sc_d, cam_d, bnd_d, rp_d.params, *blk_d), KERNEL_REPS)
        k3_deep[f"{tag} device"] = kernel_device_ms(
            lambda: cp.coarse_px(sc_d, cam_d, bnd_d, rp_d.params, *blk_d), "coarse_px_kernel")
        del rp_d, sc_d, blk_d
    log(f"K3 alone on 64 spheres (depth 8, shared-memory stack) {WIDTH}x{HEIGHT}, B=4: static "
        f"{k3_deep['static']:.4f} ms, DYN {k3_deep['DYN']:.4f} ms (CUDA events); device time static "
        f"{ms_text(k3_deep['static device'])}, DYN {ms_text(k3_deep['DYN device'])} (torch.profiler) ({smi})")
    log(f"chained prepass (config 2, B=4, prepass_chain) {WIDTH}x{HEIGHT} x16 AA: {chain_ms:.4f} ms/frame "
        f"(host clock {chain_host_ms:.4f} ms), launches {launches}; K3 alone {k3_ms:.4f} ms (device time "
        f"{ms_text(k3_dev)}, torch.profiler; its block pass "
        f"{blk_ms:.4f} ms), coarse_px_plain {k3_plain_ms:.2f} ms, bound {k3_bound[0]:.4f} ms ({k3_bound[1]}; "
        f"{float(work.points):.6e} points) ({smi})")
    records.append(dict(
        name="coarse_px_kernel (K3: config 2, B=4)", route="cuda", source="raymarch_tpu_torch/csrc/coarse_px.cu",
        replaces="raymarch_tpu/ops/pallas_prepass.py:969", launches=launches["coarse_px_kernel"],
        max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound[0], bound_by=k3_bound[1],
        library_ms=None))
    out["chain"] = dict(frame_ms=chain_ms, k3_ms=k3_ms, k3_dev=k3_dev, blk_ms=blk_ms, k3_deep=k3_deep)
    return records, out


# --- phase 13: soft coverage ----------------------------------------------------
SOFT_ADJ_OPS = FLOOR_OPS + 20  # a soft ray's coverage, floor colour and blend, and their adjoint
SOFT_GATE_POS = (0.0, 5.5, 8.0)  # a gate camera 34 degrees down: no horizon in the frame


def soft_rays(cp, p, res):
    """A soft backward's rays from the soft forward's residuals (t, hit,
    s_min, t_min): (work, hit, envelope masks, the surface point's t). Work:
    the ray hit or its coverage passes the gate (scene_grad.cuh soft_work);
    envelope: a working ray whose s_min exceeds min_dist (alpha's derivative
    is not zero); the surface at t on a hit, t_min on a miss, the origin
    (t = 0) where alpha <= 1e-4."""
    import torch

    t, hit, s_min, t_min = res
    alpha = cp.soft_alpha(p, s_min)
    work = (hit > 0) | (alpha > p.soft_gate)
    t_s = torch.where(alpha > 1e-4, torch.where(hit > 0.5, t, t_min), torch.zeros_like(t))
    return work, work & (hit > 0), work & (s_min > p.min_dist), t_s


def soft_residual_agreement(name, cp, p, k, ref):
    """Soft residuals (t, hit, s_min, t_min) of the kernel vs the plain
    version: hit agrees on >= 99.9% of the AA rays; on all but 0.1% of the
    rays with coverage (alpha > 0) s_min agrees within 1e-4 |s_min| + 1e-5
    (a hit ray's s_min is its last sample's distance, under min_dist, which
    an ulp of the position moves by ~5e-7) and t_min within rtol 1e-4 (the
    sampled argmin of a grazing ray can move by a step); t within rtol 1e-4
    on all but 0.1% of the rays that hit in both. Returns max |s_min diff|
    there."""
    (tk, hk, sk, mk), (tp, hp, sp, mp) = k, ref
    agree = float((hk == hp).float().mean())
    cov = cp.soft_alpha(p, sp) > 0.0
    both = (hk == 1) & (hp == 1)
    off_s = float(((sk - sp).abs() > 1e-4 * sp.abs() + 1e-5)[cov].float().mean())
    off_m = float(((mk - mp).abs() > 1e-4 * mp.abs())[cov].float().mean())
    off_t = float(((tk - tp).abs() > 1e-4 * tp.abs())[both].float().mean()) if bool(both.any()) else 0.0
    mx = float((sk - sp).abs()[cov].max())
    ok = agree >= 0.999 and bool(cov.any()) and max(off_s, off_m, off_t) < 1e-3
    log(f"{name}: hit agree={agree:.6f} (need >=0.999); over {int(cov.sum())} covered rays s_min off "
        f"{off_s:.3e}, t_min off {off_m:.3e}; t off {off_t:.3e} over {int(both.sum())} hit rays; max|d s_min| "
        f"{mx:.3e} (need each share < 1e-3) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")
    return mx


def image_max(name, img, ref):
    """Exact-semantics class (bench.py:243-247): max |d| < 1e-3."""
    mx = float((img - ref).abs().max())
    ok = mx < 1e-3
    log(f"{name}: max|d|={mx:.3e} mean|d|={float((img - ref).abs().mean()):.3e} (need max<1e-3) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside its tolerance")
    return mx


def k8_soft_bound(cp, sc, p, cam, res, lay, n_rays):
    """(bound_ms, bound_by, operations, bytes) of the soft legacy backward
    on these residuals. Per working ray: the tape at the 4 taps of its
    surface point, the coverage and floor and the shading adjoint; per hit
    ray the tape at the hit point (the implicit term), per envelope ray at
    o + d t_min; the reverse of each evaluation (4 operations per
    instruction, ADJ_FACTOR x the leaf work of the leaves the cotangent
    reaches, `k8_reached` at each point); on a painted scene one colour walk
    at the surface point and its reverse. Bytes: hit and s_min for every
    ray, t and t_min for the working rays, the cotangent of their pixels,
    the gradient row."""
    t, hit, s_min, t_min = res
    spec = sc.spec
    n_push, leaf_ops, comb = scene_cost(spec)
    tape_ops = n_push * leaf_ops + comb
    n_real = len(spec.static_tape)
    work, hits, env, t_s = soft_rays(cp, p, res)
    n_work, n_hit, n_env = (float(m.sum()) for m in (work, hits, env))
    r_s = k8_reached(sc, p, cam, t_s, work)
    reached = 4 * r_s + k8_reached(sc, p, cam, t, hits) + k8_reached(sc, p, cam, t_min, env)
    evals = 4 * n_work + n_hit + n_env
    flops = (evals * (tape_ops + 4 * n_real) + n_work * (ADJ_RAY_OPS + SOFT_ADJ_OPS)
             + ADJ_FACTOR * leaf_ops * reached)
    if spec.has_materials:
        flops += (n_work * (tape_ops + n_push * COLOR_OPS + COLOR_ADJ_OPS * n_real)
                  + ADJ_FACTOR * (leaf_ops + COLOR_OPS) * r_s)
    nbytes = n_rays * 8 + n_work * 8 + hit_pixels(work.float()) * 12 + lay.nscal * 4
    ms, by = roofline(flops, nbytes)
    return ms, by, flops, nbytes


def k9_soft_bound(cp, sc, cull, p, cam, res, n_rays):
    """(bound_ms, bound_by, operations, bytes) of the soft compact backward
    on these residuals: the compact scene and the reverse of its winning
    source (`k9_work`) at the 4 taps of each working ray's surface point,
    at each hit ray's hit point and at each envelope ray's o + d t_min, the
    coverage and shading adjoints; hit and s_min for every ray, t and t_min
    for the working rays, the cotangent of their pixels, the lists once,
    one gradient row."""
    spec = sc.spec
    t, hit, s_min, t_min = res
    work, hits, env, t_s = soft_rays(cp, p, res)
    f_s, r_s = k9_work(sc, cull, p, cam, t_s, work)
    f_h, r_h = k9_work(sc, cull, p, cam, t, hits)
    f_e, r_e = k9_work(sc, cull, p, cam, t_min, env)
    n_work = float(work.sum())
    flops = 4 * (f_s + r_s) + f_h + r_h + f_e + r_e + n_work * (ADJ_RAY_OPS + SOFT_ADJ_OPS)
    nbytes = (n_rays * 8 + n_work * 8 + hit_pixels(work.float()) * 12 + 4 * (cull.lists.numel() + cull.counts.numel())
              + 4 * (16 * spec.n_leaves + spec.n_instr + 7))
    ms, by = roofline(flops, nbytes)
    return ms, by, flops, nbytes


def soft(rt, cp, cg, dev, smi, cfg):
    """Phase 13: soft coverage (see the module docstring). Gates of every
    soft build at 256x144, then bench.py's three soft training rows at
    1920x1080 with 16 AA rays per pixel and a 5-step soft pose fit. Returns
    the kernel records of the rows' soft builds and their numbers."""
    import numpy as np
    import torch

    cfg64 = dataclasses.replace(cfg, leaf_cull=True)  # bench.py:855-860: relax 1
    nocull = cfg
    spheres, chain, cluster = scenes_bench64(rt)
    camera_h = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    camera64 = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))

    # -- 13a. every soft build against its plain version at 256x144 ----------
    # name, scene, config, gate camera, (backward kind, reason), K8's warp-row build
    gates = (
        ("config2", scene_config2(rt), nocull, (0.0, 2.6, 4.2), ("pallas_legacy_unrolled", "leaf_cull disabled"),
         False),
        ("16 painted spheres", scene_painted(rt, 16), nocull, SOFT_GATE_POS,
         ("pallas_legacy_unrolled", "painted materials in soft mode"), True),
        ("64 painted spheres", scene_painted(rt), nocull, SOFT_GATE_POS,
         ("pallas_legacy_unrolled", "painted materials in soft mode"), True),
        ("64 spheres & box", scene_spheres(rt) & rt.box(half_extents=(3.2, 1.2, 3.2)), cfg64, SOFT_GATE_POS,
         ("pallas_legacy_unrolled", "plan has residual (unrolled) subtrees"), True),
        ("64 spheres (pool)", spheres, cfg64, SOFT_GATE_POS, ("pallas_compact", None), False),
        ("smooth chain (seg1)", chain, cfg64, SOFT_GATE_POS, ("pallas_compact", None), False),
        ("cluster scene (stream, 2 groups)", cluster, cfg64, SOFT_GATE_POS, ("pallas_compact", None), False),
    )
    for name, scene, cfg_g, pos, route, long_build in gates:
        spec_g, arrays_g = rt.compile_scene(scene, static=True)
        fr = cg.make_fused_render_vjp(spec_g, cfg_g, GATE_W, GATE_H, soft=True, device=dev)
        info = (fr.backward_info["kind"], fr.backward_info["reason"])
        if info != route or not fr.backward_info["soft"] or (not fr.compact_bwd and fr.layout.long != long_build):
            raise AssertionError(f"soft gate {name} routes to {fr.backward_info}, long {fr.layout.long}")
        if name.startswith("cluster") and len(cg.build_compact_plan(spec_g)["stream"]) != 2:
            raise AssertionError("the cluster scene's plan lost its two stream groups")
        p = fr.params
        cv = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device=dev)
        sc, cam, bnd = fr.prepass.scene_args(arrays_g, cv)
        _, fc = fr.prepass.cull_args(sc, cam)
        img_k, *res_k = cp.fine_res(sc, cam, bnd, p, cull=fc)
        img_p, *res_p = cp.fine_res_plain(sc, cam, bnd, p, cull=fc)
        mode = "un-culled" if fc is None else ("lists" if fc.compact else "gated tape")
        image_max(f"gate soft fine kernel vs fine_res_plain, {name} ({mode})", img_k, img_p)
        soft_residual_agreement(f"gate soft residuals, {name}", cp, p, res_k, res_p)
        g_img = seeded_cotangent(GATE_H, GATE_W, dev, 11)
        t, hit, s_min, t_min = res_k
        if fr.compact_bwd:
            what = f"compact_bwd_kernel soft ({cg.plan_kind(spec_g)})"
            clamp = fr.layout.grad_denom_clamp
            got = cg.compact_bwd(sc, fc, cam, p, clamp, t, hit, g_img, soft=(s_min, t_min))
            ref = cg.compact_bwd_plain(sc, fc, cam, p, clamp, t, hit, g_img, band_rows=16, soft=(s_min, t_min))
        else:
            what = "fused_bwd_kernel" + (" (warp rows)" if fr.layout.long else " (per-thread rows)") + " soft" + (
                " (albedo words)" if spec_g.has_materials else "")
            got = cg.bwd(sc, cam, p, fr.layout, t, hit, g_img, soft=(s_min, t_min))
            ref = cg.bwd_plain(sc, cam, p, fr.layout, t, hit, g_img, band_rows=16, soft=(s_min, t_min))
        work = soft_rays(cp, p, res_k)[0]
        grad_class(f"gate {what} vs its plain version, {name} ({int(work.sum())} working rays of "
                   f"{work.numel()}, {int(hit.sum())} hit)", got, ref)
        if spec_g.has_materials:
            word_class(f"soft gate, {name}", "albedo and flag words", got[0][:, 12:16], ref[0][:, 12:16],
                       float(ref[0][:, :12].abs().max()))
        del img_k, img_p, res_k, res_p, got, ref
    torch.cuda.synchronize()

    # -- 13b. bench.py's soft rows at 1080p ----------------------------------
    # row, scene, config, camera, the reference's backward_info (kind,
    # compact, reason, soft), rows of the plain passes (None: the frame)
    spec_s, arrays_s = rt.compile_scene(scene_config2(rt), static=True)
    spec64, arrays64 = rt.compile_scene(spheres, static=True)
    rows = (
        ("fwdbwd_soft", spec_s, arrays_s, nocull, camera_h,
         ("pallas_legacy_unrolled", False, "leaf_cull disabled", True), None),
        ("fwdbwd_64leaf_soft", spec64, arrays64, cfg64, camera64, ("pallas_compact", True, None, True), PLAIN_BAND),
        ("fwdbwd_64leaf_soft_la24", spec64, arrays64, dataclasses.replace(cfg64, soft_cull_log_alpha=24.0),
         camera64, ("pallas_compact", True, None, True), PLAIN_BAND),
    )
    n_rays = WIDTH * HEIGHT * cfg.aa_samples ** 2
    n_px = WIDTH * HEIGHT
    records, out = [], {}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for row, spec_r, arrays_r, cfg_r, camera, info_ref, band in rows:
        render = rt.make_renderer(spec_r, WIDTH, HEIGHT, cfg_r, mode="soft", backend="pallas_fused", device=dev)
        bi = render.backward_info
        if (bi["kind"], bi["compact"], bi["reason"], bi["soft"]) != info_ref:
            raise AssertionError(f"{row} routes to {bi}, the reference's is {info_ref}")
        fr = render.renderer
        cv = rt.cam_vec(camera, device=dev)
        lp0 = torch.tensor(arrays_r.leaf_params, device=dev)
        op0 = torch.tensor(arrays_r.op_param, device=dev)

        def fwd_bwd(fr=fr, arrays_r=arrays_r, lp0=lp0, op0=op0, cv=cv):
            lp = lp0.clone().requires_grad_(True)
            opp = op0.clone().requires_grad_(True)
            c = cv.clone().requires_grad_(True)
            img = fr(dataclasses.replace(arrays_r, leaf_params=lp, op_param=opp), c)
            torch.mean(img * img).backward()
            return img, (lp.grad, opp.grad, c.grad)

        for _ in range(BWD_WARMUP):
            fwd_bwd()
        torch.cuda.synchronize()
        cp.reset_launch_counts()
        cg.reset_launch_counts()
        e0.record()
        for _ in range(BWD_STEPS):
            img, grads = fwd_bwd()
        e1.record()
        torch.cuda.synchronize()
        step_ms = e0.elapsed_time(e1) / BWD_STEPS
        kname = "compact_bwd_kernel" if fr.compact_bwd else "fused_bwd_kernel"
        launches = {"fine_kernel_soft_residuals": cp.fine_res.soft_launches,
                    f"{kname} (soft)": (cg.compact_bwd if fr.compact_bwd else cg.bwd).soft_launches,
                    "coarse_kernel": cp.coarse.launches + cp.coarse.interval_launches,
                    "fine_kernel_residuals": cp.fine_res.launches, "fused_bwd_kernel": cg.bwd.launches,
                    "compact_bwd_kernel": cg.compact_bwd.launches}
        log(f"{row}: soft training step {WIDTH}x{HEIGHT} x16 AA, fwd+bwd of mean(img^2) through make_renderer("
            f"mode 'soft', backend 'pallas_fused'): {step_ms:.4f} ms/step (CUDA events, {BWD_STEPS} steps after "
            f"{BWD_WARMUP} warm-up), {n_rays / (step_ms * 1e-3) / 1e9:.4f} Grays/s; backward_info {bi}; "
            f"launches {launches} on {smi}")
        soft_k = launches[f"{kname} (soft)"]
        if min(launches["fine_kernel_soft_residuals"], soft_k) < BWD_STEPS or any(
                launches[k] for k in ("coarse_kernel", "fine_kernel_residuals", "fused_bwd_kernel",
                                      "compact_bwd_kernel")):
            raise AssertionError(f"{row} did not run its soft kernels alone: {launches}")
        if not all(bool(torch.isfinite(g).all()) for g in grads) or float(grads[0].abs().max()) <= 0:
            raise AssertionError(f"{row}: the gradients are not finite or all zero")
        idle, busy = device_idle_share(fwd_bwd, 3, step_ms)

        # The kernels alone on the frame, and against their plain versions.
        rp, p = fr.prepass, fr.params
        sc, cam, bnd = rp.scene_args(arrays_r, cv)
        cull_ms = cuda_ms(lambda: rp.cull_args(sc, cam), KERNEL_REPS) if cfg_r.leaf_cull else 0.0
        _, fc = rp.cull_args(sc, cam)
        active = None if fc is None else float(fc.counts.sum(1).float().mean())
        img_r, *res = cp.fine_res(sc, cam, bnd, p, cull=fc)
        image_class(f"{row}: training-path image vs the soft fine kernel's", img.detach(), img_r)
        g_img = 2.0 * img_r / img_r.numel()  # the cotangent of mean(img^2)
        t, hit, s_min, t_min = res
        k2_ms = cuda_ms(lambda: cp.fine_res(sc, cam, bnd, p, cull=fc), KERNEL_REPS)
        if fr.compact_bwd:
            bwd_k = lambda: cg.compact_bwd(sc, fc, cam, p, fr.layout.grad_denom_clamp, t, hit, g_img,  # noqa: E731
                                           soft=(s_min, t_min))
        else:
            bwd_k = lambda: cg.bwd(sc, cam, p, fr.layout, t, hit, g_img, soft=(s_min, t_min))  # noqa: E731
        bwd_ms = cuda_ms(bwd_k, KERNEL_REPS)
        got = bwd_k()
        grad_class(f"{row}: training-path gradients vs the soft backward kernel's", grads, got)
        work, _, env, _ = soft_rays(cp, p, res)
        n_work, n_hit, n_env = float(work.sum()), float(hit.sum()), float(env.sum())
        work_f = cp.WorkCount()
        torch.cuda.reset_peak_memory_stats()
        (img_p, *res_p), k2_plain_ms = plain_ms(lambda: cp.fine_res_plain(sc, cam, bnd, p, cull=fc, work=work_f))
        k2_err = image_class(f"{row}: full-size soft fine kernel vs fine_res_plain", img_r, img_p)
        soft_residual_agreement(f"{row}: full-size soft residuals", cp, p, res, res_p)
        del img_p, res_p
        lists = 0 if fc is None else 4 * (fc.lists.numel() + fc.counts.numel())
        k2_bound = roofline(march_flops(work_f, n_rays, spec_r, fc is not None and fc.compact, float(work_f.hits),
                                        fine=True), n_px * 12 + n_rays * 16 + lists)
        if (band is None) == fr.compact_bwd:
            raise AssertionError(f"{row}: the plain K8 runs on the frame, the plain K9 on a band")
        if band is None:
            where = "the whole frame"
            e0.record()
            ref = cg.bwd_plain(sc, cam, p, fr.layout, t, hit, g_img, soft=(s_min, t_min))
            e1.record()
            torch.cuda.synchronize()
            bwd_plain_ms = e0.elapsed_time(e1)
            bwd_err = grad_class(f"{row}: full-size {kname} soft vs bwd_plain ({where})", got, ref)
        else:
            # The plain compact fold over this frame's long soft lists: one
            # band in the middle of the frame, its forward, lists and
            # residuals from a band renderer (cam[7] = its first row).
            r0 = (HEIGHT - band) // 2
            where = f"one {band}-row band at row {r0}"
            rb = cp.make_pallas_image_render_aa(spec_r, cfg_r, WIDTH, HEIGHT, device=dev, no_prepass=True, soft=True,
                                                band_rows=band)
            sc_b, cam_b, bnd_b = rb.scene_args(arrays_r, rt.cam_vec(camera, float(r0), device=dev))
            _, fc_b = rb.cull_args(sc_b, cam_b)
            img_b, t_b, hit_b, s_b, m_b = cp.fine_res(sc_b, cam_b, bnd_b, rb.params, cull=fc_b)
            g_b = 2.0 * img_b / img_r.numel()
            got_b = cg.compact_bwd(sc_b, fc_b, cam_b, rb.params, fr.layout.grad_denom_clamp, t_b, hit_b, g_b,
                                   soft=(s_b, m_b))
            e0.record()
            ref = cg.compact_bwd_plain(sc_b, fc_b, cam_b, rb.params, fr.layout.grad_denom_clamp, t_b, hit_b, g_b,
                                       soft=(s_b, m_b))
            e1.record()
            torch.cuda.synchronize()
            bwd_plain_ms = e0.elapsed_time(e1)
            bwd_err = grad_class(f"{row}: {kname} soft vs its plain version ({where})", got_b, ref)
            del img_b, t_b, hit_b, s_b, m_b, got_b
        if fr.compact_bwd:
            b_ms, b_by, b_ops, b_bytes = k9_soft_bound(cp, sc, fc, p, cam, res, n_rays)
        else:
            b_ms, b_by, b_ops, b_bytes = k8_soft_bound(cp, sc, p, cam, res, fr.layout, n_rays)
        log(f"{row}: kernels alone: soft fine kernel {k2_ms:.4f} ms (plain {k2_plain_ms:.2f} ms on the frame, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; bound {k2_bound[0]:.4f} ms, {k2_bound[1]}; "
            f"{float(work_f.points):.6e} march points, {float(work_f.hits):.0f} rays shaded), {kname} soft "
            f"{bwd_ms:.4f} ms (plain {bwd_plain_ms:.2f} ms on {where}; bound {b_ms:.4f} ms, {b_by}; "
            f"{b_ops:.6e} operations, {b_bytes:.6e} bytes); rays: {n_hit:.0f} hit, {n_work:.0f} working, "
            f"{n_env:.0f} envelope of {n_rays}; cull_args {cull_ms:.4f} ms, mean active items per fine tile "
            f"{'-' if active is None else f'{active:.4f}'}; device idle share "
            f"{'not measured' if idle is None else f'{idle:.4f} ({busy:.4f} ms busy a step)'} ({smi})")
        log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
        how = "un-culled" if fc is None else "culled lists"
        records.append(dict(
            name=f"fine_kernel (soft, {how}, residuals t, hit, s_min, t_min: {row})", route="cuda",
            source="raymarch_tpu_torch/csrc/fine_soft.cu", replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
            launches=launches["fine_kernel_soft_residuals"], max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
            bound_ms=k2_bound[0], bound_by=k2_bound[1], library_ms=None))
        records.append(dict(
            name=f"{kname} (soft{', pool' if fr.compact_bwd else ''}: {row}; plain on {where})", route="cuda",
            source=f"raymarch_tpu_torch/csrc/{'compact_bwd' if fr.compact_bwd else 'fused_bwd'}.cu",
            replaces=f"raymarch_tpu/ops/pallas_grad.py:{256 if fr.compact_bwd else 1432}", launches=soft_k,
            max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
        out[row] = dict(step_ms=step_ms, k2_ms=k2_ms, bwd_ms=bwd_ms, kname=kname, idle=idle, cull_ms=cull_ms,
                        active=active, k2_bound=k2_bound[0], bwd_bound=b_ms, k2_plain_ms=k2_plain_ms,
                        bwd_plain_ms=bwd_plain_ms, where=where, launches=launches)
        del res, t, hit, s_min, t_min, got, ref, img, img_r, grads, g_img
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # -- 13c. a 5-step soft pose fit of fwdbwd_64leaf_soft --------------------
    target = rt.make_renderer(spec64, WIDTH, HEIGHT, cfg64, mode="soft", backend="pallas_fused",
                              device=dev)(arrays64, camera64).detach()
    d = np.asarray([0.08, -0.05, 0.06, 0.01, -0.01, 0.01, 0.0], np.float32)
    start = rt.Camera(np.asarray(camera64.position) + d[:3], np.asarray(camera64.rotation) + d[3:])
    fit_kw = dict(width=WIDTH, height=HEIGHT, cfg=cfg64, optimizer=functools.partial(torch.optim.SGD, lr=0.0),
                  fit_camera=True, camera_optimizer=functools.partial(torch.optim.Adam, lr=1e-2), mode="soft",
                  backend="pallas_fused", device=dev, log_fn=lambda m: None)
    rt.fit_scene(spec64, arrays64, start, target, steps=1, **fit_kw)
    res = rt.fit_scene(spec64, arrays64, start, target, steps=FIT_STEPS, **fit_kw)
    pos = res.camera.position.detach().cpu().numpy()
    err0 = float(np.abs(d[:3]).max())
    err1 = float(np.abs(pos - np.asarray(camera64.position)).max())
    fit_s = 1.0 / res.steps_per_sec
    log(f"soft pose fit of fwdbwd_64leaf_soft at {WIDTH}x{HEIGHT} ({FIT_STEPS} Adam steps, lr 1e-2, the pose "
        f"only): loss {res.losses[0]:.6e} -> {res.losses[-1]:.6e}; max |position - truth| {err0:.4f} -> "
        f"{err1:.4f}; {fit_s:.4f} s/step; backward {res.backward_info} ({smi})")
    if not (res.backward_info["soft"] and res.losses[-1] < res.losses[0]):
        raise AssertionError("the soft pose fit did not lower the loss")
    return records, dict(rows=out, fit_s=fit_s)



# --- phase 14: the render surfaces (K5, K6, K7, K2's march-only build) -------
MARCH_STEPS_WARMUP, MARCH_STEPS = 1, 4  # fwdbwd_jnp steps (bench.py:928: 4 frames after 1)
SURFACE_WIDE_POS = (0.0, 2.5, 9.0)  # the many-sphere scenes' gate camera of phase 14
K5_GATE_COUNTS = (1, 31, 33, (1 << 20) + 5)  # rays of the K5 gates: part-filled runs, warps and grids


def march_agreement(name, k, p):
    """K5/K6 (or the march-only build) against their plain versions: hit
    (and steps where given) equal on every ray, t within 1e-5 on hits.
    Returns max |t diff| on hits."""
    import torch

    (tk, hk, *sk), (tp, hp, *sp) = k, p
    hit_eq = bool(torch.equal(hk, hp))
    steps_eq = bool(torch.equal(sk[0], sp[0])) if sk else True
    both = hp > 0.5
    mx = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
    ok = hit_eq and steps_eq and mx <= 1e-5
    log(f"{name}: hit equal={hit_eq} steps equal={steps_eq if sk else 'n/a'} max|d t| on "
        f"{int(both.sum())} hit rays={mx:.3e} (need equal, equal, <=1e-5) {'PASS' if ok else 'FAIL'}")
    if not ok:
        diff = (hk != hp) | ((sk[0] != sp[0]) if sk else False)
        log(f"  {int(diff.sum())} rays differ, first at {diff.nonzero()[:5].flatten().tolist()}")
        raise AssertionError(f"{name} outside its tolerance")
    return mx


def ray_agreement(name, k, p):
    """K5 against ray_march_plain: t, hit and steps equal on every ray."""
    import torch

    eq = [bool(torch.equal(a, b)) for a, b in zip(k, p)]
    ok = all(eq) and len(k) == len(p) == 3
    log(f"{name}: {k[0].numel()} rays, t / hit / steps equal {eq} (need all equal) {'PASS' if ok else 'FAIL'}")
    if not ok:
        diff = (k[0] != p[0]) | (k[1] != p[1]) | (k[2] != p[2])
        log(f"  {int(diff.sum())} rays differ, first at {diff.nonzero()[:5].flatten().tolist()}")
        raise AssertionError(f"{name} outside its tolerance")
    return 0.0


def aa_mean(rgb, h, w):
    import torch

    return torch.stack(rgb, dim=-1).reshape(h, w, -1, 3).mean(dim=2)


def surfaces(rt, cp, dev, smi, cfg, gcam_pos):
    """Phase 14: the render surfaces of the reference's make_renderer (see
    the module docstring). Returns the kernel records of K5, K6, K7 and K2's
    march-only build, and the rows' numbers."""
    import numpy as np
    import torch

    from raymarch_tpu_torch.ops import cuda_march as cm

    t_phase = time.perf_counter()
    cfg_ir = dataclasses.replace(cfg, relax=1.6)
    gcv = rt.cam_vec(rt.Camera.looking_at(position=gcam_pos, target=(0, 0, 0)), device=dev)

    # -- 14a. gates at 256x144 ------------------------------------------------
    # K5 (raygen_flat rays of the gate camera, a count that is no multiple of
    # 128), K6, K7 per AA ray and K7's pixel build, each against its plain
    # version, on every stack route (config 2: a register; 64 spheres and 16
    # painted spheres, depth 8: shared memory, the painted scene's colour
    # walk on four stacks there) and flag (DYN, relax, MATS).
    wide = rt.Camera.looking_at(position=SURFACE_WIDE_POS, target=(0, 0, 0))
    near = rt.Camera.looking_at(position=gcam_pos, target=(0, 0, 0))
    gates = (
        ("config2 static", scene_config2(rt), True, cfg, near),
        ("config2 dynamic", scene_config2(rt), False, cfg, near),
        ("empty dynamic", None, False, cfg, near),
        ("rich dynamic", scene_rich(rt), False, cfg, near),
        ("painted spheres dynamic", scene_painted(rt, 16), False, cfg, near),
        ("config2 relax 1.6", scene_config2(rt), True, cfg_ir, near),
        ("64 spheres static (depth 8)", scene_spheres(rt, 64), True, cfg, wide),
        ("16 painted spheres static (depth 8)", scene_painted(rt, 16), True, cfg, wide),
    )
    for name, scene, static, cfg_g, cam_g in gates:
        spec_g, arrays_g = rt.compile_scene(scene, static=static)
        cv_g = rt.cam_vec(cam_g, device=dev)
        fm = cm.FlatMarch(spec_g, cfg_g, GATE_W, GATE_H, dev)
        sc, cam, bound = fm.scene_args(arrays_g, cv_g)
        log(f"gate {name}: stack route {cm.route_name(sc.route)}, depth {spec_g.stack_depth}, "
            f"{'DYN' if sc.dynamic else 'static'}, materials {spec_g.has_materials}")
        march_agreement(f"gate K6 image_march vs image_march_plain, {name}", cm.image_march(sc, cam, bound, fm.params),
                        cm.image_march_plain(sc, cam, bound, fm.params))
        n5 = GATE_W * GATE_H * cfg_g.aa_samples ** 2 - 77  # not a multiple of 128
        o, d = rt.raygen_flat(torch.arange(n5, device=dev), cam_g.position, cam_g.rotation, GATE_W, GATE_H, cfg_g)
        o, d = o.contiguous(), d.contiguous()
        march_agreement(f"gate K5 ray_march vs ray_march_plain ({n5} raygen_flat rays), {name}",
                        cm.ray_march(sc, bound, fm.params, o, d), cm.ray_march_plain(sc, bound, fm.params, o, d))
        img_p = cm.image_pixels_plain(sc, cam, bound, fm.params)
        img_k = aa_mean(cm.image_render(sc, cam, bound, fm.params), GATE_H, GATE_W)
        image_max(f"gate K7 image_render vs image_render_plain, {name}", img_k, img_p)
        image_max(f"gate K7 pixel build vs image_pixels_plain, {name}", cm.image_pixels(sc, cam, bound, fm.params),
                  img_p)
        if scene is None:
            fl = float((img_k[..., 2] > img_k[..., 1]).float().mean())  # the floor's blue base
            log(f"  empty scene: floor share {fl:.4f}, finite {bool(torch.isfinite(img_k).all())}")
            if not fl > 0.1:
                raise AssertionError("the empty scene shows no floor")
    # K5 (march.cuh march_kernel, SRC 0): t, hit and steps equal to
    # ray_march_plain's on every ray, at counts that leave a warp or a block
    # part-filled (1, 31, 33, 2^20 + 5), on the camera's rays and on seeded
    # incoherent rays (origins uniform in [-3, 3]^3, directions uniform on
    # the sphere), on a dynamic tape, at relax 1.6 and on 64 spheres (the
    # stack in shared memory).
    rng = np.random.default_rng(13)
    for name, scene, static, cfg_g, cam_g in (("config2 dynamic", scene_config2(rt), False, cfg, near),
                                              ("config2 relax 1.6", scene_config2(rt), True, cfg_ir, near),
                                              ("64 spheres static (depth 8)", scene_spheres(rt, 64), True, cfg, wide)):
        spec_g, arrays_g = rt.compile_scene(scene, static=static)
        fm = cm.FlatMarch(spec_g, cfg_g, 1, 1, dev)
        sc, _, bound = fm.scene_args(arrays_g)
        for n5 in K5_GATE_COUNTS:
            o_i = rng.uniform(-3.0, 3.0, (n5, 3)).astype(np.float32)
            d_i = rng.normal(size=(n5, 3))
            d_i = (d_i / np.linalg.norm(d_i, axis=1, keepdims=True)).astype(np.float32)
            o_c, d_c = rt.raygen_flat(torch.arange(n5, device=dev) % (GATE_W * GATE_H * cfg_g.aa_samples ** 2),
                                      cam_g.position, cam_g.rotation, GATE_W, GATE_H, cfg_g)
            for kind, o, d in (("camera", o_c.contiguous(), d_c.contiguous()),
                               ("incoherent", torch.tensor(o_i, device=dev), torch.tensor(d_i, device=dev))):
                ray_agreement(f"gate K5 march_kernel vs ray_march_plain, {name}, {n5} {kind} rays",
                              cm.ray_march(sc, bound, fm.params, o, d), cm.ray_march_plain(sc, bound, fm.params, o, d))
    # K7's pixel build at every kind of AA sum: aa 2 and 4 by xor shuffles
    # within a warp, aa 3 and 8 through shared memory (after the stacks'
    # columns on the shared-memory route).
    for name, scene, cam_g, aas in (("config2 static", scene_config2(rt), near, (2, 3, 4, 8)),
                                    ("16 painted spheres static", scene_painted(rt, 16), wide, (3, 8)),
                                    ("64 spheres static", scene_spheres(rt, 64), wide, (3,))):
        spec_g, arrays_g = rt.compile_scene(scene, static=True)
        cv_g = rt.cam_vec(cam_g, device=dev)
        for aa in aas:
            fm = cm.FlatMarch(spec_g, dataclasses.replace(cfg, aa_samples=aa), GATE_W, GATE_H, dev)
            sc, cam, bound = fm.scene_args(arrays_g, cv_g)
            image_max(f"gate K7 pixel build vs image_pixels_plain, {name}, aa {aa} "
                      f"({'shuffles' if 32 % (aa * aa) == 0 else 'shared memory'})",
                      cm.image_pixels(sc, cam, bound, fm.params), cm.image_pixels_plain(sc, cam, bound, fm.params))
    spec_s, arrays_s = rt.compile_scene(scene_config2(rt), static=True)
    gcam = near
    for kw, cfg_m in ((dict(prepass_block=1), cfg), (dict(prepass_block=1, n_intervals=2), cfg_ir)):
        rp = cp.make_pallas_image_march_fast(spec_s, cfg_m, GATE_W, GATE_H, device=dev, **kw)
        sc2, cam2, bound2 = rp.scene_args(arrays_s, gcv)
        pre = rp.prepass(sc2, cam2, bound2, None)
        got = cp.fine_march(sc2, cam2, bound2, rp.params, *pre)
        _, t_p, h_p = cp.fine_res_plain(sc2, cam2, bound2, rp.params, *pre)
        march_agreement(f"gate K2 march-only vs fine_res_plain's (t, hit), {kw}, relax {cfg_m.relax}", got,
                        (t_p.reshape(-1), h_p.reshape(-1)))
    # make_renderer(backend="pallas", mode="implicit") against backend "jnp",
    # without bound_accel and with it: K5 starts every ray at t = 0 and
    # takes from the bound only its miss test and exit cap, so both march
    # the same samples either way (the JAX package's flat kernels start at
    # the bound's entry, where its two backends part: ROADMAP §3 fault 15).
    def pallas_vs_jnp(cfg_g):
        grads = {}
        for backend in ("pallas", "jnp"):
            lp = torch.tensor(arrays_s.leaf_params, device=dev, requires_grad=True)
            opp = torch.tensor(arrays_s.op_param, device=dev, requires_grad=True)
            pos = torch.tensor(np.asarray(gcam.position, np.float32), device=dev, requires_grad=True)
            rot = torch.tensor(np.asarray(gcam.rotation, np.float32), device=dev, requires_grad=True)
            render = rt.make_renderer(spec_s, GATE_W, GATE_H, cfg_g, mode="implicit", backend=backend,
                                      chunk=1 << 18, device=dev)
            img = render(dataclasses.replace(arrays_s, leaf_params=lp, op_param=opp), rt.Camera(pos, rot))
            torch.mean(img * img).backward()
            grads[backend] = (lp.grad, opp.grad, torch.cat([pos.grad, rot.grad, pos.grad.new_zeros(1)]))
        return grads

    g = pallas_vs_jnp(dataclasses.replace(cfg, bound_accel=False))
    grad_class("gate make_renderer(pallas, implicit) vs make_renderer(jnp, implicit) gradients, no bound_accel",
               g["pallas"], g["jnp"])
    g = pallas_vs_jnp(cfg)
    grad_class("gate make_renderer(pallas, implicit) vs make_renderer(jnp, implicit) gradients, bound_accel",
               g["pallas"], g["jnp"])
    torch.cuda.synchronize()
    log(f"phase 14 gates: {time.perf_counter() - t_phase:.1f} s")

    # -- 14b. bench.py's rows at 1080p ------------------------------------------
    camera = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    cv = rt.cam_vec(camera, device=dev)
    n_rays = WIDTH * HEIGHT * cfg.aa_samples ** 2
    n_px = WIDTH * HEIGHT
    spec_d, arrays_d = rt.compile_scene(scene_config2(rt))  # the reference's default: a dynamic tape
    out, records = {}, []

    def timed(fn, counter, frames=FRAMES, warmup=WARMUP):
        counter.launches = 0
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(frames):
            r = fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / frames, counter.launches, r

    def record(name, source, replaces, launches, err, ms, p_ms, bound):
        records.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                            max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                            library_ms=None))

    # march_only: K6 (bench.py:657-674), static and dynamic tapes: the frame
    # through make_pallas_image_march (the parameters' upload and the bound
    # included), and K6 alone on the frame's prepared arguments.
    for tag, spec_m, arrays_m in (("static", spec_s, arrays_s), ("dynamic", spec_d, arrays_d)):
        im = cm.make_pallas_image_march(spec_m, cfg, WIDTH, HEIGHT, device=dev)
        ms, launches, (t_k, h_k, s_k) = timed(lambda: im(arrays_m, cv), cm.image_march)
        st = rt.march_stats(s_k, h_k, 32)
        sc, cam, bound = im.flat.scene_args(arrays_m, cv)
        k_ms = cuda_ms(lambda: cm.image_march(sc, cam, bound, im.flat.params), KERNEL_REPS)
        work = cp.WorkCount()
        ref, p_ms = plain_ms(lambda: cm.image_march_plain(sc, cam, bound, im.flat.params, work=work))
        err = march_agreement(f"march_only K6 ({tag} tape) vs image_march_plain at 1080p", (t_k, h_k, s_k), ref)
        del ref
        bnd = roofline(march_flops(work, n_rays, spec_s, False), n_rays * 12)
        log(f"march_only ({tag} tape): {ms:.4f} ms/frame (CUDA events, {FRAMES} frames after {WARMUP}), "
            f"{n_rays / (ms * 1e-3) / 1e9:.4f} Grays/s, launches {launches}; K6 alone {k_ms:.4f} ms; {st}; plain "
            f"{p_ms:.2f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}; {float(work.points):.6e} points); stack route "
            f"{cm.route_name(sc.route)} ({smi})")
        out[f"march_only_{tag}"] = dict(ms=ms, kernel_ms=k_ms, grays=n_rays / (ms * 1e-3) / 1e9, stats=st,
                                        launches=launches, plain_ms=p_ms, bound=bnd)
        record("image_march_kernel (K6)" + ("" if tag == "static" else ", dynamic tape"),
               "raymarch_tpu_torch/csrc/march.cuh", "raymarch_tpu/ops/pallas_march.py:1390", launches, err, k_ms,
               p_ms, bnd)
        del t_k, h_k, s_k

    # march_only_fast: K1's interval scan + K2's march-only build (bench.py:678-693).
    imf = cp.make_pallas_image_march_fast(spec_s, cfg_ir, WIDTH, HEIGHT, device=dev, prepass_block=1,
                                          n_intervals=2)
    cp.reset_launch_counts()
    ms_f, launches_f, (t_f, h_f) = timed(lambda: imf(arrays_s, cv), cp.fine_march)
    coarse_launches = cp.coarse.interval_launches
    sc, cam, bound = imf.scene_args(arrays_s, cv)
    pre = imf.prepass(sc, cam, bound, None)
    fm_ms = cuda_ms(lambda: cp.fine_march(sc, cam, bound, imf.params, *pre), KERNEL_REPS)
    work = cp.WorkCount()
    (_, t_p, h_p), p_ms = plain_ms(lambda: cp.fine_res_plain(sc, cam, bound, imf.params, *pre, work=work))
    err_f = residual_agreement("march_only_fast K2 march-only vs fine_res_plain's (t, hit) at 1080p", (t_f, h_f),
                               (t_p.reshape(-1), h_p.reshape(-1)), strict=False)
    del t_p, h_p
    n_push = scene_cost(spec_s)[0]
    march_work = cp.WorkCount(points=float(work.points) - 4 * float(work.hits),
                              leaf_evals=float(work.leaf_evals) - 4 * float(work.hits) * n_push)
    bnd_f = roofline(march_flops(march_work, n_rays, spec_s, False), n_rays * 8 + 4 * n_px * 4)
    log(f"march_only_fast: {ms_f:.4f} ms/frame, {n_rays / (ms_f * 1e-3) / 1e9:.4f} Grays/s, launches fine_march "
        f"{launches_f}, coarse interval scan {coarse_launches}; hit rate {float(h_f.mean()):.4f}; march-only "
        f"build alone {fm_ms:.4f} ms, bound {bnd_f[0]:.4f} ms ({bnd_f[1]}), plain (fine_res_plain) {p_ms:.2f} ms "
        f"({smi})")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    out["march_only_fast"] = dict(ms=ms_f, kernel_ms=fm_ms, launches=launches_f, coarse=coarse_launches)
    record("fine_kernel (march only)", "raymarch_tpu_torch/csrc/fine_march.cu",
           "raymarch_tpu/ops/pallas_prepass.py:1827", launches_f, err_f, fm_ms, p_ms, bnd_f)
    del t_f, h_f

    # pallas_full: K7's pixel build (march.py:488-507: the AA mean inside
    # the kernel), static and dynamic tapes, held against its plain version
    # (image_render_plain, stacked and averaged) and against the no-prepass
    # fine kernel's image, both in the exact class: K7 and the fine kernel
    # start every ray at t = 0 and cap it at the bound's exit, so they march
    # the same samples. Then K7 per AA ray, as make_pallas_image_render
    # returns it, frame and kernel alone.
    rp0 = cp.make_pallas_image_render_aa(spec_s, cfg, WIDTH, HEIGHT, device=dev, no_prepass=True)
    img_np = rp0(arrays_s, cv)
    for tag, spec_m, arrays_m in (("static", spec_s, arrays_s), ("dynamic", spec_d, arrays_d)):
        render = rt.make_renderer(spec_m, WIDTH, HEIGHT, cfg, mode="forward", backend="pallas_full", device=dev)
        ms, launches, img = timed(lambda: render(arrays_m, camera), cm.image_pixels)
        image_max(f"pallas_full K7 pixel-build frame ({tag} tape) vs the no-prepass fine kernel's frame", img,
                  img_np)
        fm = render.renderer.flat
        sc, cam, bound = fm.scene_args(arrays_m, cv)
        k_ms = cuda_ms(lambda: cm.image_pixels(sc, cam, bound, fm.params), KERNEL_REPS)
        work = cp.WorkCount()
        img_p, p_ms = plain_ms(lambda: cm.image_pixels_plain(sc, cam, bound, fm.params, work=work))
        err = image_max(f"pallas_full K7 pixel build ({tag} tape) vs image_pixels_plain at 1080p", img, img_p)
        flops = march_flops(work, n_rays, spec_s, False, float(work.hits), fine=True)
        bnd = roofline(flops, n_px * 12)
        # K7 per AA ray through the reference's per-sample entry point.
        rgb_render = cm.make_pallas_image_render(spec_m, cfg, WIDTH, HEIGHT, device=dev)
        ms_s, launches_s, rgb = timed(lambda: rgb_render(arrays_m, cv), cm.image_render)
        err_s = image_max(f"K7 per AA ray ({tag} tape), its AA mean, vs image_pixels_plain at 1080p",
                          aa_mean(rgb, HEIGHT, WIDTH), img_p)
        del rgb, img_p
        ks_ms = cuda_ms(lambda: cm.image_render(sc, cam, bound, fm.params), KERNEL_REPS)
        bnd_s = roofline(flops, n_rays * 12)
        log(f"pallas_full ({tag} tape): frame {ms:.4f} ms, K7's pixel build alone {k_ms:.4f} ms, launches "
            f"{launches}, plain {p_ms:.2f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); K7 per AA ray: "
            f"make_pallas_image_render frame {ms_s:.4f} ms, alone {ks_ms:.4f} ms, launches {launches_s}, bound "
            f"{bnd_s[0]:.4f} ms ({bnd_s[1]}); stack route {cm.route_name(sc.route)} ({smi})")
        out[f"pallas_full_{tag}"] = dict(ms=ms, kernel_ms=k_ms, launches=launches, plain_ms=p_ms, bound=bnd,
                                         per_ray_frame_ms=ms_s, per_ray_ms=ks_ms, per_ray_launches=launches_s)
        suffix = "" if tag == "static" else ", dynamic tape"
        record("image_render_kernel (K7, pixel build)" + suffix, "raymarch_tpu_torch/csrc/march_pixel.cu",
               "raymarch_tpu/ops/pallas_march.py:1566", launches, err, k_ms, p_ms, bnd)
        record("image_render_kernel (K7, per AA ray)" + suffix, "raymarch_tpu_torch/csrc/march_render.cu",
               "raymarch_tpu/ops/pallas_march.py:1566", launches_s, err_s, ks_ms, p_ms, bnd_s)
    img_full = img
    # bound_accel is exact on the flat path: K6 with and without it gives
    # the same hit on every ray, the same t on hits (bit for bit: one build,
    # the same samples), the same steps on hits and no more elsewhere. Then
    # the rays whose hit differs between K6 and the no-prepass fine kernel
    # (both from t = 0), and the rays that spend K6's whole step budget.
    t6, h6, s6 = cm.make_pallas_image_march(spec_s, cfg, WIDTH, HEIGHT, device=dev)(arrays_s, cv)
    t6o, h6o, s6o = cm.make_pallas_image_march(spec_s, dataclasses.replace(cfg, bound_accel=False), WIDTH, HEIGHT,
                                               device=dev)(arrays_s, cv)
    hits6 = h6o > 0.5
    hit_eq = bool(torch.equal(h6, h6o))
    t_eq = bool(torch.equal(t6[hits6], t6o[hits6]))
    steps_ok = bool(torch.equal(s6[hits6], s6o[hits6])) and bool((s6 <= s6o).all())
    ok = hit_eq and t_eq and steps_ok
    log(f"gate K6 with bound_accel vs without at 1080p: hit equal={hit_eq} on {n_rays} rays, t equal on "
        f"{int(hits6.sum())} hit rays={t_eq}, steps equal on hits and no larger elsewhere={steps_ok}; steps a ray "
        f"{float(s6.float().mean()):.4f} against {float(s6o.float().mean()):.4f} (need equal, equal, true) "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        log(f"  {int((h6 != h6o).sum())} rays differ in hit, {int((s6 > s6o).sum())} take more steps")
        raise AssertionError("bound_accel changed K6's hits, t or steps")
    del t6, t6o, h6o, s6o, hits6
    _, _, h_np = cp.fine_res(*rp0.scene_args(arrays_s, cv), rp0.params)
    log(f"K6 vs the no-prepass fine kernel (both from t = 0): {int((h6 != h_np.reshape(-1)).sum())} of {n_rays} "
        f"rays differ in hit; {int((s6 >= cfg.max_iter).sum())} rays spend the step budget")
    del h_np, h6, s6

    # make_renderer(backend="pallas" / "jnp", mode="forward") frames.
    for backend in ("pallas", "jnp"):
        render = rt.make_renderer(spec_d, WIDTH, HEIGHT, cfg, mode="forward", backend=backend, device=dev)
        ms, launches, img = timed(lambda: render(arrays_d, camera), cm.ray_march, frames=3, warmup=1)
        image_class(f"make_renderer({backend}, forward) frame vs the pallas_full frame", img, img_full)
        log(f"make_renderer(backend={backend!r}, mode='forward') frame (dynamic tape): {ms:.4f} ms "
            f"(CUDA events, 3 frames after 1), K5 launches {launches} ({smi})")
        out[f"{backend}_forward"] = dict(ms=ms, launches=launches)
    del img, img_full, img_np

    # fwdbwd_jnp (bench.py:918-935): backend "pallas", implicit, chunk 1 << 20.
    render = rt.make_renderer(spec_s, WIDTH, HEIGHT, cfg, mode="implicit", backend="pallas", chunk=1 << 20, device=dev)
    lp0 = torch.tensor(arrays_s.leaf_params, device=dev)

    def fwd_bwd():
        lp = lp0.clone().requires_grad_(True)
        pos = torch.tensor(np.asarray(camera.position, np.float32), device=dev, requires_grad=True)
        rot = torch.tensor(np.asarray(camera.rotation, np.float32), device=dev, requires_grad=True)
        img = render(dataclasses.replace(arrays_s, leaf_params=lp), rt.Camera(pos, rot))
        torch.mean(img * img).backward()
        return lp.grad, pos.grad, rot.grad

    torch.cuda.reset_peak_memory_stats()
    ms_b, launches_b, g = timed(fwd_bwd, cm.ray_march, frames=MARCH_STEPS, warmup=MARCH_STEPS_WARMUP)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(bool(torch.isfinite(x).all()) for x in g) or float(g[0].abs().max()) <= 0:
        raise AssertionError("fwdbwd_jnp's gradients are not finite or all zero")
    log(f"fwdbwd_jnp: {ms_b:.4f} ms/step (CUDA events, {MARCH_STEPS} steps after {MARCH_STEPS_WARMUP}), "
        f"{n_rays / (ms_b * 1e-3) / 1e9:.4f} Grays/s, K5 launches {launches_b} ({-(-n_rays // (1 << 20))} chunks "
        f"a step), peak {peak:.2f} GiB; max|d_lp| {float(g[0].abs().max()):.4e} ({smi})")
    out["fwdbwd_jnp"] = dict(ms=ms_b, launches=launches_b, peak=peak)
    # K5 alone at the shape fwdbwd_jnp launches it: the frame's rays in
    # chunks of 2^20 (the last one shorter), every chunk timed, the mean a
    # launch; its plain version once over the frame, its time and the bound
    # per chunk (the frame's over the chunk count), so that launches x
    # (ms - bound) prices the row at its launches' shape.
    idx = torch.arange(n_rays, device=dev)
    o, d = rt.raygen_flat(idx, camera.position, camera.rotation, WIDTH, HEIGHT, cfg)
    o, d = o.contiguous(), d.contiguous()
    fm = cm.FlatMarch(spec_s, cfg, 1, 1, dev)
    sc, _, bound = fm.scene_args(arrays_s)
    chunk = 1 << 20
    spans = [(i, min(i + chunk, n_rays)) for i in range(0, n_rays, chunk)]

    def k5_frame():
        return [cm.ray_march(sc, bound, fm.params, o[i:j], d[i:j]) for i, j in spans]

    k5 = [torch.cat(v) for v in zip(*k5_frame())]
    k5_ms = cuda_ms(k5_frame, KERNEL_REPS) / len(spans)
    share, dev_ms = device_idle_share(k5_frame, KERNEL_REPS, k5_ms * len(spans))
    k5_dev = None if dev_ms is None else dev_ms / len(spans)
    work = cp.WorkCount()
    ref, p_ms = plain_ms(lambda: cm.ray_march_plain(sc, bound, fm.params, o, d, work=work))
    err5 = ray_agreement("K5 march_kernel in 2^20-ray chunks vs ray_march_plain on the 1080p frame's rays", k5, ref)
    del ref, k5, o, d
    bnd5 = roofline(march_flops(work, n_rays, spec_s, False) / len(spans), n_rays * (24 + 12) / len(spans))
    dev_txt = "not measured" if k5_dev is None else f"{k5_dev:.4f} ms a launch (idle share {share:.4f})"
    log(f"K5 alone on the 1080p frame's {n_rays} rays in {len(spans)} launches of 2^20: {k5_ms:.4f} ms a launch "
        f"(mean, CUDA events), device time {dev_txt} (torch.profiler), plain {p_ms / len(spans):.2f} ms a chunk "
        f"({p_ms:.2f} ms the frame), bound {bnd5[0]:.4f} ms a chunk ({bnd5[1]}) ({smi})")
    record("ray_march_kernel (K5, per 2^20-ray launch)", "raymarch_tpu_torch/csrc/march.cu",
           "raymarch_tpu/ops/pallas_march.py:1297", launches_b, err5, k5_ms, p_ms / len(spans), bnd5)
    records[-1]["device_ms"] = k5_dev
    out["k5_ms"] = k5_ms
    torch.cuda.synchronize()
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return records, out


# --- phase 15: live editing (DYN K1/K2, K4, the tiered runtime, the viewer) --
LIVE_W, LIVE_H = 960, 540  # the viewer's size on an accelerator (viewer.py:686)
LIVE_FRAMES = 10


def host_frames(fn, n=LIVE_FRAMES):
    """Mean host ms of `fn` over n calls (each returns a numpy frame, so
    each call waits for its frame)."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def live(rt, cp, cg, dev, smi, cfg, gcam_pos):
    """Phase 15: live editing (see the module docstring). Returns the kernel
    records of the DYN builds of K1/K2 and of K4, and the path's numbers."""
    import json
    import threading
    import urllib.request

    import numpy as np
    import torch

    from raymarch_tpu_torch import _build
    from raymarch_tpu_torch.runtime import TieredRenderer, to_numpy
    from raymarch_tpu_torch.viewer import ViewerApp, make_server

    t_phase = time.perf_counter()
    gcv = rt.cam_vec(rt.Camera.looking_at(position=gcam_pos, target=(0, 0, 0)), device=dev)
    gated = dataclasses.replace(cfg, leaf_cull=True)
    out, records = {}, []

    def record(name, source, replaces, launches, err, ms, p_ms, bound):
        records.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                            max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                            library_ms=None))

    # -- 15a. gates at 256x144 ------------------------------------------------
    # Every gate in the exact class (rel <= 1e-4 everywhere): the DYN builds
    # round each operation as the plain versions do (no FMA contraction),
    # so a centre ray whose slack lands within rounding of min_dist stops
    # where the plain version's does.
    gates = (
        ("config2", scene_config2, cfg, True),
        ("config2 gated", scene_config2, gated, True),
        ("config2 relax 1.6", scene_config2, dataclasses.replace(cfg, relax=1.6), True),
        ("empty", lambda m: None, cfg, True),
        ("rich gated relax 1.6", scene_rich, dataclasses.replace(cfg, leaf_cull=True, relax=1.6), True),
        ("16 painted spheres", lambda m: scene_painted(m, 16), cfg, True),
        ("16 painted spheres gated", lambda m: scene_painted(m, 16), gated, True),
    )
    for name, build, cfg_g, strict in gates:
        spec_d, arrays_d = rt.compile_scene(build(rt))
        rp = cp.make_pallas_image_render_aa(spec_d, cfg_g, GATE_W, GATE_H, device=dev)
        sc, cam, bound = rp.scene_args(arrays_d, gcv)
        cc, fc = rp.cull_args(sc, cam)
        pre_k = cp.coarse(sc, cam, bound, rp.params, cc)
        pre_p = cp.coarse_plain(sc, cam, bound, rp.params, cc)
        if build(rt) is None:  # no surface: every centre ray escapes
            if not (torch.equal(pre_k[1], pre_p[1]) and float(pre_k[1].max()) == 0.0):
                raise AssertionError("the empty dynamic scene's coarse planes differ from the plain version's")
            log("gate DYN coarse_kernel vs coarse_plain, empty: status all 0 in both PASS")
        else:
            coarse_agreement(f"gate DYN coarse_kernel vs coarse_plain, {name}", pre_k, pre_p, strict=strict)
        img_k = cp.fine(sc, cam, bound, rp.params, *pre_k, cull=fc)
        image_class(f"gate DYN fine_kernel vs fine_plain, {name}", img_k,
                    cp.fine_plain(sc, cam, bound, rp.params, *pre_k, cull=fc))
    spec_s, arrays_s = rt.compile_scene(scene_config2(rt), static=True)
    spec_d, arrays_d = rt.compile_scene(scene_config2(rt))
    # K4 (one lane per AA sample over the packed words, -fmad=false): the
    # image in the accelerated class and (t, hit) equal to the plain
    # version's on every ray (rel <= 1e-4 everywhere), at aa 1-6 with and
    # without shared normals (aa 1, 2, 4: a pixel within a warp, by ballot
    # and shuffles; 3, 5, 6 across warps, through shared memory), on both
    # tapes, every prepass form (PRE 1 pixel and B = 4 block planes, PRE 2,
    # PRE 4 in place), relax 1.6, the 16 painted spheres (materials, the
    # stacks in shared memory), culled frames whose blocks of 14 pixels
    # (aa 3) cross a 16-pixel list tile's edge, and aa 12 (two samples a
    # lane).
    wide = rt.cam_vec(rt.Camera.looking_at(position=SURFACE_WIDE_POS, target=(0, 0, 0)), device=dev)
    k4_gates = [
        ("shared normals, static", scene_config2, True, dict(aa_shared_normals=True), {}, gcv),
        ("shared normals, dynamic", scene_config2, False, dict(aa_shared_normals=True), {}, gcv),
        ("aa = 3, static", scene_config2, True, dict(aa_samples=3), {}, gcv),
        ("aa = 3, dynamic, gated", scene_config2, False, dict(aa_samples=3, leaf_cull=True), {}, gcv),
    ]
    for aa in range(1, 7):
        for sh in (False, True):
            static = (aa + sh) % 2 == 0
            k4_gates.append((f"aa {aa}{', shared' if sh else ''}, {'static' if static else 'dynamic'}", scene_config2,
                             static, dict(aa_samples=aa, aa_shared_normals=sh), {}, gcv))
    k4_gates += [
        ("aa 3, shared, 2 intervals (PRE 2), static", scene_config2, True,
         dict(aa_samples=3, aa_shared_normals=True), dict(n_intervals=2), gcv),
        ("aa 5, 5 intervals in place (PRE 4), B = 4, dynamic", scene_config2, False, dict(aa_samples=5),
         dict(n_intervals=5, prepass_block=4), gcv),
        ("aa 3, shared, B = 4 block planes, dynamic", scene_config2, False,
         dict(aa_samples=3, aa_shared_normals=True), dict(prepass_block=4), gcv),
        ("aa 3, shared, relax 1.6, dynamic", scene_config2, False,
         dict(aa_samples=3, aa_shared_normals=True, relax=1.6), {}, gcv),
        ("aa 6, relax 1.6, 2 intervals, static", scene_config2, True, dict(aa_samples=6, relax=1.6),
         dict(n_intervals=2), gcv),
        ("16 painted spheres, aa 3, shared, static (depth 8)", lambda m: scene_painted(m, 16), True,
         dict(aa_samples=3, aa_shared_normals=True), {}, wide),
        ("16 painted spheres, aa 4, dynamic", lambda m: scene_painted(m, 16), False, dict(aa_samples=4), {}, wide),
        ("64 spheres culled (item lists), aa 3, relax 1.6: blocks across tile edges", scene_spheres, True,
         dict(aa_samples=3, leaf_cull=True, relax=1.6), {}, wide),
        ("rich gated, aa 3, shared: blocks across tile edges", scene_rich, True,
         dict(aa_samples=3, aa_shared_normals=True, leaf_cull=True), {}, gcv),
        ("rich gated, aa 5, dynamic", scene_rich, False, dict(aa_samples=5, leaf_cull=True), {}, gcv),
        ("aa 12, shared, static: two samples a lane", scene_config2, True,
         dict(aa_samples=12, aa_shared_normals=True), {}, gcv),
    ]
    for name, build, static, cfg_kw, kw, cv_g in k4_gates:
        spec_g, arrays_g = rt.compile_scene(build(rt), static=static)
        cfg_g = dataclasses.replace(cfg, **cfg_kw)
        rp = cp.make_pallas_image_render_aa(spec_g, cfg_g, GATE_W, GATE_H, device=dev, aa_packed=False, **kw)
        if not rp.params.unpacked:
            raise AssertionError(f"K4 gate {name} did not take the unpacked fine pass")
        sc, cam, bound = rp.scene_args(arrays_g, cv_g)
        cc, fc = rp.cull_args(sc, cam)
        if cfg_g.leaf_cull and (fc is None or 16 % cfg_g.aa_samples == 0):
            raise AssertionError(f"K4 gate {name}: no culled frame whose blocks cross a tile's edge")
        pre = rp.prepass(sc, cam, bound, cc)
        img_k = cp.fine_unpacked(sc, cam, bound, rp.params, *pre, cull=fc)
        img_r, t_k, hit_k = cp.fine_unpacked_res(sc, cam, bound, rp.params, *pre, cull=fc)
        if not torch.equal(img_r, img_k):
            raise AssertionError("the residual output changed K4's image")
        img_p, t_p, hit_p = cp.fine_unpacked_plain(sc, cam, bound, rp.params, *pre, cull=fc)
        image_class(f"gate K4 fine_unpacked_kernel vs fine_unpacked_plain, {name}", img_k, img_p)
        residual_agreement(f"gate K4 residuals vs fine_unpacked_plain, {name}", (t_k, hit_k), (t_p, hit_p),
                           strict=True)
    cfg3 = dataclasses.replace(cfg, aa_samples=3)
    fr3 = cg.make_fused_render_vjp(spec_s, cfg3, GATE_W, GATE_H, device=dev)
    if fr3.backward_info["aa_packed"] or fr3.backward_info["kind"] != "pallas_legacy_unrolled":
        raise AssertionError(f"the aa = 3 VJP did not take the unpacked route: {fr3.backward_info}")
    sc, cam, bound = fr3.prepass.scene_args(arrays_s, gcv)
    _, t3, h3 = cp.fine_unpacked_res(sc, cam, bound, fr3.params, *fr3.prepass.prepass(sc, cam, bound, None))
    g_img = seeded_cotangent(GATE_H, GATE_W, dev, 11)
    grad_class("gate aa = 3: fused_bwd_kernel on K4's residuals vs bwd_plain",
               cg.bwd(sc, cam, fr3.params, fr3.layout, t3, h3, g_img),
               cg.bwd_plain(sc, cam, fr3.params, fr3.layout, t3, h3, g_img))
    img_dyn = cp.make_pallas_image_render_aa(spec_d, cfg, GATE_W, GATE_H, device=dev)(arrays_d, gcv)
    img_sta = cp.make_pallas_image_render_aa(spec_s, cfg, GATE_W, GATE_H, device=dev)(arrays_s, gcv)
    image_class("gate dynamic-tape frame vs static frame (bench.py's dynamic-tape class)", img_dyn, img_sta)
    torch.cuda.synchronize()
    log(f"phase 15 gates: {time.perf_counter() - t_phase:.1f} s")

    # -- 15b. 1920x1080, 16 AA rays per pixel ------------------------------------
    camera = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    cv = rt.cam_vec(camera, device=dev)
    n_px = WIDTH * HEIGHT
    n_rays = n_px * cfg.aa_samples ** 2
    rp_s = cp.make_pallas_image_render_aa(spec_s, cfg, WIDTH, HEIGHT, device=dev, prepass_block=1, aa_packed=True)
    rp_d = cp.make_pallas_image_render_aa(spec_d, cfg, WIDTH, HEIGHT, device=dev, prepass_block=1, aa_packed=True)

    def frames(fn, n=FRAMES, warmup=WARMUP):
        """(ms by CUDA events, host ms) over n runs after `warmup`; the
        launch counts are set to 0 just before the run."""
        cp.reset_launch_counts()
        cg.reset_launch_counts()
        for _ in range(warmup):
            r = fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        for _ in range(n):
            r = fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n, (time.perf_counter() - h0) * 1e3 / n, r

    # dynamic_tape_prepass (bench.py:640-655) against the static headline, S D D S.
    ms_s1, _, img_s = frames(lambda: rp_s(arrays_s, cv))
    ms_d1, host_d1, img_d = frames(lambda: rp_d(arrays_d, cv))
    dyn_launches = {"coarse_kernel (DYN)": cp.coarse.dyn_launches, "fine_kernel (DYN)": cp.fine.dyn_launches}
    ms_d2, host_d2, _ = frames(lambda: rp_d(arrays_d, cv))
    ms_s2, _, _ = frames(lambda: rp_s(arrays_s, cv))
    log(f"dynamic_tape_prepass {WIDTH}x{HEIGHT} x16 AA: {ms_d1:.4f} / {ms_d2:.4f} ms/frame (CUDA events, {FRAMES} "
        f"after {WARMUP}; host {host_d1:.4f} / {host_d2:.4f} ms), {n_rays / (ms_d1 * 1e-3) / 1e9:.4f} Grays/s; "
        f"static headline {ms_s1:.4f} / {ms_s2:.4f} ms (S D D S); launches in the dynamic run {dyn_launches} ({smi})")
    if min(dyn_launches.values()) <= 0:
        raise AssertionError(f"a DYN kernel of the dynamic-tape frame never launched: {dyn_launches}")
    image_class("dynamic_tape_prepass frame vs the static headline frame", img_d, img_s)
    sc, cam, bound = rp_d.scene_args(arrays_d, cv)
    sc_s, _, bound_s = rp_s.scene_args(arrays_s, cv)
    pre_d = cp.coarse(sc, cam, bound, rp_d.params)
    pre_s = cp.coarse(sc_s, cam, bound_s, rp_s.params)
    k_ms = {
        "coarse DYN": cuda_ms(lambda: cp.coarse(sc, cam, bound, rp_d.params), KERNEL_REPS),
        "coarse static": cuda_ms(lambda: cp.coarse(sc_s, cam, bound_s, rp_s.params), KERNEL_REPS),
        "fine DYN": cuda_ms(lambda: cp.fine(sc, cam, bound, rp_d.params, *pre_d), KERNEL_REPS),
        "fine static": cuda_ms(lambda: cp.fine(sc_s, cam, bound_s, rp_s.params, *pre_s), KERNEL_REPS),
    }
    work_c = cp.WorkCount()
    pre_p, c_plain_ms = plain_ms(lambda: cp.coarse_plain(sc, cam, bound, rp_d.params, work=work_c))
    c_err = coarse_agreement("full-size DYN coarse_kernel vs coarse_plain", pre_d, pre_p, strict=False)
    del pre_p
    work_f = cp.WorkCount()
    img_p, f_plain_ms = plain_ms(lambda: cp.fine_plain(sc, cam, bound, rp_d.params, *pre_d, work=work_f))
    f_err = image_class("full-size DYN fine_kernel vs fine_plain (same planes)",
                        cp.fine(sc, cam, bound, rp_d.params, *pre_d), img_p)
    del img_p
    c_bound = roofline(march_flops(work_c, n_px, spec_s, False), n_px * 8)
    f_bound = roofline(march_flops(work_f, n_rays, spec_s, False, float(work_f.hits), fine=True), n_px * 20)
    log(f"DYN kernels alone: coarse {k_ms['coarse DYN']:.4f} ms (static {k_ms['coarse static']:.4f}), fine "
        f"{k_ms['fine DYN']:.4f} ms (static {k_ms['fine static']:.4f}); bounds coarse {c_bound[0]:.4f} ms "
        f"({c_bound[1]}), fine {f_bound[0]:.4f} ms ({f_bound[1]}); plain coarse {c_plain_ms:.2f} ms, fine "
        f"{f_plain_ms:.2f} ms ({smi})")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    record("coarse_kernel (DYN)", "raymarch_tpu_torch/csrc/prepass_dyn.cu", "raymarch_tpu/ops/pallas_prepass.py:885",
           dyn_launches["coarse_kernel (DYN)"], c_err, k_ms["coarse DYN"], c_plain_ms, c_bound)
    record("fine_kernel (DYN)", "raymarch_tpu_torch/csrc/prepass_dyn.cu", "raymarch_tpu/ops/pallas_prepass.py:1521",
           dyn_launches["fine_kernel (DYN)"], f_err, k_ms["fine DYN"], f_plain_ms, f_bound)
    out["dynamic"] = dict(ms=(ms_d1, ms_d2), static_ms=(ms_s1, ms_s2), kernels=k_ms, launches=dyn_launches)

    # The aa_shared_normals frame: K4 through make_renderer (aa_packed=False).
    cfg_sh = dataclasses.replace(cfg, aa_shared_normals=True)
    render_sh = rt.make_renderer(spec_s, WIDTH, HEIGHT, cfg_sh, mode="forward", backend="pallas_prepass", device=dev)
    ms_sh, host_sh, img_sh = frames(lambda: render_sh(arrays_s, camera))
    k4_launches = cp.fine_unpacked.launches
    if k4_launches <= 0 or cp.coarse.launches <= 0:
        raise AssertionError("the shared-normals frame did not run K1 and K4")
    rp_sh = render_sh.renderer
    p_sh = rp_sh.params
    pre = cp.coarse(sc_s, cam, bound_s, p_sh)
    k4_ms = cuda_ms(lambda: cp.fine_unpacked(sc_s, cam, bound_s, p_sh, *pre), KERNEL_REPS)
    work_4 = cp.WorkCount()
    img_p, k4_plain_ms = plain_ms(lambda: cp.fine_unpacked_plain(sc_s, cam, bound_s, p_sh, *pre, work=work_4)[0])
    k4_err = image_class("full-size K4 (shared normals) vs fine_unpacked_plain", cp.fine_unpacked(
        sc_s, cam, bound_s, p_sh, *pre), img_p)
    del img_p
    d_sh = (img_sh - img_s).abs()
    k4_bound = roofline(march_flops(work_4, n_rays, spec_s, False, float(work_4.hits), fine=True), n_px * 20)
    log(f"aa_shared_normals frame: {ms_sh:.4f} ms (host {host_sh:.4f} ms), K4 launches {k4_launches}; K4 alone "
        f"{k4_ms:.4f} ms, bound {k4_bound[0]:.4f} ms ({k4_bound[1]}), plain {k4_plain_ms:.2f} ms; against the "
        f"per-sample-normal frame mean|d| {float(d_sh.mean()):.3e}, share of pixels > 0.05 "
        f"{float((d_sh.amax(-1) > 0.05).float().mean()):.5f} ({smi})")
    record("fine_unpacked_kernel (K4, shared normals)", "raymarch_tpu_torch/csrc/fine_unpacked.cu",
           "raymarch_tpu/ops/pallas_prepass.py:1010", k4_launches, k4_err, k4_ms, k4_plain_ms, k4_bound)
    out["shared"] = dict(ms=ms_sh, k4_ms=k4_ms, launches=k4_launches)
    del img_sh, d_sh

    # One aa = 3 fwd+bwd step: K1, K4 with residuals, K8.
    render3 = rt.make_renderer(spec_s, WIDTH, HEIGHT, cfg3, mode="implicit", backend="pallas_fused", device=dev)
    lp0 = torch.tensor(arrays_s.leaf_params, device=dev)
    op0 = torch.tensor(arrays_s.op_param, device=dev)

    def step3():
        lp = lp0.clone().requires_grad_(True)
        opp = op0.clone().requires_grad_(True)
        c = cv.clone().requires_grad_(True)
        img3 = render3.renderer(dataclasses.replace(arrays_s, leaf_params=lp, op_param=opp), c)
        torch.mean(img3 * img3).backward()
        return lp.grad, opp.grad, c.grad

    ms3, host3, g3 = frames(step3, n=BWD_STEPS, warmup=BWD_WARMUP)
    launches3 = {"coarse_kernel": cp.coarse.launches, "fine_unpacked_kernel (residuals)": cp.fine_unpacked_res.launches,
                 "fused_bwd_kernel": cg.bwd.launches}
    if min(launches3.values()) <= 0:
        raise AssertionError(f"a kernel of the aa = 3 step never launched: {launches3}")
    n_rays3 = n_px * 9
    p3 = render3.renderer.params
    pre3 = cp.coarse(sc_s, cam, bound_s, p3)
    k4r_ms = cuda_ms(lambda: cp.fine_unpacked_res(sc_s, cam, bound_s, p3, *pre3), KERNEL_REPS)
    img_k3, t_k3, h_k3 = cp.fine_unpacked_res(sc_s, cam, bound_s, p3, *pre3)
    work_3 = cp.WorkCount()
    (img_p3, t_p3, h_p3), k4r_plain_ms = plain_ms(lambda: cp.fine_unpacked_plain(sc_s, cam, bound_s, p3, *pre3,
                                                                                  work=work_3))
    k4r_err = image_class("full-size K4 with residuals (aa = 3) vs fine_unpacked_plain", img_k3, img_p3)
    residual_agreement("full-size K4 residuals (aa = 3) vs fine_unpacked_plain", (t_k3, h_k3), (t_p3, h_p3),
                       strict=True)
    del img_p3, t_p3, h_p3
    ref3 = cg.bwd_plain(sc_s, cam, p3, render3.renderer.layout, t_k3, h_k3, 2.0 * img_k3 / img_k3.numel())
    grad_class("aa = 3 step's gradients vs bwd_plain on K4's residuals", g3, ref3)
    k4r_bound = roofline(march_flops(work_3, n_rays3, spec_s, False, float(work_3.hits), fine=True),
                         n_px * 20 + n_rays3 * 8)
    log(f"aa = 3 fwd+bwd step {WIDTH}x{HEIGHT}: {ms3:.4f} ms/step (CUDA events, {BWD_STEPS} after {BWD_WARMUP}; "
        f"host {host3:.4f} ms), launches {launches3}, backward {render3.backward_info}; K4 with residuals alone "
        f"{k4r_ms:.4f} ms, bound {k4r_bound[0]:.4f} ms ({k4r_bound[1]}), plain {k4r_plain_ms:.2f} ms ({smi})")
    record("fine_unpacked_kernel (K4, residuals t, hit, aa = 3)", "raymarch_tpu_torch/csrc/fine_unpacked.cu",
           "raymarch_tpu/ops/pallas_prepass.py:1010", launches3["fine_unpacked_kernel (residuals)"], k4r_err,
           k4r_ms, k4r_plain_ms, k4r_bound)
    out["aa3_step"] = dict(ms=ms3, k4_ms=k4r_ms, launches=launches3)
    del img_k3, t_k3, h_k3, ref3, g3
    torch.cuda.synchronize()

    # -- 15c. TieredRenderer at the viewer's size ------------------------------
    scene0 = scene_config2(rt)
    scene1 = scene0 | rt.sphere(center=(0.0, 1.4, 0.0), radius=0.3)  # a topology edit in the bucket
    tiered = TieredRenderer(LIVE_W, LIVE_H, cfg, backend="pallas_prepass", device=dev)  # the card's default
    tiered.render(scene0, camera)
    if not tiered.wait(timeout=300.0):
        raise AssertionError("the first static tier never arrived")
    tiered.render(scene0, camera)
    cp.reset_launch_counts()
    t0 = time.perf_counter()
    img1 = tiered.render(scene1, camera)
    first_ms = (time.perf_counter() - t0) * 1e3
    tier1 = tiered.tier
    t1 = time.perf_counter()
    if not tiered.wait(timeout=300.0):
        raise AssertionError("the static tier of the edit never arrived")
    static_s = time.perf_counter() - t1
    tier_launches = {"coarse_kernel (DYN)": cp.coarse.dyn_launches, "fine_kernel (DYN)": cp.fine.dyn_launches,
                     "coarse_kernel": cp.coarse.launches, "fine_kernel": cp.fine.launches}
    if tier1 != "dynamic" or min(tier_launches.values()) <= 0:
        raise AssertionError(f"the edit's first frame was not the dynamic tier's ({tier1}) or a kernel of the "
                             f"tiers never launched: {tier_launches}")
    spec_d1, arrays_d1 = rt.compile_scene(scene1)
    spec_s1, arrays_s1 = rt.compile_scene(scene1, static=True)
    dyn_rnd, sta_rnd = tiered._dynamic[spec_d1], tiered._static[spec_s1]
    # Each tier's renderer alone, then render() as the viewer calls it
    # (compile_scene of the scene, the static tier's frame, the copy out).
    dyn_ms = host_frames(lambda: to_numpy(dyn_rnd(arrays_d1, camera)))
    sta_ms = host_frames(lambda: to_numpy(sta_rnd(arrays_s1, camera)))
    render_ms = host_frames(lambda: tiered.render(scene1, camera))
    if tiered.tier != "static":
        raise AssertionError("the static tier does not serve the edited scene")
    img1s = tiered.render(scene1, camera)
    d1 = np.abs(img1 - img1s)
    # A numeric edit: no new renderer, no nvcc build.
    builds, compiles, n_dyn = _build.stats["builds"], tiered.static_compiles, len(tiered._dynamic)
    moved = scene_config2(rt).translate((0.2, 0.0, 0.0)) | rt.sphere(center=(0.0, 1.5, 0.0), radius=0.35)
    img_m = tiered.render(moved, camera)
    numeric_ok = (tiered.tier == "static" and tiered.static_compiles == compiles and len(tiered._dynamic) == n_dyn
                  and _build.stats["builds"] == builds and float(np.abs(img_m - img1s).max()) > 0.05)
    # A topology edit within the bucket: the same dynamic renderer.
    scene2 = scene0 | rt.box(center=(0.0, 1.4, 0.0), half_extents=(0.3, 0.3, 0.3))
    img2 = tiered.render(scene2, camera)
    same_dyn = (tiered.tier == "dynamic" and tiered._dynamic.get(rt.compile_scene(scene2)[0]) is dyn_rnd
                and len(tiered._dynamic) == n_dyn and _build.stats["builds"] == builds)
    tiered.wait(timeout=300.0)
    log(f"TieredRenderer {LIVE_W}x{LIVE_H} x16 AA (background): topology edit -> first frame {first_ms:.2f} ms "
        f"(tier {tier1}); static tier ready {static_s:.3f} s after that frame; steady frames (host clock, numpy "
        f"out): dynamic tier {dyn_ms:.2f} ms, static tier {sta_ms:.2f} ms, render() {render_ms:.2f} ms; tier switch "
        f"max|d| {float(d1.max()):.3e} mean "
        f"{float(d1.mean()):.3e}; launches in the edit's run {tier_launches}; numeric edit: no new renderer, no "
        f"build {numeric_ok}; topology edit in the bucket: same dynamic renderer {same_dyn}; stats "
        f"{tiered.stats()} ({smi})")
    if not (numeric_ok and same_dyn and float(d1.mean()) < 5e-4 and float(np.abs(img2 - img1s).max()) > 0.05):
        raise AssertionError("the tiered runtime rebuilt on an edit, or its tiers disagree")
    out["tiered"] = dict(first_ms=first_ms, static_s=static_s, dyn_ms=dyn_ms, static_ms=sta_ms, render_ms=render_ms)

    # -- 15d. ViewerApp through its HTTP server on localhost ----------------------
    app = ViewerApp(width=LIVE_W, height=LIVE_H, cfg=cfg, backend="pallas_prepass", device=dev)
    srv = make_server(app, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        urllib.request.urlopen(url + "/frame.png").read()  # builds the dynamic tier
        app._tiered.wait(timeout=300.0)

        def edit(op):
            req = urllib.request.Request(url + "/edit", data=json.dumps(op).encode())
            return json.loads(urllib.request.urlopen(req).read())

        t0 = time.perf_counter()
        nid = edit({"op": "add", "template": "Sphere"})["id"]
        edit_ms = (time.perf_counter() - t0) * 1e3
        edit({"op": "set_input", "id": nid, "name": "center", "value": [0.0, 1.5, 0.0]})
        edit({"op": "set_input", "id": nid, "name": "radius", "value": 0.35})
        g = json.loads(urllib.request.urlopen(url + "/graph").read())
        root = next(n for n in g["nodes"] if n["template"] == "Root")
        u = edit({"op": "add", "template": "Union"})["id"]
        edit({"op": "connect", "src": root["inputs"]["SDF"]["$node"], "dst": u, "input": "A"})
        edit({"op": "connect", "src": nid, "dst": u, "input": "B"})
        edit({"op": "connect", "src": u, "dst": root["id"], "input": "SDF"})
        t0 = time.perf_counter()
        png = urllib.request.urlopen(url + "/frame.png").read()
        png_ms = (time.perf_counter() - t0) * 1e3
        state = json.loads(urllib.request.urlopen(url + "/state").read())
        app._tiered.wait(timeout=300.0)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60.0)
    import struct

    w_png, h_png = struct.unpack(">II", png[16:24])
    log(f"ViewerApp on the card through make_server (localhost): /edit adding a node {edit_ms:.2f} ms; frame.png "
        f"after the node is wired in {png_ms:.2f} ms ({len(png)} bytes, {w_png}x{h_png}, tier {state['tier']}); "
        f"state {state['tiered']} ({smi})")
    if (w_png, h_png) != (LIVE_W, LIVE_H) or state["tier"] != "dynamic" or state["device"] != str(dev):
        raise AssertionError(f"the viewer's frame or state is wrong: {w_png}x{h_png}, {state}")
    out["viewer"] = dict(edit_ms=edit_ms, png_ms=png_ms)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['seconds']:.1f} s")
    return records, out


# --- phase 16: the repaired render options, the scenes past the shared row ----
CAM_AXIS_POS = (0.0, 0.0, 8.0)  # looks down the axis of scene_tori
BIG_POOL = 4096  # K9's largest gate: a gradient row of 16 x 4,096 + 8,198 words
BIG_TAPE = 3600  # K8's: 7,199 instructions, 61,206 words
# The gate frames of those two. Their plain versions' time grows with the
# number of row bands far more than with the rays in a band (each band
# replays the whole tape through autograd): at 96x54 in bands of 16 rows and
# 64x36 in bands of 4 they took 80-101 and 140-192 s on an H100's host. So
# the gates run bands of 32 and 8 rows: half the bands, and no more rays in
# a band than 256x144 and 128x72 frames held in bands of 16 and 4.
BIG_GATE_POOL = (96, 54)
BIG_GATE_TAPE = (64, 36)


def big_gate_cover(cg, spec, cull, fc, lay, hit, dev) -> str:
    """What a gate of a gradient row in device memory covers: the blocks
    that add into the row (as many as the card keeps resident, at most one
    per `threads` AA rays) and the work they share (K9: the fine tiles, which
    its blocks pull one at a time; K8: the AA rays), and the hit rays."""
    import torch

    rows, width, _ = hit.shape
    n_rays, n_hit = hit.numel(), int(hit.sum())
    if cull:
        max_blocks, threads = cg.compact_layout(spec, dev)[1], cg.CBWD_THREADS
        tid = fc.tile_index(torch.arange(rows, device=dev)[:, None], torch.arange(width, device=dev)[None, :])
        work = (f"pull {int(torch.unique(tid).numel())} fine tiles, "
                f"{int(torch.unique(tid[hit.amax(-1) > 0]).numel())} of them with a hit ray")
    else:
        max_blocks, threads = cg._device_consts(lay, spec.has_materials, dev)[1], lay.threads
        work = f"over {n_rays} AA rays"
    return f"{min(max_blocks, -(-n_rays // threads))} blocks of {threads} threads {work}; {n_hit} hit rays"


def scene_tori(m, n=7):
    """n thin tori on the view axis from CAM_AXIS_POS, their axes along it
    (tests/test_torch_interval.py's layered scene): a 4 x 4 block's centre
    ray threads them all and its cone comes near each, up to 7 near
    intervals per block."""
    return functools.reduce(lambda a, b: a | b, [
        m.torus(center=(0.0, 0.0, 4.0 - 1.5 * k), major_radius=0.3, minor_radius=0.1,
                rotation=(0.7071068, 0.7071068, 0.0, 0.0)) for k in range(n)])


def repairs(rt, cp, cg, dev, smi, cfg):
    """Phase 16: the render options that now take a dynamic tape (K3's DYN
    build, K2's DYN march-only and soft builds), any n_intervals (the coarse
    scan and the fine passes that keep the intervals in the planes), and the
    scenes whose gradient row exceeds a block's shared memory (K9 on a
    4,096-sphere pool, K8 on a 3,600-leaf tape): gates against the plain
    versions at 256x144 (those two at 96x54 and 64x36), then 1080p frames with
    launches, the kernels alone, plain and bound. Returns the kernel records
    and the numbers the summary prints."""
    import torch

    records, out = [], {}
    t_phase = time.perf_counter()
    cfg_ir = dataclasses.replace(cfg, relax=1.6)
    gcv = rt.cam_vec(rt.Camera.looking_at(position=(0.0, 2.6, 4.2), target=(0.0, 0.0, 0.0)), device=dev)
    scv = rt.cam_vec(rt.Camera.looking_at(position=SOFT_GATE_POS, target=(0.0, 0.0, 0.0)), device=dev)
    hcv = rt.cam_vec(rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0)), device=dev)
    acv = rt.cam_vec(rt.Camera.looking_at(position=CAM_AXIS_POS, target=(0.0, 0.0, 0.0)), device=dev)
    spec_d, arrays_d = rt.compile_scene(scene_config2(rt))
    # The dynamic tape's real instructions are the static tape's: the bounds
    # count their operations from it.
    spec_cost = rt.compile_scene(scene_config2(rt), static=True)[0]
    spec_t, arrays_t = rt.compile_scene(scene_tori(rt), static=True)
    spec_td, arrays_td = rt.compile_scene(scene_tori(rt))
    if spec_d.static_tape is not None or spec_td.static_tape is not None:
        raise AssertionError("compile_scene's default is not a dynamic tape")

    # -- 16a. gates at 256x144 -------------------------------------------------
    rp = cp.make_pallas_image_render_aa(spec_d, cfg, GATE_W, GATE_H, device=dev, prepass_block=4,
                                        prepass_chain=True)
    sc, cam, bnd = rp.scene_args(arrays_d, gcv)
    blk = cp.coarse(sc, cam, bnd, rp.params)
    px = cp.coarse_px(sc, cam, bnd, rp.params, *blk)
    coarse_agreement("gate DYN coarse_px_kernel (K3) vs coarse_px_plain, config 2 dynamic, B=4", px,
                     cp.coarse_px_plain(sc, cam, bnd, rp.params, *blk), strict=True, exact=True)
    image_class("gate DYN chained frame vs its plain path", rp(arrays_d, gcv), rp.render_plain(arrays_d, gcv))
    for kw, cfg_m in ((dict(prepass_block=4), cfg), (dict(prepass_block=1, n_intervals=2), cfg_ir)):
        mo = cp.make_pallas_image_march_fast(spec_d, cfg_m, GATE_W, GATE_H, device=dev, **kw)
        sc, cam, bnd = mo.scene_args(arrays_d, gcv)
        pre = mo.prepass(sc, cam, bnd, None)
        got = cp.fine_march(sc, cam, bnd, mo.params, *pre)
        _, t_r, h_r = cp.fine_res(sc, cam, bnd, mo.params, *pre)
        same = bool(torch.equal(got[0], t_r.reshape(-1)) and torch.equal(got[1], h_r.reshape(-1)))
        log(f"gate DYN march-only build vs the DYN fine kernel with residuals, {kw}, relax {cfg_m.relax}: (t, hit) "
            f"equal bit for bit {same} {'PASS' if same else 'FAIL'}")
        if not same:
            raise AssertionError("the DYN march-only build's (t, hit) differ from the DYN fine kernel's")
        # The plain version in the exact class: the DYN builds round each
        # operation as it does (no FMA contraction), so no relaxed ray ends
        # a step apart.
        _, t_p, h_p = cp.fine_res_plain(sc, cam, bnd, mo.params, *pre)
        residual_agreement(f"gate DYN K2 march-only vs fine_res_plain's (t, hit), {kw}, relax {cfg_m.relax}", got,
                           (t_p.reshape(-1), h_p.reshape(-1)), strict=True)
    for cfg_s, how in ((cfg, "un-culled"), (dataclasses.replace(cfg, leaf_cull=True), "gated")):
        rs = cp.make_pallas_image_render_aa(spec_d, cfg_s, GATE_W, GATE_H, device=dev, no_prepass=True, soft=True)
        sc, cam, bnd = rs.scene_args(arrays_d, scv)
        _, fc = rs.cull_args(sc, cam)
        img_k, *res_k = cp.fine_res(sc, cam, bnd, rs.params, cull=fc)
        img_p, *res_p = cp.fine_res_plain(sc, cam, bnd, rs.params, cull=fc)
        image_max(f"gate DYN soft fine kernel vs fine_res_plain, config 2 dynamic, {how}", img_k, img_p)
        soft_residual_agreement(f"gate DYN soft residuals, {how}", cp, rs.params, res_k, res_p)
    # More than MAX_NI near intervals: K1's scan and K2's march in place
    # (static and DYN, relaxed), K2's march-only build, K4 at aa = 3.
    for spec_w, arrays_w, cfg_w, ni, how in ((spec_t, arrays_t, cfg, 6, "static"),
                                             (spec_td, arrays_td, cfg_ir, 6, "dynamic, relax 1.6"),
                                             (spec_t, arrays_t, dataclasses.replace(cfg, aa_samples=3), 5,
                                              "static, aa 3 (K4)")):
        rw = cp.make_pallas_image_render_aa(spec_w, cfg_w, GATE_W, GATE_H, device=dev, prepass_block=4,
                                            n_intervals=ni)
        sc, cam, bnd = rw.scene_args(arrays_w, acv)
        pre = cp.coarse(sc, cam, bnd, rw.params)
        interval_agreement(f"gate coarse kernel, {ni} intervals in place, tori ({how}) vs coarse_plain", pre,
                           cp.coarse_plain(sc, cam, bnd, rw.params))
        n_open = int(sum((v < 9e37).int() for v in pre[:ni]).max())
        log(f"  the most intervals a block keeps: {n_open} (more than MAX_NI = {cp.MAX_NI}: {n_open > cp.MAX_NI})")
        if n_open <= cp.MAX_NI:
            raise AssertionError("the tori gate keeps no more than MAX_NI intervals in any block")
        if rw.params.unpacked:
            image_class(f"gate K4 through {ni} intervals in place ({how}) vs fine_unpacked_plain",
                        cp.fine_unpacked(sc, cam, bnd, rw.params, *pre),
                        cp.fine_unpacked_plain(sc, cam, bnd, rw.params, *pre)[0])
            continue
        image_class(f"gate fine kernel through {ni} intervals in place ({how}) vs fine_plain",
                    cp.fine(sc, cam, bnd, rw.params, *pre), cp.fine_plain(sc, cam, bnd, rw.params, *pre))
        got = cp.fine_march(sc, cam, bnd, rw.params, *pre)
        _, t_r, h_r = cp.fine_res(sc, cam, bnd, rw.params, *pre)
        if not (torch.equal(got[0], t_r.reshape(-1)) and torch.equal(got[1], h_r.reshape(-1))):
            raise AssertionError(f"the march-only build through {ni} intervals differs from the fine kernel's")
        log(f"gate march-only build through {ni} intervals ({how}): (t, hit) equal to the fine kernel's PASS")

    # The scenes past the shared row: a training step each through
    # make_renderer (launch counts), the kernel alone, against its plain
    # version, and its bound.
    big = (
        ("compact_bwd_kernel", f"{BIG_POOL}-sphere pool", BIG_POOL, True, BIG_GATE_POOL, 32),
        ("fused_bwd_kernel", f"{BIG_TAPE}-leaf tape", BIG_TAPE, False, BIG_GATE_TAPE, 8),
    )
    for kname, what, n, cull, (gw, gh), band in big:
        cfg_b = dataclasses.replace(cfg, relax=1.6, leaf_cull=cull)
        spec_b, arrays_b = rt.compile_scene(scene_balanced(rt, n, 5, 12.0, 2.5), static=True)
        camera = rt.Camera.looking_at(position=(0.0, 6.0, 30.0), target=(0.0, 0.0, 0.0))
        render = rt.make_renderer(spec_b, gw, gh, cfg_b, mode="implicit", backend="pallas_fused", device=dev)
        fr = render.renderer
        nscal = 16 * n + spec_b.n_instr + 7
        if fr.compact_bwd != cull or nscal * 4 <= cg.SMEM_PER_BLOCK:
            raise AssertionError(f"the {what} routes to {fr.backward_info}, {nscal} words")
        lp = torch.tensor(arrays_b.leaf_params, device=dev, requires_grad=True)
        cp.reset_launch_counts()
        cg.reset_launch_counts()
        torch.mean(render(dataclasses.replace(arrays_b, leaf_params=lp), camera) ** 2).backward()
        launches = (cg.compact_bwd if cull else cg.bwd).launches
        if launches != 1 or not bool(torch.isfinite(lp.grad).all()) or float(lp.grad.abs().max()) <= 0:
            raise AssertionError(f"the {what}'s training step: {launches} launches, gradient not finite or zero")
        rp, p = fr.prepass, fr.params
        cv = rt.cam_vec(camera, device=dev)
        sc, cam, bnd = rp.scene_args(arrays_b, cv)
        cc, fc = rp.cull_args(sc, cam)
        img, t, hit = cp.fine_res(sc, cam, bnd, p, *rp.prepass(sc, cam, bnd, cc), cull=fc)
        g = 2.0 * img / img.numel()
        clamp = fr.layout.grad_denom_clamp
        if cull:
            fn = lambda: cg.compact_bwd(sc, fc, cam, p, clamp, t, hit, g)  # noqa: E731
            plain = lambda: cg.compact_bwd_plain(sc, fc, cam, p, clamp, t, hit, g, band_rows=band)  # noqa: E731
            routes = cg.CompactRoutes.of(spec_b)
            where = f"row in shared memory {routes.row_smem}, lists staged {routes.stage}"
        else:
            lay = fr.layout
            fn = lambda: cg.bwd(sc, cam, p, lay, t, hit, g)  # noqa: E731
            plain = lambda: cg.bwd_plain(sc, cam, p, lay, t, hit, g, band_rows=band)  # noqa: E731
            where = f"warp rows {lay.long}, row in shared memory {lay.row_in_smem}, records in shared memory " \
                    f"{lay.rec_in_smem(False)}"
        k_ms = cuda_ms(fn, 3)
        ref, p_ms = plain_ms(plain)
        err = grad_class(f"gate {kname} on the {what} ({nscal} gradient words; {where}) vs its plain version at "
                         f"{gw}x{gh}", fn(), ref)
        log(f"  {kname} gate on the {what} covers: "
            f"{big_gate_cover(cg, spec_b, cull, fc, fr.layout, hit, dev)}")
        n_rays = gw * gh * cfg.aa_samples ** 2
        bound = (k9_bound(sc, fc, p, cam, t, hit, n_rays) if cull
                 else k8_bound(sc, p, cam, t, hit, fr.layout, n_rays))
        log(f"{kname} on the {what} at {gw}x{gh}: {k_ms:.4f} ms alone, plain {p_ms:.2f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}), hit fraction {float(hit.mean()):.4f} ({smi})")
        records.append(dict(
            name=f"{kname} ({what}, {gw}x{gh}: the row in device memory)", route="cuda",
            source=f"raymarch_tpu_torch/csrc/{'compact_bwd' if cull else 'fused_bwd'}.cu",
            replaces="raymarch_tpu/ops/pallas_grad.py:" + ("256" if cull else "1432"), launches=launches,
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=None))
        out[kname] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound[0])
        del ref, img, t, hit, g, lp
        torch.cuda.empty_cache()

    # -- 16b. 1080p frames -----------------------------------------------------
    n_px, n_rays = WIDTH * HEIGHT, WIDTH * HEIGHT * cfg.aa_samples ** 2

    def dyn_counts():
        return {"coarse_kernel (DYN)": cp.coarse.dyn_launches, "coarse_px_kernel (DYN)": cp.coarse_px.dyn_launches,
                "fine_kernel (DYN)": cp.fine.dyn_launches, "fine_kernel (march only, DYN)": cp.fine_march.dyn_launches,
                "fine_kernel (soft, DYN)": cp.fine.dyn_soft_launches,
                "coarse_kernel (intervals in place)": cp.coarse.wide_launches,
                "fine_kernel (intervals in place)": cp.fine.wide_launches}

    def frames(fn):
        cp.reset_launch_counts()
        ms, host_ms, _ = timed_frames(cp, fn)
        return ms, host_ms, dyn_counts()

    # The chained dynamic frame (config 2, B = 4): K1 and K3 DYN, K2 DYN.
    rp = cp.make_pallas_image_render_aa(spec_d, cfg, WIDTH, HEIGHT, device=dev, prepass_block=4, prepass_chain=True)
    ms, host_ms, launches = frames(lambda: rp(arrays_d, hcv))
    sc, cam, bnd = rp.scene_args(arrays_d, hcv)
    blk = cp.coarse(sc, cam, bnd, rp.params)
    k3_ms = cuda_ms(lambda: cp.coarse_px(sc, cam, bnd, rp.params, *blk), KERNEL_REPS)
    k3_dev = kernel_device_ms(lambda: cp.coarse_px(sc, cam, bnd, rp.params, *blk), "coarse_px_kernel")
    work = cp.WorkCount()
    px_p, k3_plain_ms = plain_ms(lambda: cp.coarse_px_plain(sc, cam, bnd, rp.params, *blk, work=work))
    k3_err = coarse_agreement("full-size DYN coarse_px_kernel (K3) vs coarse_px_plain, config 2 dynamic, B=4",
                              cp.coarse_px(sc, cam, bnd, rp.params, *blk), px_p, strict=True, exact=True)
    k3_bound = roofline(march_flops(work, n_px, spec_cost, False), n_px * 8 + rp.params.brows * rp.params.bcols * 8)
    image_class("full-size chained dynamic frame vs the plain path", rp(arrays_d, hcv), rp.render_plain(arrays_d, hcv))
    if min(launches["coarse_px_kernel (DYN)"], launches["fine_kernel (DYN)"]) <= 0:
        raise AssertionError(f"a DYN kernel of the chained frame never launched: {launches}")
    log(f"chained dynamic frame (config 2, B=4) {WIDTH}x{HEIGHT} x16 AA: {ms:.4f} ms/frame (host {host_ms:.4f} ms), "
        f"launches {launches}; DYN K3 alone {k3_ms:.4f} ms (device time "
        f"{ms_text(k3_dev)}, torch.profiler), plain {k3_plain_ms:.2f} ms, "
        f"bound {k3_bound[0]:.4f} ms "
        f"({k3_bound[1]}) ({smi})")
    records.append(dict(
        name="coarse_px_kernel (K3 DYN: config 2 dynamic, B=4)", route="cuda",
        source="raymarch_tpu_torch/csrc/coarse_px.cu", replaces="raymarch_tpu/ops/pallas_prepass.py:969",
        launches=launches["coarse_px_kernel (DYN)"], max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms,
        bound_ms=k3_bound[0], bound_by=k3_bound[1], library_ms=None))
    out["chain_dynamic"] = dict(ms=ms, k3_ms=k3_ms, k3_dev=k3_dev, launches=launches)
    del blk, px_p

    # march_only_fast on the dynamic tape (bench.py:678-693's options).
    mo = cp.make_pallas_image_march_fast(spec_d, cfg_ir, WIDTH, HEIGHT, device=dev, prepass_block=1, n_intervals=2)
    ms, host_ms, launches = frames(lambda: mo(arrays_d, hcv))
    sc, cam, bnd = mo.scene_args(arrays_d, hcv)
    pre = mo.prepass(sc, cam, bnd, None)
    fm_ms = cuda_ms(lambda: cp.fine_march(sc, cam, bnd, mo.params, *pre), KERNEL_REPS)
    work = cp.WorkCount()
    (_, t_p, h_p), p_ms = plain_ms(lambda: cp.fine_res_plain(sc, cam, bnd, mo.params, *pre, work=work))
    t_k, h_k = cp.fine_march(sc, cam, bnd, mo.params, *pre)
    mo_err = residual_agreement("full-size DYN march-only build vs fine_res_plain's (t, hit)", (t_k, h_k),
                                (t_p.reshape(-1), h_p.reshape(-1)), strict=True)
    n_push = scene_cost(spec_cost)[0]
    march_work = cp.WorkCount(points=float(work.points) - 4 * float(work.hits),
                              leaf_evals=float(work.leaf_evals) - 4 * float(work.hits) * n_push)
    mo_bound = roofline(march_flops(march_work, n_rays, spec_cost, False), n_rays * 8 + 4 * n_px * 4)
    if launches["fine_kernel (march only, DYN)"] <= 0:
        raise AssertionError(f"the DYN march-only build never launched: {launches}")
    log(f"march_only_fast on the dynamic tape: {ms:.4f} ms/frame, {n_rays / (ms * 1e-3) / 1e9:.4f} Grays/s, launches "
        f"{launches}; DYN march-only build alone {fm_ms:.4f} ms, plain {p_ms:.2f} ms, bound {mo_bound[0]:.4f} ms "
        f"({mo_bound[1]}) ({smi})")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    records.append(dict(
        name="fine_kernel (march only, DYN: march_only_fast on the dynamic tape)", route="cuda",
        source="raymarch_tpu_torch/csrc/fine_march_dyn.cu", replaces="raymarch_tpu/ops/pallas_prepass.py:1827",
        launches=launches["fine_kernel (march only, DYN)"], max_abs_err=mo_err, ms=fm_ms, plain_ms=p_ms,
        bound_ms=mo_bound[0], bound_by=mo_bound[1], library_ms=None))
    out["march_fast_dynamic"] = dict(ms=ms, kernel_ms=fm_ms, launches=launches)
    del t_p, h_p, t_k, h_k

    # The soft frame on the dynamic tape (no prepass, relax 1).
    rs = cp.make_pallas_image_render_aa(spec_d, cfg, WIDTH, HEIGHT, device=dev, no_prepass=True, soft=True)
    ms, host_ms, launches = frames(lambda: rs(arrays_d, hcv))
    sc, cam, bnd = rs.scene_args(arrays_d, hcv)
    sf_ms = cuda_ms(lambda: cp.fine(sc, cam, bnd, rs.params), KERNEL_REPS)
    work = cp.WorkCount()
    (img_p, *_), p_ms = plain_ms(lambda: cp.fine_res_plain(sc, cam, bnd, rs.params, work=work))
    sf_err = image_class("full-size DYN soft fine kernel vs fine_res_plain", cp.fine(sc, cam, bnd, rs.params), img_p)
    sf_bound = roofline(march_flops(work, n_rays, spec_cost, False, float(work.hits), fine=True), n_px * 12)
    if launches["fine_kernel (soft, DYN)"] <= 0:
        raise AssertionError(f"the DYN soft build never launched: {launches}")
    log(f"soft frame on the dynamic tape: {ms:.4f} ms/frame, launches {launches}; DYN soft fine kernel alone "
        f"{sf_ms:.4f} ms, plain {p_ms:.2f} ms, bound {sf_bound[0]:.4f} ms ({sf_bound[1]}) ({smi})")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    records.append(dict(
        name="fine_kernel (soft, DYN: config 2 dynamic)", route="cuda", source="raymarch_tpu_torch/csrc/fine_soft.cu",
        replaces="raymarch_tpu/ops/pallas_prepass.py:1521", launches=launches["fine_kernel (soft, DYN)"],
        max_abs_err=sf_err, ms=sf_ms, plain_ms=p_ms, bound_ms=sf_bound[0], bound_by=sf_bound[1], library_ms=None))
    out["soft_dynamic"] = dict(ms=ms, kernel_ms=sf_ms, launches=launches)
    del img_p

    # The tori at n_intervals = 6, B = 4: both passes keep the intervals in
    # the planes.
    rw = cp.make_pallas_image_render_aa(spec_t, cfg, WIDTH, HEIGHT, device=dev, prepass_block=4, n_intervals=6)
    ms, host_ms, launches = frames(lambda: rw(arrays_t, acv))
    sc, cam, bnd = rw.scene_args(arrays_t, acv)
    pre = cp.coarse(sc, cam, bnd, rw.params)
    c_ms = cuda_ms(lambda: cp.coarse(sc, cam, bnd, rw.params), KERNEL_REPS)
    f_ms = cuda_ms(lambda: cp.fine(sc, cam, bnd, rw.params, *pre), KERNEL_REPS)
    work_c, work_f = cp.WorkCount(), cp.WorkCount()
    pre_p, c_plain_ms = plain_ms(lambda: cp.coarse_plain(sc, cam, bnd, rw.params, work=work_c))
    c_err = interval_agreement("full-size coarse kernel, 6 intervals in place, tori", pre, pre_p)
    img_p, f_plain_ms = plain_ms(lambda: cp.fine_plain(sc, cam, bnd, rw.params, *pre, work=work_f))
    f_err = image_class("full-size fine kernel through 6 intervals in place, tori", cp.fine(sc, cam, bnd, rw.params,
                                                                                            *pre), img_p)
    n_blk = rw.params.brows * rw.params.bcols
    c_bound = roofline(march_flops(work_c, n_blk, spec_t, False), n_blk * 12 * 4)
    f_bound = roofline(march_flops(work_f, n_rays, spec_t, False, float(work_f.hits), fine=True),
                       n_px * 12 + n_blk * 12 * 4)
    if min(launches["coarse_kernel (intervals in place)"], launches["fine_kernel (intervals in place)"]) <= 0:
        raise AssertionError(f"a kernel of the 6-interval frame never launched: {launches}")
    log(f"n_intervals = 6 frame (tori, B = 4) {WIDTH}x{HEIGHT} x16 AA: {ms:.4f} ms/frame, launches {launches}; coarse "
        f"alone {c_ms:.4f} ms (plain {c_plain_ms:.2f}, bound {c_bound[0]:.4f} {c_bound[1]}), fine alone {f_ms:.4f} ms "
        f"(plain {f_plain_ms:.2f}, bound {f_bound[0]:.4f} {f_bound[1]}) ({smi})")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    for name, src, rep, n_l, err, k_ms, pl_ms, bd in (
            ("coarse_kernel (6 intervals in place: tori, B = 4)", "prepass.cu", "885",
             launches["coarse_kernel (intervals in place)"], c_err, c_ms, c_plain_ms, c_bound),
            ("fine_kernel (6 intervals in place: tori, B = 4)", "intervals_wide.cu", "1521",
             launches["fine_kernel (intervals in place)"], f_err, f_ms, f_plain_ms, f_bound)):
        records.append(dict(name=name, route="cuda", source=f"raymarch_tpu_torch/csrc/{src}",
                            replaces=f"raymarch_tpu/ops/pallas_prepass.py:{rep}", launches=n_l, max_abs_err=err,
                            ms=k_ms, plain_ms=pl_ms, bound_ms=bd[0], bound_by=bd[1], library_ms=None))
    out["ni6"] = dict(ms=ms, coarse_ms=c_ms, fine_ms=f_ms, launches=launches)
    del pre, pre_p, img_p
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return records, out


# --- phase 17: the port's f64 oracle ---------------------------------------
ORACLE_W, ORACLE_H = 96, 54
ORACLE_POS = (0.0, 2.6, 4.2)  # bench.py's gate camera: the floor's horizon out of frame


def oracle_phase(rt, cp, dev, smi):
    """Phase 17: the headline path against the port's own f64 oracle
    (`raymarch_tpu_torch.oracle.render`: numpy, no jax) at ORACLE_W x
    ORACLE_H, in the reference's classes (bench.py:236-259) at its gate
    camera. The headline frame through make_renderer(backend=
    "pallas_prepass") (config 2, 16 AA, bound_accel: K1 and K2 behind the
    cone prepass, a conservative accelerator) in the accelerated class, as
    bench.py's "headline-prepass" gate holds it; the exact-semantics paths
    (K2 without a prepass, bench.py's "no-prepass" and "strict-reference")
    within max|d| < 1e-3. Returns the phase's numbers."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    scene = scene_config2(rt)
    tape = rt.encode_wire(scene)
    spec, arrays = rt.compile_scene(scene, static=True)
    cfg0 = rt.DEFAULT_CONFIG
    cfg = dataclasses.replace(cfg0, bound_accel=True, exit_check_every=4)
    cam = rt.Camera.looking_at(position=ORACLE_POS, target=(0.0, 0.0, 0.0))
    t = time.perf_counter()
    ref = torch.tensor(np.asarray(rt.oracle.render(tape, cam, ORACLE_W, ORACLE_H, cfg0), np.float32), device=dev)
    oracle_s = time.perf_counter() - t
    render = rt.make_renderer(spec, ORACLE_W, ORACLE_H, cfg, mode="forward", backend="pallas_prepass", device=dev)
    cp.reset_launch_counts()
    img = render(arrays, cam)
    torch.cuda.synchronize()
    launches = {"coarse_kernel": cp.coarse.launches, "fine_kernel": cp.fine.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the headline frame did not run its kernels: {launches}")
    if tuple(img.shape) != (ORACLE_H, ORACLE_W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the headline frame is not a finite {ORACLE_H}x{ORACLE_W}x3 image")
    out = {"oracle_s": oracle_s, "launches": launches}
    image_class(f"oracle: headline frame (pallas_prepass, {ORACLE_W}x{ORACLE_H}) vs raymarch_tpu_torch.oracle.render",
                img, ref)
    out["headline_max"] = float((img - ref).abs().max())
    for name, c in (("no-prepass", cfg), ("strict-reference", cfg0)):
        rp = cp.make_pallas_image_render_aa(spec, c, ORACLE_W, ORACLE_H, device=dev, no_prepass=True)
        out[name] = image_max(f"oracle: {name} frame (K2 without a prepass) vs raymarch_tpu_torch.oracle.render",
                              rp(arrays, rt.cam_vec(cam, device=dev)), ref)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"oracle summary: the f64 oracle's frame {oracle_s:.2f} s on the host; headline max|d| "
        f"{out['headline_max']:.3e}, no-prepass {out['no-prepass']:.3e}, strict-reference "
        f"{out['strict-reference']:.3e}; launches {launches}; phase {out['seconds']:.1f} s ({smi})")
    return out


# --- phase 18: multi-device (the row-sharded renderer and fit step) --------------
SHARD_K = 4  # bands of the one-rank runs of 18a/18b: 4 x 270 rows at 1080p
MID_BAND = 2  # the band whose kernels are timed alone (rows 540-810: the scene's centre)
BAND_GATE = (83, 37)  # (first row, rows) of the uneven gate band at 256x144: across config 2's lower edge
BAND_PAST = (120, 37)  # a gate band that reaches 13 rows past the image (config 2: floor only)
ORACLE_PIXELS = 48  # pixels of 18b's gate held against the f64 oracle (~7 ms a ray on the card's host)
RANK_WORLD = 2  # 18c: ranks on the one card (gloo), each with SHARD_K // RANK_WORLD bands
PART_WORLD = 3  # 18c: a second world on the card, whose ranks 0..RANK_WORLD-1 form a mesh of RANK_WORLD
RANK_TIMEOUT_S = 240


def Recorder(params):
    """An optimizer over `params` that moves nothing and keeps the
    gradients it is given (`.grads`): the fit step's reduced gradients."""
    import torch

    class _Recorder(torch.optim.Optimizer):
        def __init__(self, ps):
            super().__init__(ps, {})
            self.grads = None

        def step(self, closure=None):
            self.grads = [p.grad.detach().clone() for g in self.param_groups for p in g["params"]]

    return _Recorder(params)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def fit_grads(step, arrays, camera, target):
    """(loss, (d_lp, d_opp, d_cam f32[8])) of one step of `step` (built with
    Recorder optimizers and fit_camera), in grad_class's layout."""
    import torch

    st = step.init_opt_state(arrays, camera)
    _, _, st, loss = step(arrays, camera, st, target)
    g = st.optimizer.grads + st.cam_optimizer.grads
    return float(loss), (g[0], g[1], torch.cat([g[2], g[3], torch.zeros(1, device=g[2].device)]))


def sharded_program(rt, mesh, dev, k, cfg):
    """The headline's sharded frame and fit step on `mesh` at row_interleave
    `k`: the frame's float64 checksum and digest, the loss and reduced
    gradients of a step against a constant target, and the parameters and
    pose after one SGD step (lr 1e-2). 18a runs it on one rank (k = 4), 18c
    on each of two ranks (k = 2): the same 270-row bands."""
    import functools
    import hashlib

    import numpy as np
    import torch

    from raymarch_tpu_torch.parallel import make_fit_step, make_sharded_renderer

    spec, arrays = rt.compile_scene(scene_config2(rt), static=True)
    camera = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    img = make_sharded_renderer(spec, WIDTH, HEIGHT, mesh, cfg, backend="pallas_prepass", row_interleave=k)(
        arrays, camera)
    host = img.cpu().numpy()
    target = torch.full((HEIGHT, WIDTH, 3), 0.2, device=dev)
    kw = dict(backend="pallas_fused", fit_camera=True, row_interleave=k)
    loss, g = fit_grads(make_fit_step(spec, WIDTH, HEIGHT, mesh, Recorder, cfg, camera_optimizer=Recorder, **kw),
                        arrays, camera, target)
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    step = make_fit_step(spec, WIDTH, HEIGHT, mesh, sgd, cfg, camera_optimizer=sgd, **kw)
    a, cam, _, loss_sgd = step(arrays, camera, step.init_opt_state(arrays, camera), target)
    out = dict(checksum=np.float64(host.astype(np.float64).sum()),
               digest=np.frombuffer(hashlib.sha256(host.tobytes()).digest(), np.uint8),
               loss=np.float64(loss), loss_sgd=np.float64(float(loss_sgd)))
    out.update({f"g{i}": v.cpu().numpy() for i, v in enumerate(g)})
    out.update(lp=a.leaf_params.cpu().numpy(), op=a.op_param.cpu().numpy(), pos=cam.position.cpu().numpy(),
               rot=cam.rotation.cpu().numpy())
    return img, out


def outside_mesh(rt, mesh, cfg, ckpt_dir):
    """18c's rank outside the mesh of part of the world: what the
    factories built on the mesh raise (each must be a ValueError that says
    so), in how many seconds, and whether the checkpointer made its
    directory."""
    import os

    import numpy as np
    import torch

    from raymarch_tpu_torch.parallel import FitCheckpointer, all_reduce_sum, make_fit_step, make_sharded_renderer

    spec, arrays = rt.compile_scene(scene_config2(rt), static=True)
    attempts = (
        ("make_sharded_renderer", lambda: make_sharded_renderer(spec, WIDTH, HEIGHT, mesh, cfg,
                                                                backend="pallas_prepass")),
        ("make_fit_step", lambda: make_fit_step(spec, WIDTH, HEIGHT, mesh, Recorder, cfg, backend="pallas_fused")),
        ("FitCheckpointer", lambda: FitCheckpointer(ckpt_dir, mesh=mesh)),
        ("all_reduce_sum", lambda: all_reduce_sum(torch.zeros(3, device=mesh.device), mesh)),
    )
    t0 = time.perf_counter()
    refused = []
    for name, attempt in attempts:
        try:
            attempt()
        except ValueError as e:
            if "outside this mesh" in str(e):
                refused.append(name)
    return dict(refused=np.array(refused), seconds=np.float64(time.perf_counter() - t0),
                made_dir=np.array(os.path.exists(ckpt_dir)))


def rank_main(rank: int, world: int, port: int, out: str, device: str, mesh_size: int = 0) -> int:
    """One rank of 18c (`chip_smoke.py --rank R --world N --port P --out F
    --device D [--mesh M]`, D the parent's device): joins a gloo group with
    tensors on D (several ranks on one card: NCCL refuses a duplicate GPU),
    takes the mesh of the world, or with M of ranks 0..M-1 (every rank
    calls make_mesh(M)), runs `sharded_program` at row_interleave SHARD_K
    // the mesh's ranks, and writes its results to F. A rank outside the
    mesh writes what `outside_mesh` finds instead."""
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    if device.startswith("cuda") and not torch.cuda.is_available():
        print("chip_smoke rank: CUDA is not available", file=sys.stderr)
        return 2
    import raymarch_tpu_torch as rt
    from raymarch_tpu_torch.ops.cuda_prepass import resolve_device
    from raymarch_tpu_torch.parallel import initialize_multihost, make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    initialize_multihost(f"localhost:{port}", world, rank, retries=3, retry_delay=2.0, initialization_timeout=120,
                         backend="gloo", device=dev)
    try:
        n = mesh_size or world
        mesh = make_mesh(n, device=dev)  # collective over the world: every rank calls it
        cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
        if not mesh.member:
            res = outside_mesh(rt, mesh, cfg, str(Path(out).with_suffix(".ckpt")))
            np.savez(out, **res)
            print(f"rank {rank}/{world} outside the mesh of {n} (gloo, tensors on {dev}): refused by "
                  f"{res['refused'].tolist()} in {float(res['seconds']):.3f} s", flush=True)
            return 0
        if dist.get_backend() != "gloo" or mesh.shape["rays"] != n or mesh.rank != rank or mesh.device != dev:
            raise AssertionError(f"rank {rank}: unexpected mesh {mesh} on {dist.get_backend()}")
        t1 = time.perf_counter()
        _, res = sharded_program(rt, mesh, dev, SHARD_K // n, cfg)
        np.savez(out, **res)
        print(f"rank {rank}/{world} (mesh of {n}; gloo, tensors on {dev}): set-up {t1 - t0:.2f} s, program "
              f"{time.perf_counter() - t1:.2f} s, loss {float(res['loss']):.8f}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def sphere_pool_words(tape):
    """{wire word: (leaf row, column)} of a hard union of spheres: the
    spheres' rows in wire order, centre and radius in columns 4-7
    (tests/test_grad_oracle.py:_word_map for this one leaf type)."""
    from raymarch_tpu_torch.ops import opcodes as oc

    out, i, row = {}, 0, 0
    while i < len(tape):
        op = int(tape[i])
        n = oc.WIRE_PARAM_COUNT[op]
        if op == oc.OP_SPHERE:
            out.update({i + 1 + c: (row, 4 + c) for c in range(n)})
            row += 1
        elif n:
            raise ValueError(f"not a hard union of spheres: opcode {op} has parameters")
        i += 1 + n
    return out


def band_gates(rt, cp, cg, dev, cfg, cfg64, gcam_pos):
    """18d: the band kernels against their plain versions at the 256x144
    gate on the uneven band BAND_GATE, at the gates of their full-frame
    forms: K1 (planes), K2 with residuals, K8 (config 2), the culled K1/K2
    and K9 (64 spheres), K4 with aa_shared_normals; and config 2's frame on
    BAND_PAST, whose rows past the image must be finite and in the image
    class of the plain version. Returns {"fused_bwd": K8's error,
    "compact_bwd": K9's}."""
    import torch

    i0, rows = BAND_GATE
    err = {}
    for gname, build, pos, c in (("config 2", scene_config2, gcam_pos, cfg),
                                 ("64 spheres", scene_spheres, (0.0, 2.5, 9.0), cfg64)):
        spec, arrays = rt.compile_scene(build(rt), static=True)
        fr = cg.make_fused_render_vjp(spec, c, GATE_W, GATE_H, band_rows=rows, device=dev)
        rp, p = fr.prepass, fr.params
        cv = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0, 0, 0)), i0, device=dev)
        sc, cam, bnd = rp.scene_args(arrays, cv)
        cc, fc = rp.cull_args(sc, cam)
        what = f"{gname}, band of {rows} rows from row {i0} of {GATE_H}"
        pre_k = cp.coarse(sc, cam, bnd, p, cc)
        coarse_agreement(f"gate band coarse kernel vs coarse_plain, {what}", pre_k,
                         cp.coarse_plain(sc, cam, bnd, p, cc), strict=True)
        img_k, t_k, hit_k = cp.fine_res(sc, cam, bnd, p, *pre_k, cull=fc)
        img_p, t_p, hit_p = cp.fine_res_plain(sc, cam, bnd, p, *pre_k, cull=fc)
        image_class(f"gate band fine kernel with residuals vs fine_res_plain, {what}", img_k, img_p)
        residual_agreement(f"gate band residuals vs fine_res_plain, {what}", (t_k, hit_k), (t_p, hit_p),
                           strict=not c.leaf_cull)  # phase 9 holds the culled relaxed residuals so
        if img_k.shape != (rows, GATE_W, 3) or not bool(torch.isfinite(img_k).all()):
            raise AssertionError(f"the band's frame is {tuple(img_k.shape)} or not finite ({what})")
        g_img = seeded_cotangent(rows, GATE_W, dev, 11)
        if fr.compact_bwd:
            clamp = float(c.grad_denom_clamp)
            got = cg.compact_bwd(sc, fc, cam, p, clamp, t_k, hit_k, g_img)
            ref = cg.compact_bwd_plain(sc, fc, cam, p, clamp, t_k, hit_k, g_img)
            name = "compact_bwd"
        else:
            got = cg.bwd(sc, cam, p, fr.layout, t_k, hit_k, g_img)
            ref = cg.bwd_plain(sc, cam, p, fr.layout, t_k, hit_k, g_img)
            name = "fused_bwd"
        err[name] = grad_class(f"gate band {name} kernel vs its plain version, {what} ({int(hit_k.sum())} hit rays)",
                               got, ref)
    spec, arrays = rt.compile_scene(scene_config2(rt), static=True)
    j0, past = BAND_PAST
    fr = cg.make_fused_render_vjp(spec, cfg, GATE_W, GATE_H, band_rows=past, device=dev)
    sc, cam, bnd = fr.prepass.scene_args(arrays, rt.cam_vec(rt.Camera.looking_at(position=gcam_pos, target=(0, 0, 0)),
                                                            j0, device=dev))
    pre_k = cp.coarse(sc, cam, bnd, fr.params)
    img_k = cp.fine_res(sc, cam, bnd, fr.params, *pre_k)[0]
    if not bool(torch.isfinite(img_k).all()):
        raise AssertionError("the band past the image has non-finite pixels")
    image_class(f"gate band past the image ({past} rows from row {j0} of {GATE_H}) fine kernel vs fine_res_plain",
                img_k, cp.fine_res_plain(sc, cam, bnd, fr.params, *cp.coarse_plain(sc, cam, bnd, fr.params))[0])
    cfg_sn = dataclasses.replace(cfg, aa_shared_normals=True)
    rp = cp.make_pallas_image_render_aa(spec, cfg_sn, GATE_W, GATE_H, device=dev, band_rows=rows)
    if not rp.params.unpacked:
        raise AssertionError("aa_shared_normals should take K4")
    sc, cam, bnd = rp.scene_args(arrays, rt.cam_vec(rt.Camera.looking_at(position=gcam_pos, target=(0, 0, 0)), i0,
                                                    device=dev))
    pre = rp.prepass(sc, cam, bnd, None)
    image_class(f"gate band K4 (aa_shared_normals) vs fine_unpacked_plain, band of {rows} rows from row {i0}",
                cp.fine_unpacked(sc, cam, bnd, rp.params, *pre),
                cp.fine_unpacked_plain(sc, cam, bnd, rp.params, *pre)[0])
    return err


def multi_device(rt, cp, cg, dev, smi, cfg, gcam_pos):
    """Phase 18: the row-sharded renderer and fit step (see the module
    docstring). Returns the band kernels' records and the numbers the
    summary prints."""
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from raymarch_tpu_torch.ops.oracle_grad import pixel_grads
    from raymarch_tpu_torch.parallel import initialize_multihost, make_fit_step, make_mesh, make_sharded_renderer

    t_phase = time.perf_counter()
    out = {}
    cfg64 = dataclasses.replace(cfg, relax=1.6, leaf_cull=True)
    # -- 18a. one rank through NCCL at full width -----------------------------
    initialize_multihost(f"localhost:{free_port()}", 1, 0, initialization_timeout=120, backend="nccl", device=dev)
    try:
        mesh = make_mesh(device=dev)
        if mesh.group is None or dist.get_backend() != "nccl":
            raise AssertionError(f"18a should run through an NCCL group: {mesh}, {dist.get_backend()}")
        spec, arrays = rt.compile_scene(scene_config2(rt), static=True)
        camera = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
        render_s = make_sharded_renderer(spec, WIDTH, HEIGHT, mesh, cfg, backend="pallas_prepass",
                                         row_interleave=SHARD_K)
        render_1 = rt.make_renderer(spec, WIDTH, HEIGHT, cfg, mode="forward", backend="pallas_prepass", device=dev)
        ms_1 = [timed_frames(cp, lambda: render_1(arrays, camera))[0]]
        ms_s, host_s, launches_s = timed_frames(cp, lambda: render_s(arrays, camera))
        ms_s = [ms_s, timed_frames(cp, lambda: render_s(arrays, camera))[0]]
        ms_1.append(timed_frames(cp, lambda: render_1(arrays, camera))[0])
        per_frame = {k: v / (WARMUP + FRAMES) for k, v in launches_s.items()}
        log(f"18a sharded frame (1 rank, NCCL, row_interleave {SHARD_K}: bands {render_s.bands}) {WIDTH}x{HEIGHT} "
            f"x16 AA: {ms_s[0]:.4f} / {ms_s[1]:.4f} ms/frame against the single frame {ms_1[0]:.4f} / "
            f"{ms_1[1]:.4f} (CUDA events, S K K S; host clock {host_s:.4f} ms); launches a frame {per_frame} "
            f"({smi})")
        if per_frame["coarse_kernel"] != SHARD_K or per_frame["fine_kernel"] != SHARD_K:
            raise AssertionError(f"the sharded frame should launch K1 and K2 once a band: {per_frame}")
        img_s, res_a = sharded_program(rt, mesh, dev, SHARD_K, cfg)
        img_1 = render_1(arrays, camera)
        d_frame = float((img_s - img_1).abs().max())
        log(f"18a sharded frame vs make_renderer's frame: max|d| {d_frame:.3e} (need < 1e-3; the same kernels "
            f"per band) {'PASS' if d_frame < 1e-3 else 'FAIL'}")
        if not d_frame < 1e-3:
            raise AssertionError("the sharded frame differs from the single frame")
        del img_1

        target = torch.full((HEIGHT, WIDTH, 3), 0.2, device=dev)
        kw = dict(backend="pallas_fused", fit_camera=True, camera_optimizer=Recorder)
        step_s = make_fit_step(spec, WIDTH, HEIGHT, mesh, Recorder, cfg, row_interleave=SHARD_K, **kw)
        step_1 = make_fit_step(spec, WIDTH, HEIGHT, mesh, Recorder, cfg, **kw)
        cp.reset_launch_counts()
        cg.reset_launch_counts()
        loss_s, g_s = fit_grads(step_s, arrays, camera, target)
        step_launches = {"coarse_kernel": cp.coarse.launches, "fine_kernel_residuals": cp.fine_res.launches,
                         "fused_bwd_kernel": cg.bwd.launches, "compact_bwd_kernel": cg.compact_bwd.launches}
        log(f"18a launches in one sharded step: {step_launches}")
        if [step_launches[k] for k in ("coarse_kernel", "fine_kernel_residuals", "fused_bwd_kernel")] != [SHARD_K] * 3:
            raise AssertionError(f"the sharded step should launch K1, K2 and K8 once a band: {step_launches}")
        loss_1, g_1 = fit_grads(step_1, arrays, camera, target)
        grad_class(f"18a sharded fit step ({SHARD_K} bands) vs the single-band step", g_s, g_1)
        log(f"18a loss {loss_s:.9f} against the single-band step's {loss_1:.9f} (need rel < 1e-5)")
        if not abs(loss_s - loss_1) <= 1e-5 * abs(loss_1):
            raise AssertionError("the sharded loss differs from the single-band loss")

        step_ms = [timed_step_of(st_, arrays, camera, target) for st_ in (step_1, step_s, step_s, step_1)]
        log(f"18a fit step (fwd + bwd + all_reduce + optimizer) S K K S: {' / '.join(f'{v:.4f}' for v in step_ms)} "
            f"ms (CUDA events, {BWD_STEPS} steps after 1) ({smi})")
        out["frame_ms"], out["frame_1_ms"], out["step_ms"], out["step_1_ms"] = ms_s, ms_1, step_ms[1:3], step_ms[::3]

        # The band kernels alone on the middle band, against their plain
        # versions there (records; the frame's launches).
        i0m, rows_m = render_s.bands[MID_BAND]
        band_a = f"band of {rows_m} rows, {SHARD_K} a frame"
        fr_b = cg.make_fused_render_vjp(spec, cfg, WIDTH, HEIGHT, band_rows=rows_m, device=dev)
        p = fr_b.params
        sc, cam, bnd = fr_b.prepass.scene_args(arrays, rt.cam_vec(camera, i0m, device=dev))
        n_px, n_rays = rows_m * WIDTH, rows_m * WIDTH * cfg.aa_samples ** 2
        pre_k = cp.coarse(sc, cam, bnd, p)
        k1_ms = cuda_ms(lambda: cp.coarse(sc, cam, bnd, p), KERNEL_REPS)
        k2_ms = cuda_ms(lambda: cp.fine(sc, cam, bnd, p, *pre_k), KERNEL_REPS)
        k2r_ms = cuda_ms(lambda: cp.fine_res(sc, cam, bnd, p, *pre_k), KERNEL_REPS)
        img_r, t_k, hit_k = cp.fine_res(sc, cam, bnd, p, *pre_k)
        g_img = seeded_cotangent(rows_m, WIDTH, dev, 13) / n_px
        k8_ms = cuda_ms(lambda: cg.bwd(sc, cam, p, fr_b.layout, t_k, hit_k, g_img), KERNEL_REPS)
        work_c, work_f = cp.WorkCount(), cp.WorkCount()
        pre_p, k1_plain = plain_ms(lambda: cp.coarse_plain(sc, cam, bnd, p, work=work_c))
        k1_err = coarse_agreement(f"18a band coarse kernel vs coarse_plain (rows {i0m}-{i0m + rows_m})", pre_k, pre_p,
                                  strict=False)
        (img_p, t_p, hit_p), k2r_plain = plain_ms(lambda: cp.fine_res_plain(sc, cam, bnd, p, *pre_k, work=work_f))
        k2_err = image_class("18a band fine kernel with residuals vs fine_res_plain", img_r, img_p)
        residual_agreement("18a band residuals vs fine_res_plain", (t_k, hit_k), (t_p, hit_p), strict=False)
        _, k2_plain = plain_ms(lambda: cp.fine_plain(sc, cam, bnd, p, *pre_k))
        ref, k8_plain = plain_ms(lambda: cg.bwd_plain(sc, cam, p, fr_b.layout, t_k, hit_k, g_img))
        k8_err = grad_class("18a band fused_bwd kernel vs bwd_plain",
                            cg.bwd(sc, cam, p, fr_b.layout, t_k, hit_k, g_img), ref)
        del img_p, t_p, hit_p, ref
        k1_bound = roofline(march_flops(work_c, n_px, spec, False), n_px * 8)
        k2_bound = roofline(march_flops(work_f, n_rays, spec, False, float(work_f.hits), fine=True), n_px * 20)
        k2r_bound = roofline(march_flops(work_f, n_rays, spec, False, float(work_f.hits), fine=True),
                             n_px * 20 + n_rays * 8)
        *k8_bound_, _, _, _ = k8_bound(sc, p, cam, t_k, hit_k, fr_b.layout, n_rays)
        log(f"18a band kernels alone (rows {i0m}-{i0m + rows_m}): K1 {k1_ms:.4f} ms (plain {k1_plain:.2f}, bound "
            f"{k1_bound[0]:.4f}), K2 {k2_ms:.4f} (plain {k2_plain:.2f}, bound {k2_bound[0]:.4f}), K2 with residuals "
            f"{k2r_ms:.4f} (plain {k2r_plain:.2f}, bound {k2r_bound[0]:.4f}), K8 {k8_ms:.4f} (plain {k8_plain:.2f}, "
            f"bound {k8_bound_[0]:.4f}) ({smi})")
        del t_k, hit_k

        # -- 18b. the sharded compact backward (ROADMAP §3 fault 4) -----------
        spec64, arrays64 = rt.compile_scene(scene_spheres(rt), static=True)
        camera64 = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
        step_s64 = make_fit_step(spec64, WIDTH, HEIGHT, mesh, Recorder, cfg64, row_interleave=SHARD_K, **kw)
        step_164 = make_fit_step(spec64, WIDTH, HEIGHT, mesh, Recorder, cfg64, **kw)
        if step_s64.backward_info["kind"] != "pallas_compact":
            raise AssertionError(f"the sharded 64-sphere step must take K9: {step_s64.backward_info}")
        cp.reset_launch_counts()
        cg.reset_launch_counts()
        loss_s64, g_s64 = fit_grads(step_s64, arrays64, camera64, target)
        launches64 = {"coarse_kernel": cp.coarse.launches, "fine_kernel_residuals": cp.fine_res.launches,
                      "compact_bwd_kernel": cg.compact_bwd.launches, "fused_bwd_kernel": cg.bwd.launches}
        log(f"18b launches in one sharded 64-sphere step (culled bands on the list tiles: {step_s64.bands}): "
            f"{launches64}")
        if [launches64[k] for k in ("coarse_kernel", "fine_kernel_residuals", "compact_bwd_kernel",
                                    "fused_bwd_kernel")] != [SHARD_K, SHARD_K, SHARD_K, 0]:
            raise AssertionError(f"the sharded 64-sphere step should launch K1, K2 and K9 once a band: {launches64}")
        loss_164, g_164 = fit_grads(step_164, arrays64, camera64, target)
        grad_class(f"18b sharded 64-sphere step ({SHARD_K} bands, K9 per band) vs the single-band step", g_s64, g_164)
        log(f"18b loss {loss_s64:.9f} against the single-band step's {loss_164:.9f} (need rel < 1e-5)")
        if not abs(loss_s64 - loss_164) <= 1e-5 * abs(loss_164):
            raise AssertionError(f"the sharded 64-sphere loss {loss_s64} differs from {loss_164}")
        step64_ms = [timed_step_of(st_, arrays64, camera64, target) for st_ in (step_164, step_s64)]
        fr64 = cg.make_fused_render_vjp(spec64, cfg64, WIDTH, HEIGHT, band_rows=step_s64.bands[0][1], device=dev)
        cull_ms = []
        for i0, _ in step_s64.bands:
            sc64, cam64, _ = fr64.prepass.scene_args(arrays64, rt.cam_vec(camera64, i0, device=dev))
            cull_ms.append(cuda_ms(lambda: fr64.prepass.cull_args(sc64, cam64), KERNEL_REPS))
        fr641 = cg.make_fused_render_vjp(spec64, cfg64, WIDTH, HEIGHT, device=dev)
        sc64, cam64, _ = fr641.prepass.scene_args(arrays64, rt.cam_vec(camera64, device=dev))
        cull_1 = cuda_ms(lambda: fr641.prepass.cull_args(sc64, cam64), KERNEL_REPS)
        log(f"18b 64-sphere step single / sharded: {step64_ms[0]:.4f} / {step64_ms[1]:.4f} ms (CUDA events); "
            f"cull_args a band {' / '.join(f'{v:.4f}' for v in cull_ms)} ms (sum {sum(cull_ms):.4f}) against "
            f"{cull_1:.4f} for the whole frame ({smi})")
        out.update(step64_ms=step64_ms, cull_ms=cull_ms, cull_1=cull_1)

        # The culled band kernels alone on the middle band (records).
        i0m, rows_m = step_s64.bands[MID_BAND]
        p64 = fr64.params
        n_px, n_rays = rows_m * WIDTH, rows_m * WIDTH * cfg64.aa_samples ** 2
        sc, cam, bnd = fr64.prepass.scene_args(arrays64, rt.cam_vec(camera64, i0m, device=dev))
        cc, fc = fr64.prepass.cull_args(sc, cam)
        clamp = float(cfg64.grad_denom_clamp)
        pre_k = cp.coarse(sc, cam, bnd, p64, cc)
        c1_ms = cuda_ms(lambda: cp.coarse(sc, cam, bnd, p64, cc), KERNEL_REPS)
        c2_ms = cuda_ms(lambda: cp.fine_res(sc, cam, bnd, p64, *pre_k, cull=fc), KERNEL_REPS)
        img_r, t_k, hit_k = cp.fine_res(sc, cam, bnd, p64, *pre_k, cull=fc)
        g_img = seeded_cotangent(rows_m, WIDTH, dev, 17) / n_px
        k9_ms = cuda_ms(lambda: cg.compact_bwd(sc, fc, cam, p64, clamp, t_k, hit_k, g_img), KERNEL_REPS)
        work_c, work_f = cp.WorkCount(), cp.WorkCount()
        pre_p, c1_plain = plain_ms(lambda: cp.coarse_plain(sc, cam, bnd, p64, cc, work=work_c))
        c1_err = coarse_agreement("18b band culled coarse kernel vs coarse_plain, 64 spheres", pre_k, pre_p,
                                  strict=False)
        (img_p, t_p, hit_p), c2_plain = plain_ms(lambda: cp.fine_res_plain(sc, cam, bnd, p64, *pre_k, cull=fc,
                                                                           work=work_f))
        c2_err = image_class("18b band culled fine kernel with residuals vs fine_res_plain, 64 spheres", img_r, img_p)
        residual_agreement("18b band culled residuals vs fine_res_plain", (t_k, hit_k), (t_p, hit_p), strict=False)
        del img_p, t_p, hit_p
        ref, k9_plain = plain_ms(lambda: cg.compact_bwd_plain(sc, fc, cam, p64, clamp, t_k, hit_k, g_img,
                                                              band_rows=32))
        k9_err = grad_class("18b band compact_bwd kernel vs compact_bwd_plain, 64 spheres",
                            cg.compact_bwd(sc, fc, cam, p64, clamp, t_k, hit_k, g_img), ref)
        del ref
        list_bytes = 4 * (fc.lists.numel() + fc.counts.numel())
        c1_bound = roofline(march_flops(work_c, n_px, spec64, True), n_px * 8 + 4 * (cc.lists.numel()
                                                                                    + cc.counts.numel()))
        c2_bound = roofline(march_flops(work_f, n_rays, spec64, True, float(work_f.hits), fine=True),
                            n_px * 20 + n_rays * 8 + list_bytes)
        *k9_bound_, _, _ = k9_bound(sc, fc, p64, cam, t_k, hit_k, n_rays)
        log(f"18b culled band kernels alone (rows {i0m}-{i0m + rows_m}): K1 {c1_ms:.4f} ms (plain {c1_plain:.2f}, "
            f"bound {c1_bound[0]:.4f}), K2 with residuals {c2_ms:.4f} (plain {c2_plain:.2f}, bound {c2_bound[0]:.4f}), "
            f"K9 {k9_ms:.4f} (plain {k9_plain:.2f}, bound {k9_bound_[0]:.4f}) ({smi})")
        del t_k, hit_k

        # The sharded gate step against the single-band one and the port's
        # f64 oracle: its target is the single-band frame minus weights G
        # on ORACLE_PIXELS hit pixels where the frame agrees with the
        # oracle's, so the image cotangent is 2 G / (H W 3) there, 0 elsewhere.
        spec_u, arrays_u = rt.compile_scene(scene_spheres(rt), static=True, rebalance=False)
        fr_g = cg.make_fused_render_vjp(spec_u, cfg64, GATE_W, GATE_H, device=dev)
        rp = fr_g.prepass
        sc, cam, bnd = rp.scene_args(arrays_u, rt.cam_vec(camera64, device=dev))
        cc, fc = rp.cull_args(sc, cam)
        img_g, _, hit_g = cp.fine_res(sc, cam, bnd, fr_g.params, *rp.prepass(sc, cam, bnd, cc), cull=fc)
        rng = np.random.default_rng(3)
        px = rng.choice(np.flatnonzero(hit_g.amax(-1).reshape(-1).cpu().numpy() > 0), ORACLE_PIXELS, replace=False)
        s = cfg64.aa_samples ** 2
        idx = torch.as_tensor((px[:, None] * s + np.arange(s)[None, :]).reshape(-1))
        o, d = rt.raygen_flat(idx, torch.tensor(camera64.position), torch.tensor(camera64.rotation), GATE_W, GATE_H,
                              cfg64)
        tape = rt.encode_wire(scene_spheres(rt))
        t_o = time.perf_counter()
        col, dcol, dcam = pixel_grads(tape, o.numpy(), d.numpy(), cfg64, cam_rotation=np.asarray(camera64.rotation))
        oracle_s = time.perf_counter() - t_o
        img_h = img_g.reshape(-1, 3).cpu().numpy()
        agree = np.abs(img_h[px] - col.reshape(-1, s, 3).mean(1)).max(-1) < 1e-4
        G = np.zeros((GATE_H * GATE_W, 3))
        G[px] = rng.uniform(0.5, 1.5, (ORACLE_PIXELS, 3)) * agree[:, None]
        target_g = torch.tensor((img_h - G).reshape(GATE_H, GATE_W, 3).astype(np.float32), device=dev)
        gate_s = make_fit_step(spec_u, GATE_W, GATE_H, mesh, Recorder, cfg64, row_interleave=SHARD_K, **kw)
        gate_1 = make_fit_step(spec_u, GATE_W, GATE_H, mesh, Recorder, cfg64, **kw)
        _, gg_s = fit_grads(gate_s, arrays_u, camera64, target_g)
        _, gg_1 = fit_grads(gate_1, arrays_u, camera64, target_g)
        grad_class(f"18b gate: sharded 64-sphere step ({SHARD_K} bands of {gate_s.bands[0][1]} rows) vs the "
                   "single-band step", gg_s, gg_1)
        gray = np.repeat(G[px][:, None, :], s, axis=1).reshape(-1, 3) * 2.0 / (GATE_H * GATE_W * 3) / s
        o_words, o_cam = np.einsum("nc,ncw->w", gray, dcol), np.einsum("nc,ncw->w", gray, dcam)
        lp_g = gg_s[0].cpu().numpy()
        words = np.zeros(len(o_words))
        for w, (r, c) in sphere_pool_words(tape).items():
            words[w] = lp_g[r, c]
        scale, cscale = np.abs(o_words).max(), np.abs(o_cam).max()
        cam_g = gg_s[2][:7].cpu().numpy()
        ok = (int(agree.sum()) >= 8 and scale > 0 and np.abs(words - o_words).max() <= 0.01 * scale
              and np.abs(cam_g - o_cam).max() <= 0.02 * cscale)
        log(f"18b gate: sharded 64-sphere step vs the port's f64 oracle (ops/oracle_grad.py; {int(agree.sum())} of "
            f"{ORACLE_PIXELS} hit pixels agree within 1e-4, oracle {oracle_s:.2f} s): words max|d| "
            f"{np.abs(words - o_words).max():.3e} of max|g| {scale:.3e}, camera max|d| "
            f"{np.abs(cam_g - o_cam).max():.3e} of {cscale:.3e} (need <= 0.01, <= 0.02 of max|g|, >= 8 pixels) "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the sharded 64-sphere step disagrees with the f64 oracle")

        # -- 18c. two ranks on the one card (gloo, CUDA tensors); beside them
        # a world of PART_WORLD whose ranks 0..RANK_WORLD-1 form a mesh of
        # part of it ---------------------------------------------------------
        rank_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ranks"
        rank_dir.mkdir(parents=True, exist_ok=True)
        for f in rank_dir.glob("*.npz"):
            f.unlink()

        def launch(world, tag, mesh_size=0):
            port = free_port()
            return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world",
                                      str(world), "--port", str(port), "--out", str(rank_dir / f"{tag}{r}.npz"),
                                      "--device", str(dev), "--mesh", str(mesh_size)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                    for r in range(world)]

        t_c = time.perf_counter()
        procs = launch(RANK_WORLD, "rank") + launch(PART_WORLD, "part", RANK_WORLD)
        names = [f"rank {r}" for r in range(RANK_WORLD)] + [f"rank {r} of {PART_WORLD}" for r in range(PART_WORLD)]
        try:
            # -- 18d. band gates, while the ranks start ------------------------
            gate_err = band_gates(rt, cp, cg, dev, cfg, cfg64, gcam_pos)
            outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for name, p, text in zip(names, procs, outs):
            for line in text.strip().splitlines()[-6:]:
                log(f"  18c {name}: {line}")
            if p.returncode != 0:
                raise AssertionError(f"18c {name} failed with exit code {p.returncode}")

        def load(tag, world):
            res = []
            for r in range(world):
                with np.load(rank_dir / f"{tag}{r}.npz") as z:
                    res.append({k: z[k] for k in z.files})
            return res

        ranks, part = load("rank", RANK_WORLD), load("part", PART_WORLD)
        same = all(np.array_equal(ranks[1][k], ranks[0][k]) for k in ranks[0])
        r0 = ranks[0]
        eq_frame = (np.array_equal(r0["digest"], res_a["digest"]) and float(r0["checksum"]) == float(res_a["checksum"]))
        rel = {k: float(np.max(np.abs(r0[k] - res_a[k]) / np.maximum(np.abs(res_a[k]), 1e-30)))
               for k in ("loss", "loss_sgd", "lp", "op", "pos", "rot")}
        log(f"18c {RANK_WORLD} ranks x row_interleave {SHARD_K // RANK_WORLD} (gloo, CUDA tensors; "
            f"{time.perf_counter() - t_c:.1f} s with 18d beside it): ranks bit-equal {same}; gathered frame equal to "
            f"18a's {eq_frame} (checksum {float(r0['checksum']):.6f}); relative to 18a: {rel} (need < 1e-5)")
        if not (same and eq_frame and max(rel.values()) < 1e-5):
            raise AssertionError("18c: the two ranks disagree with each other or with 18a")
        grad_class("18c gradients of the two ranks vs 18a's (one rank)",
                   tuple(torch.tensor(r0[f"g{i}"]) for i in range(3)),
                   tuple(torch.tensor(res_a[f"g{i}"]) for i in range(3)))
        # The mesh of RANK_WORLD in the world of PART_WORLD: its ranks give
        # the two-rank world's results bit for bit; the ranks outside are
        # refused by every factory, before any collective.
        same_part = all(set(part[r]) == set(ranks[r]) and all(np.array_equal(part[r][k], ranks[r][k])
                                                              for k in ranks[r]) for r in range(RANK_WORLD))
        outside = part[RANK_WORLD:]
        want = ["make_sharded_renderer", "make_fit_step", "FitCheckpointer", "all_reduce_sum"]
        refused = all(o["refused"].tolist() == want and not bool(o["made_dir"]) for o in outside)
        log(f"18c mesh of {RANK_WORLD} in a world of {PART_WORLD} (gloo, CUDA tensors): its ranks' frame, loss, "
            f"gradients and updated parameters bit-equal to the two-rank world's {same_part}; ranks "
            f"{list(range(RANK_WORLD, PART_WORLD))} outside it refused by {[o['refused'].tolist() for o in outside]} "
            f"in {[round(float(o['seconds']), 4) for o in outside]} s (need all of {want}, no checkpoint directory)")
        if not (same_part and refused):
            raise AssertionError("18c: the mesh of part of the world disagrees with the two-rank world, or a rank "
                                 "outside it was not refused")
    finally:
        dist.destroy_process_group()

    def rec(name, source, replaces, launches, err, ms, plain, bound):
        return dict(name=name, route="cuda", source=f"raymarch_tpu_torch/csrc/{source}",
                    replaces=f"raymarch_tpu/ops/{replaces}", launches=launches, max_abs_err=err, ms=ms,
                    plain_ms=plain, bound_ms=bound[0], bound_by=bound[1], library_ms=None)

    band = f"band of {rows_m} rows, {SHARD_K} a frame"
    records = [
        rec(f"coarse_kernel ({band_a})", "prepass.cu", "pallas_prepass.py:885", launches_s["coarse_kernel"], k1_err,
            k1_ms, k1_plain, k1_bound),
        rec(f"fine_kernel ({band_a})", "prepass.cu", "pallas_prepass.py:1521", launches_s["fine_kernel"], k2_err,
            k2_ms, k2_plain, k2_bound),
        rec(f"fine_kernel (residuals t, hit; {band_a})", "prepass.cu", "pallas_prepass.py:1521",
            step_launches["fine_kernel_residuals"], k2_err, k2r_ms, k2r_plain, k2r_bound),
        rec(f"fused_bwd_kernel ({band_a})", "fused_bwd.cu", "pallas_grad.py:1432", step_launches["fused_bwd_kernel"],
            max(k8_err, gate_err["fused_bwd"]), k8_ms, k8_plain, k8_bound_),
        rec(f"coarse_kernel (culled lists; {band})", "prepass.cu", "pallas_prepass.py:885",
            launches64["coarse_kernel"], c1_err, c1_ms, c1_plain, c1_bound),
        rec(f"fine_kernel (culled, relax, residuals; {band})", "fine_culled.cu", "pallas_prepass.py:1521",
            launches64["fine_kernel_residuals"], c2_err, c2_ms, c2_plain, c2_bound),
        rec(f"compact_bwd_kernel ({band})", "compact_bwd.cu", "pallas_grad.py:256", launches64["compact_bwd_kernel"],
            max(k9_err, gate_err["compact_bwd"]), k9_ms, k9_plain, k9_bound_),
    ]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['seconds']:.1f} s ({smi})")
    return records, out


# --- phase 19: the five BASELINE configs through the port's examples ----------
CONFIG_RUNS = 2  # runs of each config: the first builds its renderers, the second finds them
# The configs' published sizes (examples/configs.py), passed on explicitly.
CONFIG_SIZES = {"1": (256, 256), "2": (512, 512), "3": (48, 48), "4": (1920, 1080), "5": (3840, 2160)}
CONFIG_ORACLE = 64  # config 1's oracle check, at 64x64
CONFIG_STRIDE = 64  # config 4's check of a frame: the mean of every 64th pixel of every 64th row


def baseline_configs(rt, cp, cg, dev, smi):
    """Phase 19: `raymarch_tpu_torch.examples.configs` config1() ...
    config5() on the card at their published sizes, each CONFIG_RUNS times
    (host seconds, launches of each run: counts set to 0 just before a run
    and read just after), with their checks: config 1 against the port's
    f64 oracle at 64x64 (max|d| < 1e-3); config 2's frame (K1, K2's
    materials build) against its plain path on the card; config 3's
    recovery of the blend's centre (within 0.1) and loss (halved) through
    K1, K2 with residuals and K8 once a step; config 4's 24 distinct
    frames, its frame 0 again by the kernels (its check equal to the
    config's) and against its plain path; config 5's finite 3840x2160
    sharded frame and its step's loss. Returns the numbers the summary
    prints."""
    import contextlib
    import io

    import numpy as np
    import torch

    from raymarch_tpu_torch.examples import configs

    t_phase = time.perf_counter()
    out = {}

    def run(k, expect, **kw):
        """CONFIG_RUNS runs of config k at its published size: (its last
        result, its printed lines); `expect` maps each kernel to the
        launches a run must make."""
        kw.update(width=CONFIG_SIZES[k][0], height=CONFIG_SIZES[k][1])
        seconds, counts = [], []
        for _ in range(CONFIG_RUNS):
            buf = io.StringIO()
            torch.cuda.synchronize()
            cp.reset_launch_counts()
            cg.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = configs.CONFIGS[k](dev, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts.append({"coarse_kernel": cp.coarse.launches, "fine_kernel": cp.fine.launches,
                           "fine_kernel_residuals": cp.fine_res.launches, "fused_bwd_kernel": cg.bwd.launches,
                           "compact_bwd_kernel": cg.compact_bwd.launches})
        text = buf.getvalue()
        for line in text.splitlines():
            if line.startswith(("config", "fit")):
                log(f"  19 config {k}: {line}")
        log(f"19 config {k}: {' / '.join(f'{v:.4f}' for v in seconds)} s a run (host clock, first run builds its "
            f"renderers); launches a run {counts[-1]} ({smi})")
        for c in counts:
            if any(c[name] != n for name, n in expect.items()) or any(
                    v for name, v in c.items() if name not in expect):
                raise AssertionError(f"config {k} should launch {expect} a run and nothing else: {counts}")
        out[k] = dict(seconds=seconds, launches=counts[-1])
        return res, text

    # Config 1: the "jnp" march on both sizes, against the f64 oracle.
    img1, text = run("1", {}, oracle_size=CONFIG_ORACLE)
    n = CONFIG_ORACLE
    err1 = float(text.split(f"max abs err vs oracle ({n}^2):")[1].split()[0])
    log(f"19 config 1 at {n}x{n} vs the port's f64 oracle: max|d| {err1:.3e} (need < 1e-3) "
        f"{'PASS' if err1 < 1e-3 else 'FAIL'}")
    if not (err1 < 1e-3 and img1.shape == (*CONFIG_SIZES["1"][::-1], 3) and np.isfinite(img1).all()):
        raise AssertionError("config 1 outside its oracle class, or its frame is not finite")

    # Config 2: K1 and K2's materials build at 512x512, against the plain path.
    img2, _ = run("2", {"coarse_kernel": 1, "fine_kernel": 1})
    scene2, cam2 = configs.config2_scene()
    spec2, arrays2 = rt.compile_scene(scene2, static=True)
    r2 = rt.make_renderer(spec2, *CONFIG_SIZES["2"], mode="forward", backend="pallas_prepass", device=dev)
    if not spec2.has_materials:
        raise AssertionError("config 2's painted scene should take K2's materials build")
    image_class("19 config 2 frame (the kernels) vs its plain path on the card",
                torch.tensor(img2, device=dev), r2.renderer.render_plain(arrays2, rt.cam_vec(cam2, device=dev)))

    # Config 3: the fit through K1, K2 with residuals and K8, 60 steps.
    steps = 60
    res3, _ = run("3", {"coarse_kernel": steps, "fine_kernel_residuals": steps, "fused_bwd_kernel": steps})
    cx = float(res3.arrays.leaf_params[0, 4])
    ok3 = abs(cx - (-0.5)) < 0.1 and res3.losses[-1] < 0.5 * res3.losses[0]
    log(f"19 config 3: cx {cx:+.4f} (truth -0.5000, need within 0.1), loss {res3.losses[0]:.6e} -> "
        f"{res3.losses[-1]:.6e} (need halved), {1.0 / res3.steps_per_sec:.5f} s/step, backward "
        f"{res3.backward_info['kind']} {'PASS' if ok3 else 'FAIL'}")
    if not ok3:
        raise AssertionError("config 3 did not recover the blend")
    out["3"]["step_s"] = 1.0 / res3.steps_per_sec

    # Config 4: 24 frames at 1080p with an edit each, one renderer.
    frames = 24
    checks, _ = run("4", {"coarse_kernel": frames, "fine_kernel": frames}, frames=frames, check_stride=CONFIG_STRIDE)
    if len(checks) != frames or len(set(checks)) != frames or not np.isfinite(checks).all():
        raise AssertionError(f"config 4's frames should be {frames} distinct finite ones: {checks}")
    g, s = configs.config4_graph()
    cam4 = configs.config4_frame(g, s, rt.OrbitCameraController(target=(0, 0, 0), radius=4.5), 0)
    spec4, arrays4 = rt.compile_scene(g.evaluate_root(), static=True)
    r4 = rt.make_renderer(spec4, *CONFIG_SIZES["4"], mode="forward", backend="pallas_prepass", device=dev)
    img4 = r4(arrays4, cam4)
    check0 = float(img4[::CONFIG_STRIDE, ::CONFIG_STRIDE].mean())
    log(f"19 config 4: {frames} distinct frames; frame 0 again by the kernels: check {check0:.7f} against the "
        f"config's {checks[0]:.7f} (need equal)")
    if check0 != checks[0]:
        raise AssertionError("config 4's frame 0 differs from the config's")
    image_class("19 config 4 frame 0 (the kernels) vs its plain path on the card", img4,
                r4.renderer.render_plain(arrays4, rt.cam_vec(cam4, device=dev)))
    del img4

    # Config 5: the 4K sharded frame (K1, K2 over one rank's one band) and
    # the distributed "jnp" step at 64x64.
    img5, text = run("5", {"coarse_kernel": 1, "fine_kernel": 1})
    loss5 = float(text.split("distributed fit step loss=")[1].split()[0])
    if img5.shape != (*CONFIG_SIZES["5"][::-1], 3) or not np.isfinite(img5).all() or not np.isfinite(loss5):
        raise AssertionError(f"config 5's frame is {img5.shape} or not finite, or its loss {loss5}")
    log(f"19 config 5: {img5.shape[1]}x{img5.shape[0]} frame finite, mean {float(img5.mean()):.6f}; step loss "
        f"{loss5:.5f}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19: {out['seconds']:.1f} s ({smi})")
    return out


def timed_step_of(step, arrays, camera, target):
    """Mean ms (CUDA events) of `step` over BWD_STEPS runs after one."""
    st = step.init_opt_state(arrays, camera)
    return cuda_ms(lambda: step(arrays, camera, st, target), BWD_STEPS)


def main() -> int:
    import torch

    global T_START
    T_START = time.perf_counter()

    smi = None
    try:
        smi = card_line()
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        smi_err = e
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if smi is None:
        raise RuntimeError(f"nvidia-smi: {smi_err}")
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    import numpy as np

    import raymarch_tpu_torch as rt
    from raymarch_tpu_torch import _build
    from raymarch_tpu_torch.ops import cuda_grad as cg
    from raymarch_tpu_torch.ops import cuda_prepass as cp

    torch.cuda.set_device(0)
    dev = cp.resolve_device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    # -- 2. build -------------------------------------------------------------
    t = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t
    log(f"build: {build_s:.2f} s total, nvcc {_build.stats['seconds']:.2f} s, "
        f"{_build.stats['builds']} compile(s) -> {_build.stats['path']}; each source's nvcc done at (s): "
        f"{_build.stats['source_seconds']}")
    for line in _build.stats["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    scene = scene_config2(rt)
    spec, arrays = rt.compile_scene(scene, static=True)
    cfg0 = rt.DEFAULT_CONFIG
    cfg = dataclasses.replace(cfg0, bound_accel=True, exit_check_every=4)

    # -- 3. kernel vs plain at the gate frame ---------------------------------
    gcam = rt.cam_vec(rt.Camera.looking_at(position=(0.0, 2.6, 4.2), target=(0, 0, 0)), device=dev)
    rp = cp.make_pallas_image_render_aa(spec, cfg, GATE_W, GATE_H, device=dev)
    sc, cam, bound = rp.scene_args(arrays, gcam)
    pre_k = cp.coarse(sc, cam, bound, rp.params)
    pre_p = cp.coarse_plain(sc, cam, bound, rp.params)
    coarse_agreement("gate coarse kernel vs coarse_plain", pre_k, pre_p, strict=True)
    img_k = cp.fine(sc, cam, bound, rp.params, *pre_k)
    img_p = cp.fine_plain(sc, cam, bound, rp.params, *pre_k)
    image_class("gate fine kernel vs fine_plain (same planes)", img_k, img_p)
    rp0 = cp.make_pallas_image_render_aa(spec, cfg0, GATE_W, GATE_H, device=dev, no_prepass=True)
    sc0, cam0, bound0 = rp0.scene_args(arrays, gcam)
    d0 = float((cp.fine(sc0, cam0, bound0, rp0.params) - cp.fine_plain(sc0, cam0, bound0, rp0.params)).abs().max())
    log(f"gate no_prepass fine kernel vs fine_plain: max|d|={d0:.3e} (need <1e-3) "
        f"{'PASS' if d0 < 1e-3 else 'FAIL'}")
    if not d0 < 1e-3:
        raise AssertionError("no_prepass fine kernel outside its tolerance")
    torch.cuda.synchronize()

    # -- 6. residuals and the backward at the gate frame ----------------------
    img_r, t_k, hit_k = cp.fine_res(sc, cam, bound, rp.params, *pre_k)
    if not torch.equal(img_r, img_k):
        raise AssertionError("the residual output changed the fine kernel's image")
    img_rp, t_p, hit_p = cp.fine_res_plain(sc, cam, bound, rp.params, *pre_k)
    image_class("gate fine kernel with residuals vs fine_res_plain", img_r, img_rp)
    residual_agreement("gate residuals (t, hit) kernel vs fine_res_plain", (t_k, hit_k), (t_p, hit_p), strict=True)
    del img_rp, t_p, hit_p
    for gname, build in (("config2", scene_config2), ("smooth", scene_smooth), ("rich", scene_rich)):
        spec_g, arrays_g = rt.compile_scene(build(rt), static=True)
        fr = cg.make_fused_render_vjp(spec_g, cfg, GATE_W, GATE_H, device=dev)
        sc_g, cam_g, bound_g = fr.prepass.scene_args(arrays_g, gcam)
        pre_g = cp.coarse(sc_g, cam_g, bound_g, fr.params)
        _, t_g, hit_g = cp.fine_res(sc_g, cam_g, bound_g, fr.params, *pre_g)
        g_img = seeded_cotangent(GATE_H, GATE_W, dev, 11)
        got = cg.bwd(sc_g, cam_g, fr.params, fr.layout, t_g, hit_g, g_img)
        ref = cg.bwd_plain(sc_g, cam_g, fr.params, fr.layout, t_g, hit_g, g_img)
        grad_class(f"gate fused_bwd kernel vs bwd_plain, {gname} ({fr.layout.nscal} words, "
                   f"{int(hit_g.sum())} hit rays)", got, ref)
    torch.cuda.synchronize()

    # -- 4. the main path at full size ----------------------------------------
    camera = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    render = rt.make_renderer(
        spec, WIDTH, HEIGHT, cfg, mode="forward", backend="pallas_prepass", device=dev
    )
    n_rays = WIDTH * HEIGHT * cfg.aa_samples ** 2
    cp.reset_launch_counts()
    for _ in range(WARMUP):
        img = render(arrays, camera)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    e0.record()
    for _ in range(FRAMES):
        img = render(arrays, camera)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / FRAMES
    frame_ms = e0.elapsed_time(e1) / FRAMES
    launches = {"coarse_kernel": cp.coarse.launches, "fine_kernel": cp.fine.launches}
    log(f"main path {WIDTH}x{HEIGHT} x{cfg.aa_samples ** 2} AA: {frame_ms:.4f} ms/frame "
        f"(CUDA events, {FRAMES} frames after {WARMUP} warm-up; host clock {host_ms:.4f} ms), "
        f"{n_rays / (frame_ms * 1e-3) / 1e9:.4f} Grays/s on {smi}")
    log(f"launches in the main-path run: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    if img.shape != (HEIGHT, WIDTH, 3) or img.dtype != torch.float32 or img.device != dev:
        raise AssertionError(f"bad frame {tuple(img.shape)} {img.dtype} {img.device}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite pixels in the frame")
    r, g, b = img.unbind(-1)
    geometry = float(((g > r) & (g > b)).float().mean())  # albedo (0.4, 0.7, 0.1)
    floor = float((b > g).float().mean())  # checker base (0.1, 0.1, 0.2)
    log(f"frame: geometry px {geometry:.4f}, floor px {floor:.4f}, mean {float(img.mean()):.6f}")
    if geometry < 0.01 or floor < 0.01:
        raise AssertionError("the frame lacks geometry or floor pixels")

    # Kernel times alone, and the plain versions on the card, at full size.
    sc, cam, bound = render.renderer.scene_args(arrays, rt.cam_vec(camera, device=dev))
    p = render.renderer.params
    pre_k = cp.coarse(sc, cam, bound, p)
    coarse_ms = cuda_ms(lambda: cp.coarse(sc, cam, bound, p), KERNEL_REPS)
    fine_ms = cuda_ms(lambda: cp.fine(sc, cam, bound, p, *pre_k), KERNEL_REPS)
    log(f"card after the headline kernels (sm, max sm, mem, max mem clocks; temperature; power): {card_clocks()}")
    work_c = cp.WorkCount()
    pre_p = cp.coarse_plain(sc, cam, bound, p, work=work_c)
    coarse_plain_ms = cuda_ms(lambda: cp.coarse_plain(sc, cam, bound, p), 1)
    coarse_err = coarse_agreement("full-size coarse kernel vs coarse_plain", pre_k, pre_p, strict=False)
    img_fk = cp.fine(sc, cam, bound, p, *pre_k)
    torch.cuda.synchronize()
    e0.record()
    work_f = cp.WorkCount()
    img_fp = cp.fine_plain(sc, cam, bound, p, *pre_k, work=work_f)
    e1.record()
    torch.cuda.synchronize()
    fine_plain_ms = e0.elapsed_time(e1)
    fine_err = image_class("full-size fine kernel vs fine_plain (same planes)", img_fk, img_fp)
    del img_fp
    e0.record()
    img_plain = render.renderer.render_plain(arrays, rt.cam_vec(camera, device=dev))
    e1.record()
    torch.cuda.synchronize()
    plain_frame_ms = e0.elapsed_time(e1)
    n_px = WIDTH * HEIGHT
    coarse_bound = roofline(march_flops(work_c, n_px, spec, False), n_px * 8)
    fine_bound = roofline(march_flops(work_f, n_rays, spec, False, float(work_f.hits), fine=True), n_px * 20)
    log(f"counted work: coarse {float(work_c.points):.6e} points, {float(work_c.leaf_evals):.6e} leaf "
        f"evaluations; fine {float(work_f.points):.6e} points, {float(work_f.leaf_evals):.6e} leaf "
        f"evaluations, {float(work_f.hits):.0f} hit rays; bounds coarse {coarse_bound[0]:.4f} ms, "
        f"fine {fine_bound[0]:.4f} ms ({fine_bound[1]})")
    log(f"kernels alone: coarse {coarse_ms:.4f} ms, fine {fine_ms:.4f} ms; plain on the card: "
        f"coarse_plain {coarse_plain_ms:.2f} ms, fine_plain {fine_plain_ms:.2f} ms, "
        f"plain frame {plain_frame_ms:.2f} ms vs kernel frame {frame_ms:.4f} ms ({smi})")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    image_class("full-size frame: kernel path vs plain path", img, img_plain)
    del img_plain

    # -- 5. runtime edit: new numbers, same spec, no rebuild -------------------
    spec2, arrays2 = rt.compile_scene(scene.translate((0.3, 0.0, 0.0)), static=True)
    if spec2 != spec:
        raise AssertionError("a numeric edit changed the TapeSpec")
    misses = cp._cached_renderer.cache_info().misses
    builds = _build.stats["builds"]
    render2 = rt.make_renderer(
        spec2, WIDTH, HEIGHT, cfg, mode="forward", backend="pallas_prepass", device=dev
    )
    img2 = render2(arrays2, camera)
    torch.cuda.synchronize()
    moved = float((img2 - img).abs().max())
    same = render2 is render and cp._cached_renderer.cache_info().misses == misses
    log(f"runtime edit: same renderer={same}, builds {builds}->{_build.stats['builds']}, "
        f"max|d| vs first frame={moved:.3f}")
    if not same or _build.stats["builds"] != builds or not moved > 0.1:
        raise AssertionError("the runtime edit rebuilt something or changed nothing")

    del img2

    # -- 7. the training path at full size: fwd + bwd -------------------------
    cv_main = rt.cam_vec(camera, device=dev)
    render_f = rt.make_renderer(
        spec, WIDTH, HEIGHT, cfg, mode="implicit", backend="pallas_fused", device=dev
    )
    lp0 = torch.tensor(arrays.leaf_params, device=dev)
    op0 = torch.tensor(arrays.op_param, device=dev)

    def fwd_bwd():
        lp = lp0.clone().requires_grad_(True)
        opp = op0.clone().requires_grad_(True)
        cv = cv_main.clone().requires_grad_(True)
        img_f = render_f.renderer(dataclasses.replace(arrays, leaf_params=lp, op_param=opp), cv)
        loss = torch.mean(img_f * img_f)
        loss.backward()
        return img_f, loss, (lp.grad, opp.grad, cv.grad)

    cp.reset_launch_counts()
    cg.reset_launch_counts()
    for _ in range(BWD_WARMUP):
        fwd_bwd()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    e0.record()
    for _ in range(BWD_STEPS):
        img_f, loss_f, grads_f = fwd_bwd()
    e1.record()
    torch.cuda.synchronize()
    fb_host_ms = (time.perf_counter() - h0) * 1e3 / BWD_STEPS
    fb_ms = e0.elapsed_time(e1) / BWD_STEPS
    launches_f = {"coarse_kernel": cp.coarse.launches, "fine_kernel": cp.fine.launches,
                  "fine_kernel_residuals": cp.fine_res.launches, "fused_bwd_kernel": cg.bwd.launches}
    log(f"training path {WIDTH}x{HEIGHT} x{cfg.aa_samples ** 2} AA, fwd+bwd of mean(img^2): "
        f"{fb_ms:.4f} ms/step (CUDA events, {BWD_STEPS} steps after {BWD_WARMUP} warm-up; host clock "
        f"{fb_host_ms:.4f} ms), {n_rays / (fb_ms * 1e-3) / 1e9:.4f} Grays/s on {smi}")
    log(f"launches in the training-path run: {launches_f}")
    if min(launches_f[k] for k in ("coarse_kernel", "fine_kernel_residuals", "fused_bwd_kernel")) <= 0:
        raise AssertionError(f"a kernel of the training path never launched: {launches_f}")
    if not all(bool(torch.isfinite(g).all()) for g in grads_f) or float(grads_f[0].abs().max()) <= 0:
        raise AssertionError("the training path's gradients are not finite or all zero")
    image_class("training-path image vs forward main-path image", img_f.detach(), img)
    log(f"training-path loss {float(loss_f.detach()):.6f}, max|d_lp| {float(grads_f[0].abs().max()):.4e}, "
        f"d_cam {[round(float(v), 4) for v in grads_f[2]]}")

    # The kernels of the training path alone, and the plain backward once.
    fr = render_f.renderer
    sc, cam, bound = fr.prepass.scene_args(arrays, cv_main)
    pre_k = cp.coarse(sc, cam, bound, fr.params)
    fine_res_ms = cuda_ms(lambda: cp.fine_res(sc, cam, bound, fr.params, *pre_k), KERNEL_REPS)
    img_r, t_k, hit_k = cp.fine_res(sc, cam, bound, fr.params, *pre_k)
    g_img = 2.0 * img_r / img_r.numel()  # the cotangent of mean(img^2)
    bwd_ms = cuda_ms(lambda: cg.bwd(sc, cam, fr.params, fr.layout, t_k, hit_k, g_img), KERNEL_REPS)
    got = cg.bwd(sc, cam, fr.params, fr.layout, t_k, hit_k, g_img)
    torch.cuda.synchronize()
    e0.record()
    work_r = cp.WorkCount()
    img_rp, t_p, hit_p = cp.fine_res_plain(sc, cam, bound, fr.params, *pre_k, work=work_r)
    e1.record()
    torch.cuda.synchronize()
    fine_res_plain_ms = e0.elapsed_time(e1)
    res_err = image_class("full-size fine kernel with residuals vs fine_res_plain", img_r, img_rp)
    residual_agreement("full-size residuals kernel vs fine_res_plain", (t_k, hit_k), (t_p, hit_p), strict=False)
    del img_rp, t_p, hit_p
    torch.cuda.reset_peak_memory_stats()
    e0.record()
    ref = cg.bwd_plain(sc, cam, fr.params, fr.layout, t_k, hit_k, g_img)
    e1.record()
    torch.cuda.synchronize()
    bwd_plain_ms = e0.elapsed_time(e1)
    bwd_plain_gib = torch.cuda.max_memory_allocated() / 2**30
    bwd_err = grad_class("full-size fused_bwd kernel vs bwd_plain", got, ref)
    grad_class("training-path gradients vs bwd_plain", (grads_f[0], grads_f[1], grads_f[2]), ref)
    hit_share = float(hit_k.mean())
    res_bound = roofline(march_flops(work_r, n_rays, spec, False, float(work_r.hits), fine=True),
                      n_px * 20 + n_rays * 8)
    *bwd_bound, k8_flops, _, k8_reach = k8_bound(sc, fr.params, cam, t_k, hit_k, fr.layout, n_rays)
    log(f"kernels alone: fine with residuals {fine_res_ms:.4f} ms, fused_bwd {bwd_ms:.4f} ms "
        f"({hit_share:.4f} of the {n_rays} AA rays hit); plain on the card: fine_res_plain "
        f"{fine_res_plain_ms:.2f} ms, bwd_plain {bwd_plain_ms:.2f} ms in {cg.PLAIN_BAND_ROWS}-row bands "
        f"(peak {bwd_plain_gib:.2f} GiB) ({smi}); bounds fine with residuals {res_bound[0]:.4f} ms "
        f"({res_bound[1]}), fused_bwd {bwd_bound[0]:.4f} ms ({bwd_bound[1]}, {k8_flops:.6e} operations, "
        f"{k8_reach:.4f} leaves reached per hit point)")
    log(f"  K1/K2 stack route of these times: {stack_of(sc)}")
    del t_k, hit_k, ref

    # -- 8. fits: the headline at full size, BASELINE config 3 at 48x48 ------
    truth = arrays.leaf_params
    start = truth.copy()
    start[0, 4] -= 0.12  # the sphere's centre x
    m_leaf = np.zeros_like(truth)
    m_leaf[0, 4] = 1.0
    target = rt.make_renderer(
        spec, WIDTH, HEIGHT, cfg, mode="forward", backend="pallas_prepass", device=dev
    )(arrays, camera)
    fit_kw = dict(width=WIDTH, height=HEIGHT, cfg=cfg, learning_rate=1e-2, leaf_mask=m_leaf,
                  backend="pallas_fused", device=dev)
    # One step first, so that the timed fit leaves out one-time set-up (the
    # optimizer's first launches load their CUDA modules).
    rt.fit_scene(spec, dataclasses.replace(arrays, leaf_params=start), camera, target, steps=1, **fit_kw)
    fit_log = []
    res = rt.fit_scene(
        spec, dataclasses.replace(arrays, leaf_params=start), camera, target,
        steps=FIT_STEPS, log_every=1, log_fn=fit_log.append, **fit_kw,
    )
    cx = float(res.arrays.leaf_params[0, 4])
    for line in fit_log:
        log(f"  {line}")
    log(f"full-size fit ({FIT_STEPS} Adam steps, lr 1e-2): loss {res.losses[0]:.6e} -> "
        f"{res.losses[-1]:.6e}; sphere cx {start[0, 4]:+.4f} -> {cx:+.4f} (truth {truth[0, 4]:+.4f}); "
        f"{1.0 / res.steps_per_sec:.4f} s/step; backward {res.backward_info} ({smi})")
    if not (res.losses[-1] < res.losses[0] and abs(cx - truth[0, 4]) < abs(start[0, 4] - truth[0, 4])):
        raise AssertionError("the full-size fit did not move toward the truth")

    cfg3 = rt.RenderConfig(aa_samples=2, max_iter=48)
    scene3 = rt.sphere(center=(-0.5, 0, 0)).union(rt.sphere(center=(0.5, 0, 0)), k=0.4)
    cam3 = rt.Camera.looking_at(position=(0.0, 0.6, 3.5), target=(0, 0, 0))
    spec3, arrays3 = rt.compile_scene(scene3, static=True)
    target3 = rt.make_renderer(spec3, 48, 48, cfg3, mode="forward", backend="pallas_prepass", device=dev)(arrays3, cam3)
    lp3 = arrays3.leaf_params.copy()
    lp3[0, 4] -= 0.12
    op3 = arrays3.op_param.copy()
    ki = int(np.nonzero(op3)[0][0])
    op3[ki] = 0.15
    m3_leaf = np.zeros_like(lp3)
    m3_leaf[0, 4] = 1.0
    m3_op = np.zeros_like(op3)
    m3_op[ki] = 1.0
    res3 = rt.fit_scene(
        spec3, dataclasses.replace(arrays3, leaf_params=lp3, op_param=op3), cam3, target3,
        width=48, height=48, cfg=cfg3, steps=60, learning_rate=1e-2,
        leaf_mask=m3_leaf, op_mask=m3_op, backend="pallas_fused", device=dev,
    )
    cx3 = float(res3.arrays.leaf_params[0, 4])
    k3 = float(res3.arrays.op_param[ki])
    log(f"config 3 fit (48x48, 60 steps): cx {lp3[0, 4]:+.4f} -> {cx3:+.4f} (truth "
        f"{arrays3.leaf_params[0, 4]:+.4f}); k {op3[ki]:.4f} -> {k3:.4f} (truth "
        f"{arrays3.op_param[ki]:.4f}); loss {res3.losses[0]:.6e} -> {res3.losses[-1]:.6e}; "
        f"{res3.steps_per_sec:.2f} steps/s")
    if not (res3.losses[-1] < res3.losses[0]
            and abs(cx3 - arrays3.leaf_params[0, 4]) < abs(lp3[0, 4] - arrays3.leaf_params[0, 4])
            and abs(k3 - arrays3.op_param[ki]) < abs(op3[ki] - arrays3.op_param[ki])):
        raise AssertionError("the config 3 fit did not move toward the truth")

    # -- 9. many-primitive training ---------------------------------------
    culled_records, s64 = many_leaf(rt, cp, cg, dev, smi, cfg, (0.0, 2.6, 4.2))

    # -- 10. blends, subtractions and painted materials ----------------------
    blend_records, sb = blends(rt, cp, cg, dev, smi, cfg, (0.0, 2.6, 4.2))

    # -- 11. the many-primitive forward rows of bench.py ----------------------
    row_records, rows = forward_rows(rt, cp, dev, smi, cfg, (0.0, 2.6, 4.2))

    # -- 12. the legacy backward of every static scene ------------------------
    legacy_records, sl = legacy(rt, cp, cg, dev, smi, cfg)

    # -- 13. soft coverage ---------------------------------------------------
    soft_records, ss = soft(rt, cp, cg, dev, smi, cfg)

    # -- 14. the render surfaces ---------------------------------------------
    surface_records, su = surfaces(rt, cp, dev, smi, cfg, (0.0, 2.6, 4.2))

    # -- 15. live editing ----------------------------------------------------
    live_records, sv = live(rt, cp, cg, dev, smi, cfg, (0.0, 2.6, 4.2))

    # -- 16. the repaired render options, the scenes past the shared row ----
    repair_records, sr = repairs(rt, cp, cg, dev, smi, cfg)

    # -- 17. the headline path against the port's f64 oracle -----------------
    oracle_phase(rt, cp, dev, smi)

    # -- 18. multi-device: the row-sharded renderer and fit step --------------
    shard_records, sm = multi_device(rt, cp, cg, dev, smi, cfg, (0.0, 2.6, 4.2))

    # -- 19. the five BASELINE configs ----------------------------------------
    sc5 = baseline_configs(rt, cp, cg, dev, smi)

    log(f"card: {smi}")
    kernels = [
        dict(name="coarse_kernel", route="cuda", source="raymarch_tpu_torch/csrc/prepass.cu",
             replaces="raymarch_tpu/ops/pallas_prepass.py:885",
             launches=launches["coarse_kernel"], max_abs_err=coarse_err,
             ms=coarse_ms, plain_ms=coarse_plain_ms, bound_ms=coarse_bound[0],
             bound_by=coarse_bound[1], library_ms=None),
        dict(name="fine_kernel", route="cuda", source="raymarch_tpu_torch/csrc/prepass.cu",
             replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
             launches=launches["fine_kernel"], max_abs_err=fine_err,
             ms=fine_ms, plain_ms=fine_plain_ms, bound_ms=fine_bound[0],
             bound_by=fine_bound[1], library_ms=None),
        dict(name="fine_kernel (residuals t, hit)", route="cuda",
             source="raymarch_tpu_torch/csrc/prepass.cu",
             replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
             launches=launches_f["fine_kernel_residuals"], max_abs_err=res_err,
             ms=fine_res_ms, plain_ms=fine_res_plain_ms, bound_ms=res_bound[0],
             bound_by=res_bound[1], library_ms=None),
        dict(name="fused_bwd_kernel", route="cuda", source="raymarch_tpu_torch/csrc/fused_bwd.cu",
             replaces="raymarch_tpu/ops/pallas_grad.py:1432",
             launches=launches_f["fused_bwd_kernel"], max_abs_err=bwd_err,
             ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None),
        *culled_records,
        *blend_records,
        *row_records,
        *legacy_records,
        *soft_records,
        *surface_records,
        *live_records,
        *repair_records,
        *shard_records,
    ]
    log(f"64-leaf summary: step {s64['step_ms']:.4f} ms, forward frame {s64['fwd64_ms']:.4f} ms, idle share "
        f"{s64['idle']}, masks and lists {s64['cull_ms']:.4f} ms in {s64['n_cull']} device operations "
        f"({s64['n_ksum']} in the pairwise path loop) ({smi})")
    for name, s in sb["steps"].items():
        log(f"{name} summary: step {s['step_ms']:.4f} ms, compact_bwd {s['cbwd_ms']:.4f} ms, idle share "
            f"{s['idle']}, masks and lists {s['cull_ms']:.4f} ms in {s['n_cull']} device operations ({smi})")
    log(f"painted forward frame {sb['fwd_p_ms']:.4f} ms; cluster fit {sb['fit_s']:.4f} s/step ({smi})")
    for row, r in rows.items():
        if row == "chain":
            log(f"chained prepass frame {r['frame_ms']:.4f} ms, K3 {r['k3_ms']:.4f} ms (device time "
                f"{ms_text(r['k3_dev'])}); "
                f"K3 on 64 spheres (depth 8) static {r['k3_deep']['static']:.4f} ms, DYN {r['k3_deep']['DYN']:.4f} ms "
                f"({smi})")
            continue
        log(f"{row} summary: frame {r['frame_ms']:.4f} ms, {r['grays']:.4f} Grays/s, idle share {r['idle']}, "
            f"cull_args {r['cull_ms']:.4f} ms, coarse {r['coarse_ms']:.4f} ms, fine {r['fine_ms']:.4f} ms ({smi})")
    for name, r in sl["steps"].items():
        log(f"legacy path ({name}) summary: step {r['step_ms']:.4f} ms, {r['kname']} {r['k8_ms']:.4f} ms "
            f"({r['launches']} launches; bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms) ({smi})")
    log(f"albedo fit {sl['fit_s']:.4f} s/step; aa = 8 frame {sl['frame8_ms']:.4f} ms, fine kernel "
        f"{sl['fine8_ms']:.4f} ms ({smi})")
    for row, r in ss["rows"].items():
        log(f"{row} summary: step {r['step_ms']:.4f} ms, soft fine kernel {r['k2_ms']:.4f} ms (bound "
            f"{r['k2_bound']:.4f}, plain {r['k2_plain_ms']:.2f} ms), {r['kname']} soft {r['bwd_ms']:.4f} ms (bound "
            f"{r['bwd_bound']:.4f}, plain {r['bwd_plain_ms']:.2f} ms on {r['where']}), launches {r['launches']}, "
            f"idle share {r['idle']} ({smi})")
    log(f"soft pose fit {ss['fit_s']:.4f} s/step ({smi})")
    for row in ("march_only_static", "march_only_dynamic", "march_only_fast", "pallas_full_static",
                "pallas_full_dynamic", "pallas_forward", "jnp_forward", "fwdbwd_jnp"):
        r = su[row]
        log(f"{row} summary: {r['ms']:.4f} ms, launches {r['launches']}" +
            (f", kernel alone {r['kernel_ms']:.4f} ms" if "kernel_ms" in r else "") +
            (f", K7 per AA ray: frame {r['per_ray_frame_ms']:.4f} ms, alone {r['per_ray_ms']:.4f} ms"
             if "per_ray_ms" in r else "") +
            (f", {r['stats']}" if "stats" in r else "") + (f", peak {r['peak']:.2f} GiB" if "peak" in r else "") +
            f" ({smi})")
    d = sv["dynamic"]
    log(f"live editing summary: dynamic_tape_prepass {d['ms'][0]:.4f} / {d['ms'][1]:.4f} ms against the static "
        f"headline {d['static_ms'][0]:.4f} / {d['static_ms'][1]:.4f} ms; DYN coarse {d['kernels']['coarse DYN']:.4f} "
        f"ms, fine {d['kernels']['fine DYN']:.4f} ms; shared-normals frame {sv['shared']['ms']:.4f} ms (K4 "
        f"{sv['shared']['k4_ms']:.4f} ms); aa = 3 step {sv['aa3_step']['ms']:.4f} ms (K4 with residuals "
        f"{sv['aa3_step']['k4_ms']:.4f} ms); tiered: edit -> first frame {sv['tiered']['first_ms']:.2f} ms, static "
        f"tier {sv['tiered']['static_s']:.3f} s, frames dynamic {sv['tiered']['dyn_ms']:.2f} / static "
        f"{sv['tiered']['static_ms']:.2f} / render() {sv['tiered']['render_ms']:.2f} ms; viewer /edit {sv['viewer']['edit_ms']:.2f} ms, frame.png "
        f"{sv['viewer']['png_ms']:.2f} ms; phase {sv['seconds']:.1f} s ({smi})")
    log(f"repairs summary: chained dynamic frame {sr['chain_dynamic']['ms']:.4f} ms (DYN K3 "
        f"{sr['chain_dynamic']['k3_ms']:.4f} ms), dynamic march_only_fast {sr['march_fast_dynamic']['ms']:.4f} ms "
        f"(DYN march-only build {sr['march_fast_dynamic']['kernel_ms']:.4f} ms), dynamic soft frame "
        f"{sr['soft_dynamic']['ms']:.4f} ms (DYN soft build {sr['soft_dynamic']['kernel_ms']:.4f} ms), ni = 6 frame "
        f"{sr['ni6']['ms']:.4f} ms (coarse {sr['ni6']['coarse_ms']:.4f}, fine {sr['ni6']['fine_ms']:.4f} ms); "
        f"K9 {BIG_POOL}-sphere pool {sr['compact_bwd_kernel']['ms']:.4f} ms, K8 {BIG_TAPE}-leaf tape "
        f"{sr['fused_bwd_kernel']['ms']:.4f} ms at the gate; phase {sr['seconds']:.1f} s ({smi})")
    log(f"multi-device summary: sharded frame ({SHARD_K} bands, 1 rank, NCCL) {sm['frame_ms'][0]:.4f} / "
        f"{sm['frame_ms'][1]:.4f} ms against the single frame {sm['frame_1_ms'][0]:.4f} / {sm['frame_1_ms'][1]:.4f}; "
        f"fit step {sm['step_ms'][0]:.4f} / {sm['step_ms'][1]:.4f} ms against {sm['step_1_ms'][0]:.4f} / "
        f"{sm['step_1_ms'][1]:.4f}; 64-sphere step {sm['step64_ms'][1]:.4f} ms against {sm['step64_ms'][0]:.4f}, "
        f"cull_args {sum(sm['cull_ms']):.4f} ms over {SHARD_K} bands against {sm['cull_1']:.4f}; phase "
        f"{sm['seconds']:.1f} s ({smi})")
    log("BASELINE configs summary: " + "; ".join(
        f"config {k} {' / '.join(f'{v:.4f}' for v in sc5[k]['seconds'])} s" for k in "12345")
        + f"; config 3 {sc5['3']['step_s']:.5f} s/step; phase {sc5['seconds']:.1f} s ({smi})")
    log(f"chip_smoke total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        import argparse

        ap = argparse.ArgumentParser(description="one rank of chip_smoke.py's phase 18c")
        for flag, kind in (("--rank", int), ("--world", int), ("--port", int), ("--out", str), ("--device", str)):
            ap.add_argument(flag, type=kind, required=True)
        ap.add_argument("--mesh", type=int, default=0, help="ranks 0..M-1 form the mesh (default: the world)")
        a = ap.parse_args()
        sys.exit(rank_main(a.rank, a.world, a.port, a.out, a.device, a.mesh))
    sys.exit(main())
