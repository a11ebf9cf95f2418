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
10. prints one JSON line of per-kernel records (time, plain time, launches,
   the roofline bound from this run's counted work) for the headline builds
   and the culled builds of the 64-leaf path, then, last,
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
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
DEVICE = "cuda"
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


def scene_cost(spec):
    """(pushed leaves, mean ops of one leaf evaluation, ops of the combine
    instructions of one tape evaluation) of a static spec."""
    rows = {}
    for t, start, stop in spec.type_slices:
        for r in range(start, stop):
            rows[r] = LEAF_OPS[t] + (ROT_OPS if spec.rotated_types[t] else 0)
    pushed = [a for c, a, _ in spec.static_tape if c == 1]
    comb = sum(COMBINE_OPS.get(c, 0) for c, _, _ in spec.static_tape if c != 1)
    return len(pushed), sum(rows[a] for a in pushed) / max(len(pushed), 1), comb


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


def coarse_agreement(name, k, p, strict):
    """Coarse planes of kernel vs plain: status agrees on >= 99.9% of pixels,
    and t0 agrees within rtol 1e-4 where both statuses are 1 — at every such
    pixel when `strict`, else at all but 0.1% of them (a centre ray whose
    slack lands within rounding of min_dist takes one step of ~min_dist more
    or less in one of the two). Returns max |t0 diff| there."""
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
    log(f"{name}: status agree={agree:.6f} (need >=0.999) t0 max rel={rel_max:.3e} "
        f"share rel>1e-4={off:.3e} max|d|={mx:.3e} over {n} px (need {need}) "
        f"{'PASS' if ok else 'FAIL'}")
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


def device_idle_share(fn, steps):
    """Share of the wall time of `steps` synchronised runs of `fn` in which
    the card ran no kernel (torch.profiler's device events, intervals
    merged), or None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - h0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    return max(0.0, 1.0 - busy / wall_us)


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
    idle = device_idle_share(fwd_bwd, 3)
    log(f"64-leaf step device idle share (torch.profiler, 3 steps): "
        f"{'not measured (no device events)' if idle is None else f'{idle:.4f}'} ({smi})")

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
    hit_tiles = cp.leaves_per_point(sc, fc, fc.tile_index(
        torch.arange(HEIGHT, device=dev)[:, None, None], torch.arange(WIDTH, device=dev)[None, :, None]))
    pool_items = float((hit_k * hit_tiles).sum())  # leaves in the tiles of the hit rays
    n_hits = float(hit_k.sum())
    _, leaf_ops, _ = scene_cost(spec64)
    list_bytes = 4 * (fc.lists.numel() + fc.counts.numel())
    # The 5 list folds of each hit ray, then 5 winner-leaf adjoints; hit
    # read for every ray, t for the hit rays, the cotangent of their pixels.
    cbwd_flops = 5 * pool_items * (leaf_ops + 2) + n_hits * (5 * ADJ_FACTOR * leaf_ops + ADJ_RAY_OPS)
    cbwd_bytes = (n_rays * 4 + n_hits * 4 + hit_pixels(hit_k) * 12 + list_bytes
                  + 4 * (16 * spec64.n_leaves + spec64.n_instr + 7))
    cbwd_bound = roofline(cbwd_flops, cbwd_bytes)
    coarse_bound = roofline(march_flops(work_c, n_px, spec64, True), n_px * 8 + 4 * (cc.lists.numel() + cc.counts.numel()))
    fine_bound = roofline(march_flops(work_f, n_rays, spec64, True, float(work_f.hits), fine=True),
                       n_px * 20 + n_rays * 8 + list_bytes)
    log(f"64-leaf counted work: coarse {float(work_c.leaf_evals):.6e} leaf evaluations, fine "
        f"{float(work_f.leaf_evals):.6e}, compact_bwd {pool_items:.6e} list leaves at 5 points of "
        f"{n_hits:.0f} hit rays ({cbwd_flops:.6e} operations, {cbwd_bytes:.6e} bytes); bounds coarse "
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
             source="raymarch_tpu_torch/csrc/prepass.cu", replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
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


def main() -> int:
    import torch

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
        f"{_build.stats['builds']} compile(s) -> {_build.stats['path']}")
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
    n_hits = float(hit_k.sum())
    res_bound = roofline(march_flops(work_r, n_rays, spec, False, float(work_r.hits), fine=True),
                      n_px * 20 + n_rays * 8)
    n_push, leaf_ops, comb = scene_cost(spec)
    tape_ops = n_push * leaf_ops + comb
    # Per hit ray: the tape at 5 points, the reverse of those 5 evaluations
    # (ADJ_FACTOR x the leaf work, ~4 ops per instruction), the ray's
    # adjoint; hit read for every ray, t for the hit rays, the cotangent of
    # their pixels.
    k8_flops = n_hits * (5 * tape_ops + 5 * (ADJ_FACTOR * n_push * leaf_ops + 4 * len(spec.static_tape))
                         + ADJ_RAY_OPS)
    bwd_bound = roofline(k8_flops, n_rays * 4 + n_hits * 4 + hit_pixels(hit_k) * 12 + fr.layout.nscal * 4)
    log(f"kernels alone: fine with residuals {fine_res_ms:.4f} ms, fused_bwd {bwd_ms:.4f} ms "
        f"({hit_share:.4f} of the {n_rays} AA rays hit); plain on the card: fine_res_plain "
        f"{fine_res_plain_ms:.2f} ms, bwd_plain {bwd_plain_ms:.2f} ms in {cg.PLAIN_BAND_ROWS}-row bands "
        f"(peak {bwd_plain_gib:.2f} GiB) ({smi}); bounds fine with residuals {res_bound[0]:.4f} ms "
        f"({res_bound[1]}), fused_bwd {bwd_bound[0]:.4f} ms ({bwd_bound[1]}, {k8_flops:.6e} operations)")
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
    ]
    log(f"64-leaf summary: step {s64['step_ms']:.4f} ms, forward frame {s64['fwd64_ms']:.4f} ms, idle share "
        f"{s64['idle']}, masks and lists {s64['cull_ms']:.4f} ms in {s64['n_cull']} device operations "
        f"({s64['n_ksum']} in the pairwise path loop) ({smi})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
