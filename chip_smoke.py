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
9. prints one JSON line of per-kernel records, then, last,
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
    pre_p = cp.coarse_plain(sc, cam, bound, p)
    coarse_plain_ms = cuda_ms(lambda: cp.coarse_plain(sc, cam, bound, p), 1)
    coarse_err = coarse_agreement("full-size coarse kernel vs coarse_plain", pre_k, pre_p, strict=False)
    img_fk = cp.fine(sc, cam, bound, p, *pre_k)
    torch.cuda.synchronize()
    e0.record()
    img_fp = cp.fine_plain(sc, cam, bound, p, *pre_k)
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
    img_rp, t_p, hit_p = cp.fine_res_plain(sc, cam, bound, fr.params, *pre_k)
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
    log(f"kernels alone: fine with residuals {fine_res_ms:.4f} ms, fused_bwd {bwd_ms:.4f} ms "
        f"({hit_share:.4f} of the {n_rays} AA rays hit); plain on the card: fine_res_plain "
        f"{fine_res_plain_ms:.2f} ms, bwd_plain {bwd_plain_ms:.2f} ms in {cg.PLAIN_BAND_ROWS}-row bands "
        f"(peak {bwd_plain_gib:.2f} GiB) ({smi})")
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

    log(f"card: {smi}")
    kernels = [
        dict(name="coarse_kernel", route="cuda", source="raymarch_tpu_torch/csrc/prepass.cu",
             replaces="raymarch_tpu/ops/pallas_prepass.py:885",
             launches=launches["coarse_kernel"], max_abs_err=coarse_err,
             ms=coarse_ms, plain_ms=coarse_plain_ms),
        dict(name="fine_kernel", route="cuda", source="raymarch_tpu_torch/csrc/prepass.cu",
             replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
             launches=launches["fine_kernel"], max_abs_err=fine_err,
             ms=fine_ms, plain_ms=fine_plain_ms),
        dict(name="fine_kernel (residuals t, hit)", route="cuda",
             source="raymarch_tpu_torch/csrc/prepass.cu",
             replaces="raymarch_tpu/ops/pallas_prepass.py:1521",
             launches=launches_f["fine_kernel_residuals"], max_abs_err=res_err,
             ms=fine_res_ms, plain_ms=fine_res_plain_ms),
        dict(name="fused_bwd_kernel", route="cuda", source="raymarch_tpu_torch/csrc/fused_bwd.cu",
             replaces="raymarch_tpu/ops/pallas_grad.py:1432",
             launches=launches_f["fused_bwd_kernel"], max_abs_err=bwd_err,
             ms=bwd_ms, plain_ms=bwd_plain_ms),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
