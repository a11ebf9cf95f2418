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
6. prints one JSON line of per-kernel records, then, last,
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
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def scene_config2(m):
    """BASELINE config 2 (bench.py:93-100): (sphere | box) - torus."""
    return (
        m.sphere(center=(-0.6, 0.0, 0.0), radius=0.9)
        | m.box(center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5))
    ) - m.torus(center=(0.0, 0.8, 0.0), major_radius=0.7, minor_radius=0.25)


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

    import raymarch_tpu_torch as rt
    from raymarch_tpu_torch import _build
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
