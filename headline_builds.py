#!/usr/bin/env python3
"""Times the headline kernels and the flat march kernels, and reports every
kernel build's ptxas line.

Run from a repository root on one CUDA card: `python3 headline_builds.py`.
It builds the kernels, then at 1920x1080 with 16 AA rays per pixel on
BASELINE config 2 under the headline camera times (CUDA events, 20 runs
after one warm-up; the step 10) the frame through
`make_renderer(backend="pallas_prepass")`, the coarse kernel, the fine
kernel, the fine kernel with residuals, the legacy backward K8 and the
fwd+bwd step through `make_renderer(backend="pallas_fused")`. Then the
flat march kernels (30 runs after one warm-up, on prepared arguments):
K5 on the frame's 33 M `raygen_flat` rays; K6, K7 per AA ray and K7's
pixel build (the AA mean inside the kernel; "n/a" in a tree without it)
on config 2's static and dynamic tapes, 64 spheres (stack depth 8) and
16 painted spheres under the camera (0, 2.5, 9); K6, K7 and the pixel
build at max_iter 0 (raygen, the bound clip, shading of misses and the
stores: the per-ray floor); the `march_only` frame
(`make_pallas_image_march`) and the `pallas_full` frame
(`make_renderer(backend="pallas_full")`) on both tapes; and the
torch.profiler device time of the static `pallas_full` frame split by
operation. It prints one JSON object: the card, those times and, per
kernel build, ptxas's register / stack / spill line. To compare two trees,
unpack the other under `build/` and run the script from each root in one
call (parent, change, change, parent), each output to a file, then

    python3 headline_builds.py --compare PARENT.json CHANGE.json

counts the builds whose ptxas line is the same in both and lists the
others, the flat march builds apart, then lists each tree's coarse and
fine kernel builds that keep a stack frame and each tree's flat march
builds with their stack frames. A `fine_kernel` build without the
march-only flag is keyed as one with it false, so that adding the flag
renames no build; its stack route (`STK`: 2 a register, 0 shared memory)
is a sixth key where the build has one, as is the coarse kernel's third
and the flat march kernel's sixth (`march_kernel<SRC, OUT, DYN, RELAX,
MATS, STK>`).
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time

FRAMES, STEPS = 20, 10
FLAT_REPS = 30  # runs of each flat march time
SPLIT_FRAMES = 10  # frames of the profiled pallas_full frame


def ptxas_lines(report: str) -> dict:
    """{kernel build: "Used N registers, ..."} from ptxas -v's report."""
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            k = re.search(r"fine_kernelILi(\d)ELb(\d)ELb(\d)ELi(\d)(?:ELb(\d))?(?:ELi(\d+))?E", entry)
            c = re.search(r"coarse_kernelILi(\d)ELi(\d)(?:ELi(\d+))?E", entry)
            m5 = re.search(r"march_kernelILi(\d)ELi(\d)ELb(\d)ELb(\d)ELb(\d)(?:ELi(\d+))?E", entry)
            if m5:
                stk = "" if m5.group(6) is None else f", {m5.group(6)}"
                entry = "march_kernel<{}, {}, {}, {}, {}{}>".format(*m5.group(1, 2, 3, 4, 5), stk)
            elif k:
                stk = "" if k.group(6) is None else f", {k.group(6)}"
                entry = "fine_kernel<{}, {}, {}, {}, {}{}>".format(*k.group(1, 2, 3, 4), k.group(5) or "0", stk)
            elif c:
                entry = "coarse_kernel<{}, {}{}>".format(*c.group(1, 2), "" if c.group(3) is None else f", {c.group(3)}")
            continue
        m = re.search(r"Used \d+ registers.*", line)
        if m and entry:
            out[entry] = m.group(0).strip()
            entry = None
    return out


def stack_bytes(line: str) -> int:
    """The stack a ptxas line reports (cumulative stack size or stack frame)."""
    m = re.search(r"(\d+) bytes (?:cumulative stack size|stack frame)", line)
    return int(m.group(1)) if m else 0


def compare(a_path: str, b_path: str) -> int:
    a, b = (json.loads(open(p).read().strip().splitlines()[-1]) for p in (a_path, b_path))
    flat = lambda k: k.startswith("march_kernel<")  # noqa: E731
    same = [k for k in a["ptxas"] if b["ptxas"].get(k) == a["ptxas"][k]]
    print(f"{len(same)} of {len(a['ptxas'])} builds of {a_path} have the same ptxas line in {b_path} "
          f"({len(b['ptxas'])} builds there)")
    rest = [k for k in a["ptxas"] if not flat(k)]
    rest_same = [k for k in rest if k in same]
    print(f"  builds other than the flat march kernels: {len(rest_same)} of {len(rest)} the same "
          f"({sum(1 for k in b['ptxas'] if not flat(k))} in {b_path})")
    for k in rest:
        if k not in same:
            print(f"  differs: {k}: {a['ptxas'][k]} | {b['ptxas'].get(k)}")
    for path, run in ((a_path, a), (b_path, b)):
        k12 = [k for k in run["ptxas"] if k.startswith(("fine_kernel<", "coarse_kernel<"))]
        framed = [k for k in k12 if stack_bytes(run["ptxas"][k])]
        print(f"{path}: {len(framed)} of {len(k12)} coarse/fine kernel builds keep a stack frame")
        for k in framed:
            print(f"  stack: {k}: {run['ptxas'][k]}")
    for path, run in ((a_path, a), (b_path, b)):
        k57 = [k for k in run["ptxas"] if flat(k)]
        framed = [k for k in k57 if stack_bytes(run["ptxas"][k])]
        print(f"{path}: {len(framed)} of {len(k57)} flat march kernel builds keep a stack frame")
        for k in k57:
            print(f"  {k}: {run['ptxas'][k]}")
    for key in ("ms", "flat_ms"):
        for k in a.get(key, {}):
            print(f"  {key} {k}: {a[key][k]} | {b.get(key, {}).get(k)}")
    return 0


def device_split(fn, frames):
    """{operation name: device ms a frame} of `fn` under torch.profiler,
    and under "busy" the merged device time a frame: one warm-up run, a
    0.25 s pause, then `frames` runs; events before the pause are dropped
    (the profiler can lose a session's first events), user annotations
    skipped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(0.25)
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    ev = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and e.time_range.end > e.time_range.start
    )
    end = None
    for k, (a, b, _) in enumerate(ev):
        if end is not None and a - end > 0.2e6:
            ev = ev[k:]
            break
        end = b if end is None else max(end, b)
    out, busy, cur = {}, 0.0, None
    for a, b, name in ev:
        out[name] = out.get(name, 0.0) + (b - a) / frames / 1e3
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    out["busy"] = busy / frames / 1e3
    return out


def flat_times(rt, cs, dev):
    """{name: ms} of the flat march kernels and frames (see the module
    docstring); None where the tree has no such build."""
    import torch

    from raymarch_tpu_torch.ops import cuda_march as cm

    w, h = cs.WIDTH, cs.HEIGHT
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
    head = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    wide = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
    pixels = getattr(cm, "image_pixels", None)  # a parent tree may predate the pixel build
    out, split = {}, None
    scenes = (("config2 static", cs.scene_config2(rt), True, head),
              ("config2 dynamic", cs.scene_config2(rt), False, head),
              ("64 spheres static", cs.scene_spheres(rt, 64), True, wide),
              ("16 painted static", cs.scene_painted(rt, 16), True, wide))
    for name, scene, static, cam in scenes:
        spec, arrays = rt.compile_scene(scene, static=static)
        cv = rt.cam_vec(cam, device=dev)
        floors = (("", cfg), (" max_iter 0", dataclasses.replace(cfg, max_iter=0))) if name == "config2 static" \
            else (("", cfg),)
        for tag, cfg_f in floors:
            fm = cm.FlatMarch(spec, cfg_f, w, h, dev)
            sc, c, b = fm.scene_args(arrays, cv)
            p = fm.params
            out[f"K6 {name}{tag}"] = cs.cuda_ms(lambda: cm.image_march(sc, c, b, p), FLAT_REPS)
            out[f"K7 {name}{tag}"] = cs.cuda_ms(lambda: cm.image_render(sc, c, b, p), FLAT_REPS)
            out[f"K7 pixel {name}{tag}"] = (cs.cuda_ms(lambda: pixels(sc, c, b, p), FLAT_REPS)
                                           if pixels else None)
        if name == "config2 static":
            n = w * h * cfg.aa_samples ** 2
            o, d = rt.raygen_flat(torch.arange(n, device=dev), cam.position, cam.rotation, w, h, cfg)
            o, d = o.contiguous(), d.contiguous()
            fm1 = cm.FlatMarch(spec, cfg, 1, 1, dev)
            sc1, _, b1 = fm1.scene_args(arrays)
            out["K5 config2 static"] = cs.cuda_ms(lambda: cm.ray_march(sc1, b1, fm1.params, o, d), FLAT_REPS)
            del o, d
        if static is False or name == "config2 static":
            im = cm.make_pallas_image_march(spec, cfg, w, h, device=dev)
            full = rt.make_renderer(spec, w, h, cfg, mode="forward", backend="pallas_full", device=dev)
            out[f"march_only frame {name}"] = cs.cuda_ms(lambda: im(arrays, cv), FLAT_REPS)
            out[f"pallas_full frame {name}"] = cs.cuda_ms(lambda: full(arrays, cam), FLAT_REPS)
            if name == "config2 static":
                split = device_split(lambda: full(arrays, cam), SPLIT_FRAMES)
        torch.cuda.synchronize()
    return out, split


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("headline_builds: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import raymarch_tpu_torch as rt
    from raymarch_tpu_torch import _build
    from raymarch_tpu_torch.ops import cuda_grad as cg
    from raymarch_tpu_torch.ops import cuda_march as cm
    from raymarch_tpu_torch.ops import cuda_prepass as cp

    smi = cs.card_line()
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    dev = cp.resolve_device("cuda")
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
    spec, arrays = rt.compile_scene(cs.scene_config2(rt), static=True)
    cam = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    cv = rt.cam_vec(cam, device=dev)
    w, h = cs.WIDTH, cs.HEIGHT
    render = rt.make_renderer(spec, w, h, cfg, mode="forward", backend="pallas_prepass", device=dev)
    rp = render.renderer
    sc, c, b = rp.scene_args(arrays, cv)
    pre = cp.coarse(sc, c, b, rp.params)
    fr = cg.make_fused_render_vjp(spec, cfg, w, h, device=dev)
    img, t, hit = cp.fine_res(sc, c, b, fr.params, *pre)
    g = 2.0 * img / img.numel()
    render_f = rt.make_renderer(spec, w, h, cfg, mode="implicit", backend="pallas_fused", device=dev)
    lp0 = torch.tensor(arrays.leaf_params, device=dev)

    def step():
        lp = lp0.clone().requires_grad_(True)
        torch.mean(render_f(dataclasses.replace(arrays, leaf_params=lp), cam) ** 2).backward()

    times = {
        "frame": cs.cuda_ms(lambda: render(arrays, cam), FRAMES),
        "coarse": cs.cuda_ms(lambda: cp.coarse(sc, c, b, rp.params), FRAMES),
        "fine": cs.cuda_ms(lambda: cp.fine(sc, c, b, rp.params, *pre), FRAMES),
        "fine_res": cs.cuda_ms(lambda: cp.fine_res(sc, c, b, fr.params, *pre), FRAMES),
        "k8": cs.cuda_ms(lambda: cg.bwd(sc, c, fr.params, fr.layout, t, hit, g), FRAMES),
        "step": cs.cuda_ms(step, STEPS),
    }
    print(f"headline ms ({smi}): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), file=sys.stderr)
    flat, split = flat_times(rt, cs, dev)
    print(f"flat ms ({smi}): " + ", ".join(f"{k} {'n/a' if v is None else f'{v:.4f}'}" for k, v in flat.items()),
          file=sys.stderr)
    print("pallas_full frame, device ms a frame by operation (torch.profiler): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    route = getattr(cm, "stack_route", None)  # a parent tree may predate the routes
    stack = f"{cm.route_name(route(spec))}, depth {spec.stack_depth}" if route else "local memory"
    print(f"headline K1/K2 stack route: {stack}; build {build_s:.1f} s", file=sys.stderr)
    print(json.dumps({"card": smi, "ms": times, "flat_ms": flat, "pallas_full_split": split, "stack_route": stack,
                      "build_s": build_s, "source_s": _build.stats["source_seconds"],
                      "ptxas": ptxas_lines(_build.stats["ptxas"])}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    sys.exit(main())
