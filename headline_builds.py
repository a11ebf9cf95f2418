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
operation. Then the unpacked fine pass K4 and the explicit-ray march K5
(`k45_times`): K4 on config 2's static and dynamic tapes with shared
normals (16 AA), on the static tape with a normal a sample (16 AA) and at
aa 3 with residuals, each also
at max_iter 0, with the divergence of a one-thread-per-pixel layout and
of a one-lane-per-sample layout (mean over warps of the warp's largest
step count over the mean step count; from the plain version's march steps
on the card); K5 in the 32 chunk launches of 2^20 rays that
`make_renderer(backend="pallas", chunk=1 << 20)` makes of the frame
(CUDA events per launch, torch.profiler's device time per launch, and the
host microseconds of one `ray_march` call without the kernel's launch),
in one
33 M-ray launch, at max_iter 0, and its divergence (32 consecutive rays a
warp) on config 2, on 64 spheres under the camera (0, 2.5, 9) and on
seeded incoherent rays (origins uniform in [-3, 3]^3, directions uniform
on the sphere). Then the chained pixel kernel K3 (`k3_times`, 30 runs
after one warm-up on prepared arguments, 1920x1080, B = 4,
`prepass_chain`): on config 2's
static and dynamic tapes under the headline camera and on 64 spheres
(stack depth 8: the shared-memory route) under the camera (0, 2.5, 9),
each also at max_iter 0 (raygen, the bound clip, the block planes' loads
and the stores: the per-pixel floor), by CUDA events and by
torch.profiler's device time a launch (CUDA events over back-to-back
launches of a kernel this short time the host's calls where they are the
slower), with its block pass (K1, KIND 1),
the chained frame, and the divergence of a warp of 32 pixels of a row
and of a warp of an 8x4-pixel tile (from the plain version's march steps
on the card). `--k45` runs the K4/K5 rows alone, `--k3` the K3 rows;
`--mo` times alone the two K2 march-only interval builds whose ptxas line
moved when `interval_march` lost its unrolled bounds (`march_only_times`);
`--flat` prices the flat kernels' march (`flat_price`): the flat rows
above, K5 in a 2^20-ray launch of the 32 that
`make_renderer(backend="pallas", chunk=1 << 20)` makes of the frame, the
`fwdbwd_jnp` step through that renderer, and K6's march steps a ray
(`rt.march_stats`) and hit rays on config 2 under the headline camera and
on 64 spheres under (0, 2.5, 9).
It prints one JSON
object: the card, those times and, per kernel build, ptxas's register /
stack / spill line. To compare two trees,
unpack the other under `build/` and run the script from each root in one
call (parent, change, change, parent), each output to a file, then

    python3 headline_builds.py --compare PARENT.json CHANGE.json

counts the builds whose ptxas line is the same in both and lists the
others, K4's and the flat march builds apart, then counts each tree's K4
builds that keep a stack (`fine_unpacked_kernel<MODE, RELAX, MATS, PRE,
STK>`; a parent tree's have no STK) and lists each tree's coarse and fine
kernel builds that keep a stack frame and its flat march builds with
their stack frames. A `fine_kernel` build without the
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
K45_REPS = 30  # runs of each K4 / K5 time
HOST_CALLS = 2000  # ray_march calls timed without their launch
K5_CHUNK = 1 << 20  # the rays of one K5 launch in a chunked frame (make_renderer(chunk=1 << 20))
K5_MID = 1 << 21  # half the 64-sphere divergence sample: 2^22 consecutive rays mid-frame
K3_REPS = 30  # runs of each K3 time
FLAT_STEPS = 3  # fwdbwd_jnp steps of `--flat` (after one warm-up; about a second each)


def ptxas_lines(report: str) -> dict:
    """{kernel build: "Used N registers, ..."} from ptxas -v's report."""
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            k = re.search(r"fine_kernelILi(\d)ELb(\d)ELb(\d)ELi(\d)(?:ELb(\d))?(?:ELi(\d+))?E", entry)
            c = re.search(r"coarse_kernelILi(\d)ELi(\d)(?:ELi(\d+))?E", entry)
            k3 = re.search(r"coarse_px_kernelILi(\d)E(?:Li(\d+)E)?E", entry)
            m5 = re.search(r"march_kernelILi(\d)ELi(\d)ELb(\d)ELb(\d)ELb(\d)(?:ELi(\d+))?E", entry)
            k4 = re.search(r"fine_unpacked_kernelILi(\d)ELb(\d)ELb(\d)ELi(\d)(?:ELi(\d+))?E", entry)
            if k3:
                entry = "coarse_px_kernel<{}{}>".format(k3.group(1), "" if k3.group(2) is None else f", {k3.group(2)}")
            elif k4:
                stk = "" if k4.group(5) is None else f", {k4.group(5)}"
                entry = "fine_unpacked_kernel<{}, {}, {}, {}{}>".format(*k4.group(1, 2, 3, 4), stk)
            elif m5:
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
    k4 = lambda k: k.startswith("fine_unpacked_kernel<")  # noqa: E731
    same = [k for k in a["ptxas"] if b["ptxas"].get(k) == a["ptxas"][k]]
    print(f"{len(same)} of {len(a['ptxas'])} builds of {a_path} have the same ptxas line in {b_path} "
          f"({len(b['ptxas'])} builds there)")
    rest = [k for k in a["ptxas"] if not flat(k) and not k4(k)]
    rest_same = [k for k in rest if k in same]
    print(f"  builds other than K4's and the flat march kernels': {len(rest_same)} of {len(rest)} the same "
          f"({sum(1 for k in b['ptxas'] if not flat(k) and not k4(k))} in {b_path})")
    for k in (k for k in a["ptxas"] if flat(k)):
        if k not in same:
            print(f"  flat build differs: {k}: {a['ptxas'][k]} | {b['ptxas'].get(k)}")
    for path, run in ((a_path, a), (b_path, b)):
        k4s = [k for k in run["ptxas"] if k4(k)]
        framed = [k for k in k4s if stack_bytes(run["ptxas"][k])]
        print(f"{path}: {len(framed)} of {len(k4s)} K4 builds keep a stack")
    for k in rest:
        if k not in same:
            print(f"  differs: {k}: {a['ptxas'][k]} | {b['ptxas'].get(k)}")
    for path, run in ((a_path, a), (b_path, b)):
        k12 = [k for k in run["ptxas"] if k.startswith(("fine_kernel<", "coarse_kernel<", "coarse_px_kernel<"))]
        framed = [k for k in k12 if stack_bytes(run["ptxas"][k])]
        print(f"{path}: {len(framed)} of {len(k12)} coarse/fine/K3 kernel builds keep a stack frame")
        for k in (k for k in k12 if k.startswith("coarse_px_kernel<")):
            print(f"  K3: {k}: {run['ptxas'][k]}")
        for k in framed:
            print(f"  stack: {k}: {run['ptxas'][k]}")
    for path, run in ((a_path, a), (b_path, b)):
        k57 = [k for k in run["ptxas"] if flat(k)]
        framed = [k for k in k57 if stack_bytes(run["ptxas"][k])]
        print(f"{path}: {len(framed)} of {len(k57)} flat march kernel builds keep a stack frame")
        for k in k57:
            print(f"  {k}: {run['ptxas'][k]}")
    for key in ("ms", "flat_ms", "k45", "k3"):
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

def flat_price(rt, cs, dev):
    """{name: ms, or steps a ray, or hit rays} of `--flat` (see the module
    docstring): `flat_times`'s rows, K5 a 2^20-ray launch of the frame's
    32 (CUDA events over the 32, FLAT_REPS runs), the `fwdbwd_jnp` step
    (mean(img^2) backpropagated through `make_renderer(backend="pallas",
    mode="implicit", chunk=1 << 20)`, FLAT_STEPS steps after one), and,
    from K6's outputs, the mean steps of every AA ray, of hit rays and of
    missed rays, and the hit rays."""
    import torch

    from raymarch_tpu_torch.ops import cuda_march as cm

    out, _ = flat_times(rt, cs, dev)
    w, h = cs.WIDTH, cs.HEIGHT
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
    head = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    wide = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
    spec, arrays = rt.compile_scene(cs.scene_config2(rt), static=True)
    n = w * h * cfg.aa_samples ** 2
    o, d = rt.raygen_flat(torch.arange(n, device=dev), head.position, head.rotation, w, h, cfg)
    o, d = o.contiguous(), d.contiguous()
    fm = cm.FlatMarch(spec, cfg, 1, 1, dev)
    sc, _, b = fm.scene_args(arrays)
    spans = [(i, min(i + K5_CHUNK, n)) for i in range(0, n, K5_CHUNK)]
    out["K5 a 2^20-ray launch of 32"] = cs.cuda_ms(
        lambda: [cm.ray_march(sc, b, fm.params, o[i:j], d[i:j]) for i, j in spans], FLAT_REPS) / len(spans)
    del o, d
    render = rt.make_renderer(spec, w, h, cfg, mode="implicit", backend="pallas", chunk=K5_CHUNK, device=dev)
    lp0 = torch.tensor(arrays.leaf_params, device=dev)

    def step():
        lp = lp0.clone().requires_grad_(True)
        torch.mean(render(dataclasses.replace(arrays, leaf_params=lp), head) ** 2).backward()

    out["fwdbwd_jnp step"] = cs.cuda_ms(step, FLAT_STEPS)
    for name, scene, cam in (("config2", cs.scene_config2(rt), head), ("64 spheres", cs.scene_spheres(rt, 64), wide)):
        spec_m, arrays_m = rt.compile_scene(scene, static=True)
        _, hit, steps = cm.make_pallas_image_march(spec_m, cfg, w, h, device=dev)(arrays_m, rt.cam_vec(cam, device=dev))
        hits = hit > 0.5
        out[f"K6 steps a ray, {name}"] = rt.march_stats(steps, hit).avg_steps
        out[f"K6 steps a hit ray, {name}"] = float(steps[hits].float().mean())
        out[f"K6 steps a missed ray, {name}"] = float(steps[~hits].float().mean())
        out[f"K6 hit rays, {name}"] = int(hits.sum())
        del hit, steps, hits
    torch.cuda.synchronize()
    return out


class StepCount:
    """A `work` argument of the plain fine passes that keeps each AA ray's
    march steps (the scene evaluations of live rays; the normal taps, added
    with points_per 4, are left out)."""

    def __init__(self):
        self.steps = 0.0
        self.hits = 0.0

    def add(self, live, leaves, points_per=1):
        if points_per == 1:
            self.steps = self.steps + live


def warp_divergence(lanes):
    """Mean over warps of the warp's largest step count over the mean step
    count of a lane, for `lanes` f32[..., 32] (a warp's lanes last; -1 marks
    a lane with no ray)."""
    lanes = lanes.reshape(-1, 32)
    valid = lanes >= 0
    warps = valid.any(dim=1)
    top = lanes.amax(dim=1)[warps]
    return float(top.mean() / lanes[valid].mean())


def k4_layouts(steps, threads_per_pixel_block=128):
    """(one thread per pixel, one lane per sample) divergence of K4's AA
    rays' march steps f32[rows, W, S]: a warp of 32 neighbouring pixels of a
    row, each thread its pixel's S marches in turn; or a block of whole
    pixels of a row (floor(128 / S) of them, one where S > 128), a lane per
    sample, a warp 32 consecutive lanes of the block."""
    import torch

    rows, w, s = steps.shape
    per_px = steps.sum(dim=-1)
    pad = -w % 32
    px = torch.cat([per_px, per_px.new_full((rows, pad), -1.0)], dim=1)
    n_px = threads_per_pixel_block // s if s < threads_per_pixel_block else 1
    nb = -(-w // n_px)
    lanes = torch.cat([steps, steps.new_full((rows, nb * n_px - w, s), -1.0)], dim=1)
    lanes = lanes.reshape(rows, nb, n_px * s)
    lanes = torch.cat([lanes, lanes.new_full((rows, nb, -(n_px * s) % 32), -1.0)], dim=2)
    return warp_divergence(px), warp_divergence(lanes)


def k45_times(rt, cs, dev):
    """{name: ms, or a divergence or step count} of K4 and K5; see the
    module docstring."""
    import numpy as np
    import torch

    from raymarch_tpu_torch import _build
    from raymarch_tpu_torch.ops import cuda_march as cm
    from raymarch_tpu_torch.ops import cuda_prepass as cp

    w, h = cs.WIDTH, cs.HEIGHT
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
    head = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    wide = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
    cv = rt.cam_vec(head, device=dev)
    out = {}
    k4 = (("shared static", True, dataclasses.replace(cfg, aa_shared_normals=True), False),
          ("per-sample normals static", True, cfg, False),
          ("shared dynamic", False, dataclasses.replace(cfg, aa_shared_normals=True), False),
          ("aa 3 residuals static", True, dataclasses.replace(cfg, aa_samples=3), True))
    for name, static, cfg_k, res in k4:
        spec, arrays = rt.compile_scene(cs.scene_config2(rt), static=static)
        rp = cp.make_pallas_image_render_aa(spec, cfg_k, w, h, device=dev, aa_packed=False)
        sc, c, b = rp.scene_args(arrays, cv)
        pre = rp.prepass(sc, c, b, None)
        fn = cp.fine_unpacked_res if res else cp.fine_unpacked
        for tag, p in (("", rp.params), (" max_iter 0", dataclasses.replace(rp.params, max_iter=0))):
            out[f"K4 {name}{tag}"] = cs.cuda_ms(lambda: fn(sc, c, b, p, *pre), K45_REPS)
        if static and res or name == "shared static":
            work = StepCount()
            cp.fine_unpacked_plain(sc, c, b, rp.params, *pre, work=work)
            thread, lane = k4_layouts(work.steps)
            out[f"K4 {name} divergence, a thread a pixel"] = thread
            out[f"K4 {name} divergence, a lane a sample"] = lane
            out[f"K4 {name} steps an AA ray"] = float(work.steps.mean())
            del work
        torch.cuda.synchronize()

    spec, arrays = rt.compile_scene(cs.scene_config2(rt), static=True)
    n = w * h * cfg.aa_samples ** 2
    o, d = rt.raygen_flat(torch.arange(n, device=dev), head.position, head.rotation, w, h, cfg)
    o, d = o.contiguous(), d.contiguous()
    fm = cm.FlatMarch(spec, cfg, 1, 1, dev)
    sc, _, b = fm.scene_args(arrays)
    p = fm.params
    chunk = K5_CHUNK
    spans = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]

    def chunks():
        return [cm.ray_march(sc, b, p, o[i:j], d[i:j]) for i, j in spans]

    out["K5 a 2^20-ray launch of 32"] = cs.cuda_ms(chunks, K45_REPS) / len(spans)
    out["K5 one 33 M-ray launch"] = cs.cuda_ms(lambda: cm.ray_march(sc, b, p, o, d), K45_REPS)
    p0 = dataclasses.replace(p, max_iter=0)
    out["K5 one 33 M-ray launch max_iter 0"] = cs.cuda_ms(lambda: cm.ray_march(sc, b, p0, o, d), K45_REPS)
    out["K5 a 2^20-ray launch of 32 max_iter 0"] = cs.cuda_ms(
        lambda: [cm.ray_march(sc, b, p0, o[i:j], d[i:j]) for i, j in spans], K45_REPS) / len(spans)
    dev_ms = device_split(chunks, K45_REPS)
    kern = {k: v for k, v in dev_ms.items() if "march_kernel" in k}
    out["K5 a 2^20-ray launch of 32, device ms (torch.profiler)"] = sum(kern.values()) / len(spans)
    out["K5 32 launches, device busy ms (torch.profiler)"] = dev_ms["busy"]
    lib = _build.load()

    class NoLaunch:
        def __getattr__(self, name):
            return lambda *a: 0

    _build._lib = NoLaunch()
    try:
        o1, d1 = o[:chunk], d[:chunk]
        for _ in range(50):
            cm.ray_march(sc, b, p, o1, d1)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            cm.ray_march(sc, b, p, o1, d1)
        out["K5 host us a ray_march call without its launch"] = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
    finally:
        _build._lib = lib
    t_, hit_, steps = cm.ray_march_plain(sc, b, p, o, d)
    out["K5 divergence, config 2"] = warp_divergence(steps.float())
    out["K5 steps a ray, config 2"] = float(steps.float().mean())
    del t_, hit_, steps
    spec64, arrays64 = rt.compile_scene(cs.scene_spheres(rt, 64), static=True)
    fm64 = cm.FlatMarch(spec64, cfg, 1, 1, dev)
    sc64, _, b64 = fm64.scene_args(arrays64)
    o64, d64 = rt.raygen_flat(torch.arange(n // 2 - K5_MID, n // 2 + K5_MID, device=dev), wide.position,
                              wide.rotation, w, h, cfg)
    _, _, steps = cm.ray_march_plain(sc64, b64, fm64.params, o64.contiguous(), d64.contiguous())
    out["K5 divergence, 64 spheres (2^22 rays mid-frame)"] = warp_divergence(steps.float())
    out["K5 steps a ray, 64 spheres"] = float(steps.float().mean())
    rng = np.random.default_rng(5)
    oi = rng.uniform(-3.0, 3.0, (chunk, 3)).astype(np.float32)
    di = rng.normal(size=(chunk, 3))
    di = (di / np.linalg.norm(di, axis=1, keepdims=True)).astype(np.float32)
    oi, di = torch.tensor(oi, device=dev), torch.tensor(di, device=dev)
    _, _, steps = cm.ray_march_plain(sc, b, p, oi, di)
    out["K5 divergence, incoherent rays (2^20, config 2)"] = warp_divergence(steps.float())
    out["K5 steps a ray, incoherent"] = float(steps.float().mean())
    out["K5 incoherent, a 2^20-ray launch"] = cs.cuda_ms(lambda: cm.ray_march(sc, b, p, oi, di), K45_REPS)
    torch.cuda.synchronize()
    return out


def tile_warps(steps, tw=8, th=4):
    """`steps` f32[rows, W] regrouped into warps of tw x th-pixel tiles
    (lane = row-in-tile * tw + column-in-tile; -1 past the frame's edge)
    -> f32[n_warps, 32]."""
    import torch

    rows, w = steps.shape
    pr, pc = -rows % th, -w % tw
    s = torch.cat([steps, steps.new_full((rows, pc), -1.0)], dim=1)
    s = torch.cat([s, s.new_full((pr, w + pc), -1.0)], dim=0)
    r2, w2 = s.shape
    return s.reshape(r2 // th, th, w2 // tw, tw).permute(0, 2, 1, 3).reshape(-1, tw * th)


def k3_times(rt, cs, dev):
    """{name: ms, or a divergence or step count} of K3; see the module
    docstring."""
    import torch

    from raymarch_tpu_torch.ops import cuda_prepass as cp

    w, h = cs.WIDTH, cs.HEIGHT
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
    head = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    wide = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
    out = {}
    for name, scene, static, cam in (("config2 static", cs.scene_config2(rt), True, head),
                                     ("config2 dynamic", cs.scene_config2(rt), False, head),
                                     ("64 spheres static (depth 8)", cs.scene_spheres(rt, 64), True, wide)):
        spec, arrays = rt.compile_scene(scene, static=static)
        cv = rt.cam_vec(cam, device=dev)
        rp = cp.make_pallas_image_render_aa(spec, cfg, w, h, device=dev, prepass_block=4, prepass_chain=True)
        sc, c, b = rp.scene_args(arrays, cv)
        blk = cp.coarse(sc, c, b, rp.params)
        p0 = dataclasses.replace(rp.params, max_iter=0)
        out[f"K3 {name}"] = cs.cuda_ms(lambda: cp.coarse_px(sc, c, b, rp.params, *blk), K3_REPS)
        out[f"K3 {name} max_iter 0"] = cs.cuda_ms(lambda: cp.coarse_px(sc, c, b, p0, *blk), K3_REPS)
        for tag, p in (("", rp.params), (" max_iter 0", p0)):
            split = device_split(lambda: cp.coarse_px(sc, c, b, p, *blk), K3_REPS)
            out[f"K3 {name}{tag}, device ms (torch.profiler)"] = sum(
                v for k, v in split.items() if "coarse_px_kernel" in k)
        out[f"K1 block pass {name}"] = cs.cuda_ms(lambda: cp.coarse(sc, c, b, rp.params), K3_REPS)
        out[f"chained frame {name}"] = cs.cuda_ms(lambda: rp(arrays, cv), K3_REPS)
        work = StepCount()
        cp.coarse_px_plain(sc, c, b, rp.params, *blk, work=work)
        steps = work.steps if torch.is_tensor(work.steps) else torch.zeros((h, w), device=dev)
        pad = -w % 32
        rows = torch.cat([steps, steps.new_full((h, pad), -1.0)], dim=1)
        out[f"K3 {name} divergence, 32 pixels of a row a warp"] = warp_divergence(rows)
        out[f"K3 {name} divergence, an 8x4 tile a warp"] = warp_divergence(tile_warps(steps))
        out[f"K3 {name} steps a pixel"] = float(steps.mean())
        del work, steps, rows
        torch.cuda.synchronize()
    return out


def march_only_times(rt, cs, dev):
    """{name: ms} of the two K2 march-only builds that removing
    interval_march's NoPlanes path recompiled (relax, 2 intervals, 1080p,
    16 AA): fine_kernel<0, 1, 0, 2, 1, 0> on config 2 at stack depth 4 (the
    shared-memory route) under the headline camera and fine_kernel<1, 1, 0,
    2, 1, 2> on bench.py's 64 spheres with leaf_cull (the compact lists)
    under the camera (0, 2.5, 9); by CUDA events and torch.profiler's
    device time a launch, 30 runs after one warm-up."""
    from raymarch_tpu_torch.ops import cuda_prepass as cp

    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4, relax=1.6)
    head = rt.cam_vec(rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0)), device=dev)
    wide = rt.cam_vec(rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0)), device=dev)
    out = {}
    for name, scene, kw, cfg_c, cv in (
            ("fine_kernel<0, 1, 0, 2, 1, 0> (config 2, stack depth 4)", cs.scene_config2(rt), dict(stack_depth=4),
             cfg, head),
            ("fine_kernel<1, 1, 0, 2, 1, 2> (64 spheres, leaf_cull lists)", cs.scenes_bench64(rt)[0], {},
             dataclasses.replace(cfg, leaf_cull=True), wide)):
        spec, arrays = rt.compile_scene(scene, static=True, **kw)
        mo = cp.make_pallas_image_march_fast(spec, cfg_c, cs.WIDTH, cs.HEIGHT, device=dev, prepass_block=1,
                                             n_intervals=2)
        sc, c, b = mo.scene_args(arrays, cv)
        cc, fc = mo.cull_args(sc, c)
        pre = mo.prepass(sc, c, b, cc)

        def fn():
            return cp.fine_march(sc, c, b, mo.params, *pre, cull=fc)

        out[name] = cs.cuda_ms(fn, K3_REPS)
        split = device_split(fn, K3_REPS)
        out[f"{name}, device ms (torch.profiler)"] = sum(v for k, v in split.items() if "fine_kernel" in k)
    return out


def main(only_k45: bool = False, only_k3: bool = False, only_mo: bool = False, only_flat: bool = False) -> int:
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
    if only_flat:
        flat = flat_price(rt, cs, dev)
        print(f"flat ({smi}): " + ", ".join(f"{k} {'n/a' if v is None else f'{v:.4f}'}" for k, v in flat.items()),
              file=sys.stderr)
        print(json.dumps({"card": smi, "flat_ms": flat, "build_s": build_s,
                          "ptxas": ptxas_lines(_build.stats["ptxas"])}), flush=True)
        return 0
    if only_mo:
        mo = march_only_times(rt, cs, dev)
        print(f"march-only builds ({smi}): " + ", ".join(f"{k} {v:.4f}" for k, v in mo.items()), file=sys.stderr)
        print(json.dumps({"card": smi, "mo": mo, "build_s": build_s}), flush=True)
        return 0
    if only_k3:
        k3 = k3_times(rt, cs, dev)
        print(f"K3 ({smi}): " + ", ".join(f"{k} {v:.4f}" for k, v in k3.items()), file=sys.stderr)
        print(json.dumps({"card": smi, "k3": k3, "build_s": build_s, "source_s": _build.stats["source_seconds"],
                          "ptxas": ptxas_lines(_build.stats["ptxas"])}), flush=True)
        return 0
    if only_k45:
        k45 = k45_times(rt, cs, dev)
        print(f"K4/K5 ({smi}): " + ", ".join(f"{k} {v:.4f}" for k, v in k45.items()), file=sys.stderr)
        print(json.dumps({"card": smi, "k45": k45, "build_s": build_s, "source_s": _build.stats["source_seconds"],
                          "ptxas": ptxas_lines(_build.stats["ptxas"])}), flush=True)
        return 0
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
    k45 = k45_times(rt, cs, dev)
    print(f"K4/K5 ({smi}): " + ", ".join(f"{k} {v:.4f}" for k, v in k45.items()), file=sys.stderr)
    k3 = k3_times(rt, cs, dev)
    print(f"K3 ({smi}): " + ", ".join(f"{k} {v:.4f}" for k, v in k3.items()), file=sys.stderr)
    route = getattr(cm, "stack_route", None)  # a parent tree may predate the routes
    stack = f"{cm.route_name(route(spec))}, depth {spec.stack_depth}" if route else "local memory"
    print(f"headline K1/K2 stack route: {stack}; build {build_s:.1f} s", file=sys.stderr)
    print(json.dumps({"card": smi, "ms": times, "flat_ms": flat, "k45": k45, "k3": k3, "pallas_full_split": split,
                      "stack_route": stack,
                      "build_s": build_s, "source_s": _build.stats["source_seconds"],
                      "ptxas": ptxas_lines(_build.stats["ptxas"])}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    sys.exit(main(only_k45=sys.argv[1:] == ["--k45"], only_k3=sys.argv[1:] == ["--k3"],
                  only_mo=sys.argv[1:] == ["--mo"], only_flat=sys.argv[1:] == ["--flat"]))
