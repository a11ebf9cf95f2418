#!/usr/bin/env python3
"""Times the headline kernels and reports every kernel build's ptxas line.

Run from a repository root on one CUDA card: `python3 headline_builds.py`.
It builds the kernels, then at 1920x1080 with 16 AA rays per pixel on
BASELINE config 2 under the headline camera times (CUDA events, 20 runs
after one warm-up; the step 10) the frame through
`make_renderer(backend="pallas_prepass")`, the coarse kernel, the fine
kernel, the fine kernel with residuals, the legacy backward K8 and the
fwd+bwd step through `make_renderer(backend="pallas_fused")`, and prints
one JSON object: the card, those times and, per kernel build, ptxas's
register / stack / spill line. To compare two trees, unpack the other under
`build/` and run the script from each root in one call (parent, change,
change, parent), each output to a file, then

    python3 headline_builds.py --compare PARENT.json CHANGE.json

counts the builds whose ptxas line is the same in both and lists the
others, then lists each tree's coarse and fine kernel builds that keep a
stack frame. A `fine_kernel` build without the march-only flag is keyed as
one with it false, so that adding the flag renames no build; its stack
route (`STK`: 2 a register, 0 shared memory) is a sixth key where the
build has one, as is the coarse kernel's third.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time

FRAMES, STEPS = 20, 10


def ptxas_lines(report: str) -> dict:
    """{kernel build: "Used N registers, ..."} from ptxas -v's report."""
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            k = re.search(r"fine_kernelILi(\d)ELb(\d)ELb(\d)ELi(\d)(?:ELb(\d))?(?:ELi(\d+))?E", entry)
            c = re.search(r"coarse_kernelILi(\d)ELi(\d)(?:ELi(\d+))?E", entry)
            if k:
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
    same = [k for k in a["ptxas"] if b["ptxas"].get(k) == a["ptxas"][k]]
    print(f"{len(same)} of {len(a['ptxas'])} builds of {a_path} have the same ptxas line in {b_path} "
          f"({len(b['ptxas'])} builds there)")
    for k in a["ptxas"]:
        if k not in same:
            print(f"  differs: {k}: {a['ptxas'][k]} | {b['ptxas'].get(k)}")
    for path, run in ((a_path, a), (b_path, b)):
        k12 = [k for k in run["ptxas"] if k.startswith(("fine_kernel<", "coarse_kernel<"))]
        framed = [k for k in k12 if stack_bytes(run["ptxas"][k])]
        print(f"{path}: {len(framed)} of {len(k12)} coarse/fine kernel builds keep a stack frame")
        for k in framed:
            print(f"  stack: {k}: {run['ptxas'][k]}")
    return 0


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
    route = getattr(cm, "stack_route", None)  # a parent tree may predate the routes
    stack = f"{cm.route_name(route(spec))}, depth {spec.stack_depth}" if route else "local memory"
    print(f"headline K1/K2 stack route: {stack}; build {build_s:.1f} s", file=sys.stderr)
    print(json.dumps({"card": smi, "ms": times, "stack_route": stack, "build_s": build_s,
                      "ptxas": ptxas_lines(_build.stats["ptxas"])}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    sys.exit(main())
