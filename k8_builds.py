#!/usr/bin/env python3
"""Times the two builds of the legacy backward (K8) on short tapes.

Run from the repository root on one CUDA card: `python3 k8_builds.py`. It
builds the kernels, prints ptxas's registers for K8's builds, then at
1920x1080 with 16 AA rays per pixel times K8 (`cuda_grad.bwd`, CUDA events,
10 runs after one warm-up, three rounds) on the residuals of BASELINE
config 2 under the headline camera and of 16 painted spheres
(chip_smoke.py's path (e)), each in the build that `GradLayout.long` chooses
for it (the per-thread build) and in the long build forced, and holds the
long build's gradients to the per-thread build's. The last line is one JSON
object. To compare two trees, unpack the other under `build/` and run the
script from each root in one call.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys

import chip_smoke as cs

ROUNDS = 3


def k8_registers(ptxas: str) -> dict:
    """{"fused_bwd_kernel<false, false>": registers, ...} (the MATS and
    SOFT flags) from ptxas -v's report."""
    regs, entry = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            k = re.search(r"(fused_bwd(?:_long)?_kernel)ILb([01])ELb([01])E", entry)
            if k:
                flags = ", ".join("true" if f == "1" else "false" for f in k.group(2, 3))
                regs[f"{k.group(1)}<{flags}>"] = int(m.group(1))
            entry = None
    return regs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k8_builds: CUDA is not available", file=sys.stderr)
        return 2
    smi = cs.card_line()
    import raymarch_tpu_torch as rt
    from raymarch_tpu_torch import _build
    from raymarch_tpu_torch.ops import cuda_grad as cg
    from raymarch_tpu_torch.ops import cuda_prepass as cp

    class LongLayout(cg.GradLayout):
        """The same gradient layout, sent to the long build."""

        long = True

    _build.load()
    regs = k8_registers(_build.stats["ptxas"])
    cs.log(f"card: {smi}; K8 registers {regs}")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
    nocull = dataclasses.replace(cfg, relax=1.6, leaf_cull=False)
    cases = (
        ("headline", cs.scene_config2(rt), cfg, (0.0, 1.6, 4.2)),
        ("e", cs.scene_painted(rt, 16), nocull, (0.0, 2.5, 9.0)),
    )
    out = {"card": smi, "registers": regs}
    for name, scene, cfg_c, pos in cases:
        spec, arrays = rt.compile_scene(scene, static=True)
        cv = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device=dev)
        fr = cg.make_fused_render_vjp(spec, cfg_c, cs.WIDTH, cs.HEIGHT, device=dev)
        rp, p, lay = fr.prepass, fr.params, fr.layout
        lay_l = LongLayout(**{f.name: getattr(lay, f.name) for f in dataclasses.fields(lay)})
        sc, cam, bnd = rp.scene_args(arrays, cv)
        cc, fc = rp.cull_args(sc, cam)
        img, t, hit = cp.fine_res(sc, cam, bnd, p, *rp.prepass(sc, cam, bnd, cc), cull=fc)
        g_img = 2.0 * img / img.numel()  # the cotangent of mean(img^2)
        per_thread, long_ms = [], []
        for _ in range(ROUNDS):
            per_thread.append(cs.cuda_ms(lambda: cg.bwd(sc, cam, p, lay, t, hit, g_img), cs.KERNEL_REPS))
            long_ms.append(cs.cuda_ms(lambda: cg.bwd(sc, cam, p, lay_l, t, hit, g_img), cs.KERNEL_REPS))
        err = cs.grad_class(f"({name}) long build vs per-thread build", cg.bwd(sc, cam, p, lay_l, t, hit, g_img),
                            cg.bwd(sc, cam, p, lay, t, hit, g_img))
        cs.log(f"({name}) {lay.n_real} instructions, long={lay.long}: K8 per-thread build {per_thread} ms, "
               f"long build {long_ms} ms ({smi})")
        out[name] = dict(n_real=lay.n_real, per_thread_ms=per_thread, long_ms=long_ms, max_abs_err=err)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
