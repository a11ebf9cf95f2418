#!/usr/bin/env python3
"""Times the backward kernels K8 and K9 alone on the paths they serve.

Run from a repository root on one CUDA card: `python3 k8_builds.py`. It
builds the kernels, prints ptxas's register line of every K8 and K9 build,
then at 1920x1080 with 16 AA rays per pixel, on the residuals of the
forward that the training path runs, times (CUDA events, `REPS` runs after
one warm-up, `ROUNDS` rounds):

- K8 (`cuda_grad.bwd`) on chip_smoke.py's paths (a) 64 painted spheres
  without culling, (b) the painted smooth chain, (c) 64 spheres & a box,
  (d) config 2 at `prepass_block=4`, (e) 16 painted spheres, and on the
  headline (config 2 under the headline camera);
- K9 (`cuda_grad.compact_bwd`) on the 64-sphere pool of
  `fwdbwd_64leaf_compact`, the seg1 smooth chain of `64leaf_smooth_chain`,
  the stream cluster of `fwdbwd_64leaf_cluster` and the soft row
  `fwdbwd_64leaf_soft` (s2).

Each case is also gated at 256x144 against its plain version
(`bwd_plain`, `compact_bwd_plain`) in the gradient class of
chip_smoke.grad_class. Where K8's layout picks its per-thread build (the
headline, (d), (e)), the warp-row build is gated and timed on the same
residuals too. The last line is one JSON object.

To compare two trees on one card, unpack the other under `build/` (e.g.
`git archive PARENT | tar -x -C build/parent`), copy this script there, run
it from each root in one call, in the order parent, change, change, parent,
each to its own file, then

    python3 k8_builds.py --compare P1.json C1.json C2.json P2.json

prints each case's times side by side and the change's mean over the
parent's.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys

import chip_smoke as cs

ROUNDS = 2
REPS = 5
GATE_W, GATE_H = 256, 144


def bwd_registers(ptxas: str) -> dict:
    """{kernel build: ptxas's "Used N registers, ..." line} for the builds
    of csrc/fused_bwd.cu and csrc/compact_bwd.cu."""
    out, entry = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used \d+ registers.*", line)
        if m and entry:
            k = re.search(r"((?:fused|compact)_bwd\w*_kernel)I(\w+)E", entry)
            if k:
                out[f"{k.group(1)}<{k.group(2)}>"] = m.group(0).strip()
            entry = None
    return out


def cases(rt):
    """(name, scene, config, camera position, make_fused_render_vjp keywords,
    mode) of every timed case."""
    import numpy as np

    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
    cfg64 = dataclasses.replace(cfg, relax=1.6, leaf_cull=True)
    nocull = dataclasses.replace(cfg64, leaf_cull=False)
    cam_h, cam64 = (0.0, 1.6, 4.2), (0.0, 2.5, 9.0)
    spheres, chain, cluster = cs.scenes_bench64(rt)
    _, chain_painted, _ = cs.scenes_bench64(rt, chain_rgb=np.random.default_rng(19))
    return (
        ("headline", cs.scene_config2(rt), cfg, cam_h, {}, "implicit"),
        ("a", cs.scene_painted(rt), nocull, cam64, {}, "implicit"),
        ("b", chain_painted, cfg64, cam64, {}, "implicit"),
        ("c", cs.scene_spheres(rt) & rt.box(half_extents=(3.2, 1.2, 3.2)), cfg64, cam64, {}, "implicit"),
        ("d", cs.scene_config2(rt), cfg, cam_h, dict(prepass_block=4), "implicit"),
        ("e", cs.scene_painted(rt, 16), nocull, cam64, {}, "implicit"),
        ("pool", spheres, cfg64, cam64, {}, "implicit"),
        ("seg1", chain, cfg64, cam64, {}, "implicit"),
        ("stream", cluster, cfg64, cam64, {}, "implicit"),
        ("s2", spheres, dataclasses.replace(cfg, leaf_cull=True), cam64, {}, "soft"),  # bench.py:855-860
    )


def backward_of(rt, cp, cg, spec, arrays, cfg, pos, kw, mode, w, h, dev, warp_rows=False):
    """(kernel name, fn() -> the kernel's gradient, plain() -> the plain
    version's) on the residuals of the training path's forward at w x h;
    `warp_rows` sends K8 to its warp-row build whatever its layout picks."""
    soft = mode == "soft"
    fr = cg.make_fused_render_vjp(spec, cfg, w, h, device=dev, soft=soft, **kw)
    rp, p = fr.prepass, fr.params
    cv = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device=dev)
    sc, cam, bnd = rp.scene_args(arrays, cv)
    cc, fc = rp.cull_args(sc, cam)
    img, t, hit, *res = rp.fine_pass(residuals=True)(sc, cam, bnd, p, *rp.prepass(sc, cam, bnd, cc), cull=fc)
    g_img = 2.0 * img / img.numel()  # the cotangent of mean(img^2)
    soft_res = tuple(res) or None
    clamp = fr.layout.grad_denom_clamp
    if fr.compact_bwd:
        return ("compact_bwd_kernel",
                lambda: cg.compact_bwd(sc, fc, cam, p, clamp, t, hit, g_img, soft=soft_res),
                lambda: cg.compact_bwd_plain(sc, fc, cam, p, clamp, t, hit, g_img, band_rows=16, soft=soft_res))
    lay = fr.layout
    if warp_rows:
        lay = type("WarpLayout", (cg.GradLayout,), {"long": True})(
            **{f.name: getattr(lay, f.name) for f in dataclasses.fields(lay)})
    return ("fused_bwd_kernel",
            lambda: cg.bwd(sc, cam, p, lay, t, hit, g_img, soft=soft_res),
            lambda: cg.bwd_plain(sc, cam, p, lay, t, hit, g_img, band_rows=16, soft=soft_res))


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

    _build.load()
    regs = bwd_registers(_build.stats["ptxas"])
    cs.log(f"card: {smi}; backward builds: {json.dumps(regs)}")
    dev = torch.device("cuda")
    out = {"card": smi, "ptxas": regs, "ms": {}, "gate": {}}
    for name, scene, cfg, pos, kw, mode in cases(rt):
        spec, arrays = rt.compile_scene(scene, static=True)
        kname, gate, gate_plain = backward_of(rt, cp, cg, spec, arrays, cfg, pos, kw, mode, GATE_W, GATE_H, dev)
        err = cs.grad_class(f"({name}) gate {GATE_W}x{GATE_H}: {kname} vs its plain version", gate(), gate_plain())
        kname, fn, _ = backward_of(rt, cp, cg, spec, arrays, cfg, pos, kw, mode, cs.WIDTH, cs.HEIGHT, dev)
        ms = [cs.cuda_ms(fn, REPS) for _ in range(ROUNDS)]
        torch.cuda.synchronize()
        cs.log(f"({name}) {kname} alone at {cs.WIDTH}x{cs.HEIGHT} x16 AA: {ms} ms ({smi})")
        out["ms"][name] = ms
        out["gate"][name] = err
        lay = cg.GradLayout.of(spec, cfg)
        if kname == "fused_bwd_kernel" and not lay.long and hasattr(lay, "row_in_smem"):
            # The per-thread build's scenes in the warp-row build too.
            _, fn_w, plain_w = backward_of(rt, cp, cg, spec, arrays, cfg, pos, kw, mode, GATE_W, GATE_H, dev,
                                           warp_rows=True)
            out["gate"][name + " warp rows"] = cs.grad_class(
                f"({name}) gate {GATE_W}x{GATE_H}: the warp-row build vs the plain version", fn_w(), plain_w())
            _, fn_w, _ = backward_of(rt, cp, cg, spec, arrays, cfg, pos, kw, mode, cs.WIDTH, cs.HEIGHT, dev,
                                     warp_rows=True)
            out["ms"][name + " warp rows"] = [cs.cuda_ms(fn_w, REPS) for _ in range(ROUNDS)]
            cs.log(f"({name}) the warp-row build alone: {out['ms'][name + ' warp rows']} ms ({smi})")
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def compare(paths) -> int:
    """Prints each case's times in the given files (parent, change, change,
    parent) and the change's mean over the parent's."""
    runs = [json.loads(open(p).read().strip().splitlines()[-1]) for p in paths]
    tags = ["P" if k in (0, len(runs) - 1) else "C" for k in range(len(runs))]
    names = list(runs[0]["ms"]) + [n for r in runs[1:] for n in r["ms"] if n not in runs[0]["ms"]]
    for name in dict.fromkeys(names):
        per = {t: [] for t in "PC"}
        for tag, r in zip(tags, runs):
            per[tag] += r["ms"].get(name, [])
        if not (per["P"] and per["C"]):
            print(f"{name}: " + " | ".join(" ".join(f"{v:.4f}" for v in r["ms"].get(name, [])) for r in runs))
            continue
        ratio = (sum(per["C"]) / len(per["C"])) / (sum(per["P"]) / len(per["P"]))
        cols = " | ".join(" ".join(f"{v:.4f}" for v in r["ms"].get(name, [])) for r in runs)
        print(f"{name}: {cols} ({' '.join(tags)}); change / parent {ratio:.4f}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2:]))
    sys.exit(main())
