"""The fit's correctness numbers over every start of a fit traffic, on the
card at the configuration's size: the port's timed path, its torch path,
the control and planted faults side by side (the benchmark's own runs
never run this). It reproduces why `config2.fit` has no limits yet:

    python3 -m bench_port.fitcheck --paths pallas_fused,jnp,control,negate,half,alter

prints one JSON line a start and path: the harness's `loss_gap`,
`grad_gap`, `step_gap` and `step_diff`, the median leaf's gaps, and the
cosine of the whole first gradient against the reference's. A path is a
backend of `make_fit_step` ("pallas_fused", "jnp"), "control" (the
reference in bfloat16 in the program's place) or a fault of
`program.FAULTS` planted in the reference in float32.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys


def numbers(prog, k: int, want: dict, cam, steps: int) -> dict:
    """The compared numbers of the first `steps` steps of `prog` from start
    k against the reference's `want` (reference.fit)."""
    import numpy as np
    import torch

    from bench_port import harness

    prog.reset(k)
    v0, losses = prog.values(), []
    for s in range(steps):
        losses.append(float(prog.step(cam)))
        if s == 0:
            g1 = prog.first_grad()
    v_end = prog.values()
    keys = harness.moved_leaves(want["grad1"])
    change = {q: v_end[q].cpu() - v0[q].cpu() for q in v0}
    ref_change = {q: want["params"][-1][q] - want["params"][0][q] for q in v0}
    gg = harness._norm_gaps(g1, want["grad1"], keys)
    sd = harness._diff_gaps(change, ref_change, keys)
    gp = torch.cat([g1[q].reshape(-1).float().cpu() for q in keys])
    gr = torch.cat([want["grad1"][q].reshape(-1).float().cpu() for q in keys])
    return {"start": k,
            "loss_gap": max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                            for a, b in zip(losses, want["losses"])),
            "grad_gap": max(gg), "grad_gap_worst": keys[int(np.argmax(gg))], "grad_gap_median": statistics.median(gg),
            "step_gap": max(harness._norm_gaps(change, ref_change, keys)),
            "step_diff": max(sd), "step_diff_median": statistics.median(sd),
            "cosine": float(gp @ gr / (gp.norm() * gr.norm()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the fit's correctness numbers over every start")
    ap.add_argument("--paths", default="pallas_fused,jnp")
    ap.add_argument("--config", default="config2")
    ap.add_argument("--traffic", default="fit")
    ap.add_argument("--starts", default=None, help="comma-separated starts (default: all)")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--size", type=int, nargs=2, default=None)
    a = ap.parse_args(argv)
    from bench_port.run import _cache_dirs

    _cache_dirs()
    import numpy as np
    import torch

    from bench_port import reference as ref
    from bench_port import scene as sc
    from bench_port import spec
    from bench_port.program import PortFit, ReferenceFit

    if a.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("bench_port.fitcheck: CUDA is not available", file=sys.stderr)
            return 2
        from bench_port.run import _kernel_dir

        _kernel_dir()
    with open(spec.HERE / "configs" / f"{a.config}.json") as f:
        config = json.load(f)
    with open(spec.HERE / "workloads" / f"{a.traffic}.json") as f:
        traffic = json.load(f)
    dev = torch.device(a.device)
    r = config["render"]
    width, height = a.size or (config["width"], config["height"])
    desc = sc.describe(config["scene"], 0)
    cam = sc.orbit_camera(config["camera"], 0.0)
    rng = np.random.default_rng(int(traffic["start_seed"]))
    starts = [sc.perturb(desc, rng, float(traffic["perturb"])) for _ in range(int(traffic["starts"]))]
    picked = [int(k) for k in a.starts.split(",")] if a.starts else range(len(starts))
    steps, lr = int(traffic["check_steps"]), float(traffic["lr"])
    with torch.no_grad():
        target, _ = ref.render(ref.Scene(desc, torch.float32, dev), cam, r, width, height)
    wants = {k: ref.fit(starts[k], cam, target, r, width, height, steps, lr, torch.float32, dev) for k in picked}
    for path in a.paths.split(","):
        if path in ("pallas_fused", "jnp"):
            progs = [PortFit(starts, r, width, height, dict(traffic, backend=path), dev, target)] * len(picked)
        else:
            dtype = torch.bfloat16 if path == "control" else torch.float32
            fault = None if path == "control" else path
            progs = [ReferenceFit(starts, r, width, height, traffic, dev, target, dtype, fault=fault)
                     for _ in picked]
        for prog, k in zip(progs, picked):
            print(json.dumps(dict(numbers(prog, k, wants[k], cam, steps), path=path)), flush=True)
        del progs
    return 0


if __name__ == "__main__":
    sys.exit(main())
