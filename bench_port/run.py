"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this directory and
the port (`raymarch_tpu_torch`). It measures the port on the card: it
exits with code 2, printing no result, without CUDA or with fewer cards
than the cell asks for. A cell on several cards runs one process per
card (NCCL ranks on localhost) and rank 0 reports its metrics.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared with its
limit; the same checks end standard error. With `--trace 1`,
`device.busy_s` and `device.window_s` come from one trace, rank 0's: its
merged device time without NCCL's kernels, and its traced window, which on
several cards opens once every rank's profiler records.

Build and kernel caches stay inside the checkout: the port's kernel
library in `build/raymarch_tpu_torch/`, and `TORCH_EXTENSIONS_DIR` and
`TRITON_CACHE_DIR` under `build/bench_port/`.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()
EPOCH0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 340


def _cache_dirs() -> None:
    """The caches inside the checkout, and one host thread for torch's and
    OpenMP's CPU work: the load comes from this one process."""
    os.environ["OMP_NUM_THREADS"] = "1"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "bench_port" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "bench_port" / "triton")


def _kernel_dir() -> None:
    from raymarch_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache(str(ROOT / "build" / "raymarch_tpu_torch"))


def power_limit_w():
    """The card's power limit, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def summarize(cell: dict, run, trace: bool) -> dict:
    """One rank's numbers: its metrics by the cell's readers, its trace's
    busy time, window and breakdown, its readings and counts."""
    from bench_port import spec

    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"metrics": metrics, "readings": run.readings, "failed": run.failed, "attempted": run.units,
           "memory_peak_bytes": run.memory_peak_bytes, "reference_s": run.reference_s, "units": run.units,
           "window_s": run.window_s}
    if trace and run.trace is not None:
        out["busy_s"] = run.trace.busy_s
        out["compute_busy_s"] = run.trace.compute_busy_s
        out["trace_window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    return out


def device_time(parts: list) -> tuple:
    """(busy_s, window_s) of the result line, both from rank 0's trace: its
    device time without NCCL's kernels, which spin while they wait for the
    other ranks, and its traced window; so busy_s <= window_s. One card runs
    no NCCL kernel, and its busy time is its whole device time."""
    lead = parts[0]
    return lead["compute_busy_s"], lead["trace_window_s"]


def assemble(cell: dict, parts: list, trace: bool, forbidden: list) -> dict:
    """The result line from the ranks' summaries (rank 0 first); in a
    traced run `device.busy_s` and `window_s` are rank 0's (`device_time`)."""
    import torch

    from bench_port import harness

    lead = parts[0]
    checks = harness.checks([p["readings"] for p in parts], cell["limits"])
    failed = sum(p["failed"] for p in parts)
    correct = failed == 0 and not forbidden and harness.passes(checks)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(parts),
              "memory_peak_bytes": max(p["memory_peak_bytes"] for p in parts), "power_limit_w": power_limit_w()}
    result = {"correct": correct, "attempted": lead["attempted"], "failed": failed, "metrics": lead["metrics"],
              "device": device}
    if trace and "compute_busy_s" in lead:
        device["busy_s"], device["window_s"] = device_time(parts)
        result["breakdown"] = lead["breakdown"]
    result["checks"] = checks
    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(args, chips: int) -> list:
    """Run the cell's ranks, one process a card, and return their summaries
    in rank order; raises if a rank fails. No rank is left running."""
    port = _free_port()
    cmd = [sys.executable, "-m", "bench_port.run", "--workload", args.workload, "--seed", str(args.seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace), "--world", str(chips), "--port", str(port),
           "--epoch", repr(EPOCH0)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for r in range(chips)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    parts = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} failed with exit code {p.returncode}")
        parts.append(json.loads(out.strip().splitlines()[-1]))
    return parts


def rank_main(args, cell: dict) -> int:
    """One rank of a cell on several cards (`--rank`): joins the NCCL group
    on localhost, runs, prints its summary as its last line."""
    import torch
    import torch.distributed as dist

    from bench_port import harness
    from raymarch_tpu_torch.parallel import initialize_multihost, make_mesh

    dev = torch.device(f"cuda:{args.rank}")
    torch.cuda.set_device(dev)
    initialize_multihost(f"localhost:{args.port}", args.world, args.rank, retries=3, retry_delay=1.0,
                         initialization_timeout=120, backend="nccl", device=dev)
    try:
        mesh = make_mesh(device=dev)
        t0 = time.perf_counter() - (time.time() - args.epoch)
        run = harness.run_rank(cell, args.seed, args.seconds, bool(args.trace), dev, mesh=mesh, t0=t0)
        part = summarize(cell, run, bool(args.trace))
        part["forbidden"] = harness.forbidden_modules()
    finally:
        dist.destroy_process_group()
    print(json.dumps(part), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--epoch", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    _cache_dirs()
    from bench_port import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    chips = int(cell["workload"]["chips"])
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: the cell {args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    _kernel_dir()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.rank is not None:
        return rank_main(args, cell)

    from bench_port import harness

    if chips == 1:
        run = harness.run_rank(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t0=T0)
        parts = [summarize(cell, run, bool(args.trace))]
        parts[0]["forbidden"] = []
    else:
        parts = spawn_ranks(args, chips)
    forbidden = sorted(set(harness.forbidden_modules()).union(*(p["forbidden"] for p in parts)))
    if forbidden:
        print(f"bench_port: modules of jax or the JAX package were loaded: {', '.join(forbidden)}", file=sys.stderr)
        return 3
    result = assemble(cell, parts, bool(args.trace), forbidden)
    lead = parts[0]
    print(f"bench_port: {lead['units']} units in {lead['window_s']:.3f} s; reference check "
          f"{max(p['reference_s'] for p in parts):.1f} s", file=sys.stderr)
    for r, p in enumerate(parts):
        if "compute_busy_s" in p:
            print(f"bench_port: rank {r} traced: busy {p['busy_s']!r} s, without NCCL {p['compute_busy_s']!r} s, "
                  f"window {p['trace_window_s']!r} s", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
