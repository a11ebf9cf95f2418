"""The readings that the limits of `correct` are set from, many seeds in one
process (the benchmark's own runs never run this):

    python3 -m bench_port.control --workload <name> --seeds 1,2,3 \\
        [--program port|control|reference] [--fault stale|half|alter|negate] [--seconds 1]

For each seed it runs the cell's set-up, a short window at the cell's own
sizes and load, and the check, with the port (the sound readings), the
control (the reference in the program's place in bfloat16) or the
reference in float32 with a planted fault (`program.FAULTS`), and prints
one JSON line of readings a seed. `--device cpu --size W H` runs it on the
CPU at a small size (the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from bench_port.program import FAULTS


def readings(cell, seeds, program="port", fault=None, seconds=1.0, device="cuda:0", size=None, warmup=None):
    """Yield {"seed", "program", "fault", "readings", "units"} a seed;
    `cell` is a cell's name in BENCHMARK.json, or the cell (`spec.cell`)."""
    from bench_port import harness, spec

    if isinstance(cell, str):
        cell = spec.cell(spec.load_benchmark(), cell)
    cell_name = cell["workload"]["name"]
    for seed in seeds:
        t = time.perf_counter()
        run = harness.run_rank(cell, seed, seconds, False, device, program=program, fault=fault, size=size,
                               warmup=warmup)
        yield {"cell": cell_name, "seed": seed, "program": program, "fault": fault, "readings": run.readings,
               "units": run.units, "seconds": time.perf_counter() - t, "reference_s": run.reference_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="correctness readings of a cell over many seeds")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--program", default="port", choices=("port", "control", "reference"))
    ap.add_argument("--fault", default=None, choices=FAULTS)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--size", type=int, nargs=2, default=None)
    a = ap.parse_args(argv)
    from bench_port.run import _cache_dirs

    _cache_dirs()
    import torch

    if a.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("bench_port.control: CUDA is not available", file=sys.stderr)
            return 2
        from bench_port.run import _kernel_dir

        _kernel_dir()
    for line in readings(a.workload, [int(s) for s in a.seeds.split(",")], a.program, a.fault, a.seconds,
                         a.device, tuple(a.size) if a.size else None, a.warmup):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
