"""Finding a cell's parts by name: `BENCHMARK.json` at the checkout's root
names each configuration, traffic mix and metric, and each lives in a file
of its own under this directory:

- a configuration: `configs/<config>.json` (the `file` of its entry);
- a traffic mix: `workloads/<traffic>.json`;
- the limits of a cell's correctness numbers: `limits/<cell>.json`;
- a metric: `metrics/<metric>.py`, whose `read(run)` returns the number
  or None where the run gave it nothing to read.

Adding a cell is adding these files and its entry in `BENCHMARK.json`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str, root: Path = ROOT, limits: dict = None) -> dict:
    """{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} of the cell `name`: its entry, the parsed files, and the
    metric entries that this cell reports. `limits` stands in for the
    cell's limits file (tests of a cell that has none yet)."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / c["file"]) as f:
        config = json.load(f)
    with open(HERE / "workloads" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    if limits is None:
        with open(HERE / "limits" / f"{name}.json") as f:
            limits = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"workload": w, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_port.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
