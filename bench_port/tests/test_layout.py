"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix, limit and metric loads from its own file by name, and a new cell is
only new files."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_loads_from_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["kind"] in ("frames", "fit")
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_the_contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_port"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_port/")
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_is_new_files(tmp_path):
    """Copy the benchmark, add a traffic mix, its limits and a workload entry,
    and load and run the new cell (on the CPU, at a small size) without
    touching any code."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "config2.view1", "config": "config2", "traffic": "view1", "chips": 1,
                               "why": "one frame in flight"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "bench_port/workloads/view.json").read_text())
    traffic.update(in_flight=1, check_frames=1, warmup_frames=1)
    (tmp_path / "bench_port/workloads/view1.json").write_text(json.dumps(traffic))
    (tmp_path / "bench_port/limits/config2.view1.json").write_text(
        (ROOT / "bench_port/limits/config2.view.json").read_text())
    code = ("import torch; torch.set_num_threads(2)\n"
            "from bench_port import spec, harness\n"
            "cell = spec.cell(spec.load_benchmark(), 'config2.view1')\n"
            "run = harness.run_rank(cell, 7, 0.2, False, 'cpu', size=(32, 18))\n"
            "print(cell['traffic']['in_flight'], run.units, sorted(run.readings))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    inflight, units, keys = out.stdout.strip().splitlines()[-1].split(" ", 2)
    assert inflight == "1" and int(units) >= 1 and "mean_abs" in keys
    assert not math.isnan(float(units))
