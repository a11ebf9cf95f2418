"""Nothing the benchmark runs imports jax or the JAX package, and the
reference imports nothing of the program: checked in fresh processes, by
the whole top-level name of every module loaded."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LOADED = "import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def _top_level(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code + "\n" + LOADED], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a cell of each kind, on the CPU at a small size, with
    every module of the benchmark imported."""
    code = ("import torch; torch.set_num_threads(2)\n"
            "import bench_port.run, bench_port.control, bench_port.fitcheck\n"
            "from bench_port import spec, harness\n"
            "from bench_port.tests.cells import fit_cell\n"
            "bench = spec.load_benchmark()\n"
            "for m in bench['end_to_end'] + bench['per_layer']: spec.reader(m['name'])\n"
            "for cell in (spec.cell(bench, 'config2.view'), fit_cell()):\n"
            "    harness.run_rank(cell, 3, 0.1, True, 'cpu', size=(24, 16))\n"
            "assert not harness.forbidden_modules()\n")
    top = _top_level(code)
    assert "raymarch_tpu_torch" in top  # the port ran
    assert not top & {"jax", "jaxlib", "flax", "raymarch_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    top = _top_level("import bench_port.reference, bench_port.scene, bench_port.yardstick")
    assert "torch" in top
    assert not top & {"raymarch_tpu_torch", "raymarch_tpu", "jax", "jaxlib", "flax"}
