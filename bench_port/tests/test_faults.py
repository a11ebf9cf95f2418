"""The check catches a broken timed path: a run of the cell, on the CPU at a
small size and without the harness's look for a card, with a fault planted
underneath, comes out not correct against the cell's own limits; the same
run without the fault comes out correct."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import harness, spec
from bench_port.tests.cells import fit_cell

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[2]
SIZE = (48, 27)


def _verdict(name, **kw):
    cell = fit_cell() if name == "config2.fit" else spec.cell(spec.load_benchmark(), name)
    run = harness.run_rank(cell, 2**31 + 77, 0.2, False, "cpu", size=SIZE, **kw)
    return harness.passes(harness.checks([run.readings], cell["limits"]))


@pytest.mark.parametrize("name", ["config2.view", "spheres64.view4k"])
def test_sound_frames_pass(name):
    assert _verdict(name)


@pytest.mark.parametrize("name", ["config2.view", "spheres64.view4k"])
@pytest.mark.parametrize("fault", ["stale", "half", "alter"])
def test_a_broken_frame_fails(name, fault):
    assert not _verdict(name, fault=fault)


def test_the_sound_fit_passes():
    assert _verdict("config2.fit", program="reference")


@pytest.mark.parametrize("fault", ["stale", "half", "alter", "negate"])
def test_a_broken_fit_step_fails(fault):
    assert not _verdict("config2.fit", program="reference", fault=fault)


RANK = """
import json, sys, torch
torch.set_num_threads(1)
from bench_port import harness, spec
from raymarch_tpu_torch.parallel import initialize_multihost, make_mesh
rank, world, port, fault, name = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
initialize_multihost(f"localhost:{port}", world, rank, backend="gloo", device="cpu", initialization_timeout=60)
cell = spec.cell(spec.load_benchmark(), name)
cell["traffic"] = dict(cell["traffic"], entry="make_sharded_renderer", row_interleave=2, stop_every=2)
run = harness.run_rank(cell, 11, 0.3, fault == "none", "cpu", mesh=make_mesh(device="cpu"), size=(48, 27),
                       fault=None if fault == "none" else fault, trace_seconds=0.3)
print(json.dumps({"readings": run.readings, "units": run.units, "traced": run.trace and run.trace.units}))
"""


def _ranks(world, fault, name="spheres64.view4k"):
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(world), str(port), fault, name], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    parts = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        parts.append(json.loads(out.strip().splitlines()[-1]))
    return parts


@pytest.mark.parametrize("fault", ["none", "no_gather"])
def test_the_exchange_between_ranks(fault):
    """Two gloo ranks of the row-sharded frame, 2 bands each, agreeing on the
    stop every 2 frames: every rank's gathered frame is checked; without the
    gather (each rank keeps its own bands) the run fails, and both ranks
    stop after the same frame."""
    parts = _ranks(2, fault)
    cell = spec.cell(spec.load_benchmark(), "spheres64.view4k")
    assert parts[0]["units"] == parts[1]["units"] >= 1
    if fault == "none":  # the traced window after the measured one: the ranks agree again
        assert parts[0]["traced"] == parts[1]["traced"] >= 2
    assert harness.passes(harness.checks([p["readings"] for p in parts], cell["limits"])) == (fault == "none")
