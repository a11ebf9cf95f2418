"""The control, the reference put in the program's place in bfloat16 (the
precision below the configurations' float32), comes out not correct: on the
CPU at a small size, and on the card (marked cuda) at each cell's own size
on three seeds."""

import pytest
import torch

from bench_port import control, harness, spec
from bench_port.tests.cells import fit_cell

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["config2.view", "config2.fit", "spheres64.view4k"])
def test_the_control_fails_on_the_cpu(name):
    cell = fit_cell() if name == "config2.fit" else spec.cell(spec.load_benchmark(), name)
    limits = cell["limits"]
    for line in control.readings(cell, [5], "control", seconds=0.1, device="cpu", size=(48, 27), warmup=0):
        assert not harness.passes(harness.checks([line["readings"]], limits))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    from bench_port.run import _kernel_dir

    _kernel_dir()
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config2.view", "spheres64.view4k"])
def test_the_control_fails_at_the_cells_size(card, name):
    limits = spec.cell(spec.load_benchmark(), name)["limits"]
    for line in control.readings(name, [4000000101, 4000000102, 4000000103], "control", seconds=0.1, device=card,
                                 warmup=0):
        assert not harness.passes(harness.checks([line["readings"]], limits)), line
