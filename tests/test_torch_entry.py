"""The port's entry points (`raymarch_tpu_torch.entry`) against the JAX
package's `__graft_entry__.py`, on the CPU.

`entry(device="cpu")`'s forward render of the flagship scene at 128x128 is
held against the JAX `entry()`'s (both are the "jnp" march of the same
tape) in the exact-semantics class (max|d| < 1e-3) on every row where the
JAX frame itself is in that class against the f64 oracle, and in bench.py's
accelerated class on the whole frame. The rows left out are the horizon's:
there the floor's far hit points sit within min_dist of a checker edge,
and a sample whose f32 stop lands across it flips its colour by 0.23 / S
(0.0579 at S = 4): the JAX frame misses the oracle on 8 pixels of row 5 so,
and the port's on those and 4 more. And
`dryrun_multichip(2)` runs the sharded frame and both fit steps over a gloo
world of two processes and prints the reference's OK line.
"""

import os
import sys

import numpy as np
import torch

import jax

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu_torch import entry as entry_t

from test_torch_render import _assert_gate_class

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import __graft_entry__ as entry_j  # noqa: E402

torch.set_num_threads(1)


def test_entry_matches_the_jax_entry():
    fn, (arrays, cam) = entry_t.entry(device="cpu")
    img = fn(arrays, cam).numpy()
    fn_j, (arrays_j, cam_j) = entry_j.entry()
    ref = np.asarray(jax.jit(fn_j)(arrays_j, cam_j))
    assert img.shape == ref.shape == (128, 128, 3)
    assert np.isfinite(img).all() and img.max() > 0.05
    oracle = rt.oracle.render(rt.encode_wire(entry_t.flagship_scene()), cam, 128, 128,
                              rt.RenderConfig(aa_samples=2, max_iter=64))
    horizon = np.abs(ref - oracle).max(axis=(1, 2)) >= 1e-3  # rows where JAX leaves the exact class
    assert horizon.sum() <= 2, np.flatnonzero(horizon)
    assert np.abs(img - ref)[~horizon].max() < 1e-3
    _assert_gate_class(img, ref)
    np.testing.assert_array_equal(arrays.leaf_params, np.asarray(arrays_j.leaf_params))
    assert isinstance(cam_j, rm.Camera)


def test_dryrun_multichip_two_ranks(capsys):
    entry_t.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): loss=") and line.endswith(" OK"), line
    loss = float(line.split("loss=")[1].split()[0])
    fused = float(line.split("fused_loss=")[1].split()[0])
    assert np.isfinite(loss) and np.isfinite(fused) and loss > 0 and fused > 0
