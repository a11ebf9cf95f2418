"""The port's f64 oracle and analytic gradient oracle agree with
raymarch_tpu's, bit for bit.

raymarch_tpu_torch carries copies of `ops/oracle.py` and
`ops/oracle_grad.py` (numpy only), so that the port is checked against the
oracle where jax is not installed. These tests guard the copies against
drift: the same wire tape (every primitive, op, transform and `.paint`,
and the empty scene) and the same points or rays through each package's
functions give equal arrays, bit for bit (`assert_array_equal`: NaNs must
match too). Importing the copies loads neither jax nor raymarch_tpu.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops import oracle as or_j
from raymarch_tpu.ops import oracle_grad as og_j
from raymarch_tpu_torch.ops import oracle as or_t
from raymarch_tpu_torch.ops import oracle_grad as og_t

from test_torch_tape import SCENES

W, H = 12, 9
CFG_J = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=60)
CFG_T = rt.RenderConfig(**dataclasses.asdict(CFG_J))
POS, TARGET = (0.3, 1.4, 3.8), (0.0, 0.0, 0.0)


def _tape(name):
    tape = rm.encode_wire(SCENES[name](rm))
    np.testing.assert_array_equal(tape, rt.encode_wire(SCENES[name](rt)))
    return tape


def _points(n=300, seed=3):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (n, 3)).astype(np.float32)


def _rays():
    """The reference's camera rays of the W x H frame, flat [N, 3] each."""
    cam = rm.Camera.looking_at(position=POS, target=TARGET)
    o, d = rm.camera_rays_np(cam, W, H, CFG_J)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _same(fn_t, fn_j, *args_t_j):
    """fn_t(*args) and fn_j(*args) return equal arrays or raise the same
    error; args_t_j pairs each argument as (port's, reference's)."""
    try:
        ref = fn_j(*(a[1] for a in args_t_j))
    except Exception as e:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(type(e), match=str(e)):
            fn_t(*(a[0] for a in args_t_j))
        return
    _equal(fn_t(*(a[0] for a in args_t_j)), ref)


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_eval_tape_and_colour_bit_identical(name):
    tape, pts = _tape(name), _points()
    _equal(or_t.eval_tape(tape, pts), or_j.eval_tape(tape, pts))
    _equal(or_t.eval_tape(tape, pts, CFG_T), or_j.eval_tape(tape, pts, CFG_J))
    _equal(or_t.eval_tape_color(tape, pts, CFG_T), or_j.eval_tape_color(tape, pts, CFG_J))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_march_normals_shade_render_bit_identical(name):
    tape = _tape(name)
    o, d = _rays()
    t_j, hit_j = or_j.march(tape, o, d, CFG_J)
    _equal(or_t.march(tape, o, d, CFG_T), (t_j, hit_j))
    pos = o + d * t_j[:, None]
    _equal(or_t.calculate_normals(tape, pos, CFG_T), or_j.calculate_normals(tape, pos, CFG_J))
    _equal(or_t.shade(tape, o, d, t_j, hit_j, CFG_T), or_j.shade(tape, o, d, t_j, hit_j, CFG_J))
    img = or_t.render(tape, rt.Camera.looking_at(position=POS, target=TARGET), W, H, CFG_T)
    assert img.shape == (H, W, 3)
    _equal(img, or_j.render(tape, rm.Camera.looking_at(position=POS, target=TARGET), W, H, CFG_J))
    if name != "empty":
        assert hit_j.any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tape_gradients_bit_identical(name):
    tape, pts = _tape(name), _points(120)
    for fn_t, fn_j in ((og_t.eval_tape_grads, og_j.eval_tape_grads),
                       (og_t.eval_tape_color_grads, og_j.eval_tape_color_grads)):
        _same(fn_t, fn_j, (tape, tape), (pts, pts), (CFG_T, CFG_J))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pixel_grads_bit_identical(name):
    tape = _tape(name)
    o, d = _rays()
    o, d = o[::3], d[::3]
    _equal(og_t.pixel_grads(tape, o, d, CFG_T), og_j.pixel_grads(tape, o, d, CFG_J))
    cam = rm.Camera.looking_at(position=POS, target=TARGET)
    got = og_t.pixel_grads(tape, o, d, CFG_T, cam_rotation=cam.rotation)
    ref = og_j.pixel_grads(tape, o, d, CFG_J, cam_rotation=cam.rotation)
    assert len(ref) == 3
    _equal(got, ref)


def test_oracle_and_native_import_neither_jax_nor_the_reference():
    """A fresh interpreter imports the copies, and the port's configs, entry
    and utilities, without loading jax or any module of raymarch_tpu."""
    code = (
        "import sys\n"
        "import raymarch_tpu_torch.ops.oracle, raymarch_tpu_torch.ops.oracle_grad, raymarch_tpu_torch.native\n"
        "import raymarch_tpu_torch.examples.configs, raymarch_tpu_torch.entry\n"
        "import raymarch_tpu_torch.utils.profiling, raymarch_tpu_torch.utils.cache\n"
        "import raymarch_tpu_torch as rt\n"
        "assert rt.oracle is raymarch_tpu_torch.ops.oracle and rt.native is raymarch_tpu_torch.native\n"
        "assert rt.io.__name__ == 'raymarch_tpu_torch.io'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'raymarch_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
