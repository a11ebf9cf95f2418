"""The port's binding of the native (C++) tape core against raymarch_tpu's.

raymarch_tpu_torch carries a copy of `raymarch_tpu.native` (numpy only)
that loads the same `native/libtape_core.so`. tests/test_native.py's cases
run here through both bindings: the two give equal results (one library),
and the port's agrees with the port's numpy oracle within test_native.py's
tolerances. The numpy fallbacks (no library) are held equal to the
reference's fallbacks, and a library the port builds for a host that lacks
one lands outside `native/`.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu import native as nat_j
from raymarch_tpu_torch import native as nat_t

pytestmark = pytest.mark.skipif(not nat_j.available(), reason="native toolchain unavailable")


def _scenes(m):
    return [
        m.sphere(center=(0.3, -0.2, 0.1), radius=0.8),
        (m.sphere(radius=1.2) & m.box()) - m.torus(minor_radius=0.4),
        m.sphere().union(m.box(center=(1, 0, 0)), k=0.5).round(0.1),
        m.box().rotate_axis_angle((1, 1, 0), 0.8) | m.plane(offset=2.0),
        m.box().subtract(m.sphere(radius=1.1), k=0.3).onion(0.07),
    ]


N_SCENES = len(_scenes(rt))


def _tape(i):
    tape = rt.encode_wire(_scenes(rt)[i])
    np.testing.assert_array_equal(tape, rm.encode_wire(_scenes(rm)[i]))
    return tape


@pytest.fixture
def fallback(monkeypatch):
    """Both bindings without their library: the numpy fallbacks run."""
    for mod in (nat_j, nat_t):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)


def test_the_port_loads_the_library():
    assert nat_t.available()
    assert os.path.samefile(nat_t._lib._name, nat_t._LIB_PATH)


@pytest.mark.parametrize("i", range(N_SCENES))
def test_eval_matches_reference_and_numpy_oracle(i, rng):
    tape = _tape(i)
    pts = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    d_t = nat_t.eval_tape(tape, pts)
    np.testing.assert_array_equal(d_t, nat_j.eval_tape(tape, pts))
    np.testing.assert_allclose(d_t, rt.oracle.eval_tape(tape, pts), rtol=1e-5, atol=1e-5)


def test_empty_tape():
    d = nat_t.eval_tape(np.zeros(0, np.uint32), np.zeros((4, 3)), 100.0)
    np.testing.assert_allclose(d, 100.0)
    np.testing.assert_array_equal(d, nat_j.eval_tape(np.zeros(0, np.uint32), np.zeros((4, 3)), 100.0))


def test_validate():
    tape = _tape(1)
    assert nat_t.validate(tape) == nat_j.validate(tape) == (5, 2)


@pytest.mark.parametrize("garbage", [[100], [0, 0]], ids=["union_on_empty_stack", "truncated_sphere"])
def test_validate_rejects_garbage(garbage):
    for nat in (nat_t, nat_j):
        with pytest.raises(ValueError):
            nat.validate(np.array(garbage, dtype=np.uint32))


def test_march_matches_reference_and_numpy():
    tape = _tape(0)
    cam = rt.Camera.looking_at(position=(0.0, 1.0, 4.0), target=(0, 0, 0))
    o, d = rt.camera_rays_np(cam, 16, 16, rt.DEFAULT_CONFIG)
    o = o.reshape(-1, 3)[:256]
    d = d.reshape(-1, 3)[:256]
    t_n, hit_n = nat_t.march(tape, o, d)
    t_j, hit_j = nat_j.march(tape, o, d)
    np.testing.assert_array_equal(t_n, t_j)
    np.testing.assert_array_equal(hit_n, hit_j)
    t_p, hit_p = rt.oracle.march(tape, o, d)
    assert (hit_n == hit_p).all()
    np.testing.assert_allclose(t_n[hit_n], t_p[hit_n], atol=1e-4)


def test_sphere_union_matches_python_encoder(rng):
    spheres = rng.uniform(-2, 2, (17, 4)).astype(np.float32)
    spheres[:, 3] = np.abs(spheres[:, 3]) + 0.1
    t_native = nat_t.build_sphere_union(spheres)
    np.testing.assert_array_equal(t_native, nat_j.build_sphere_union(spheres))
    node = None
    for cx, cy, cz, r in spheres:
        s = rt.sphere(center=(cx, cy, cz), radius=float(r))
        node = s if node is None else (node | s)
    np.testing.assert_array_equal(t_native, rt.encode_wire(node))


def test_large_procedural_scene(rng):
    """BASELINE config 5 scale: a 64-primitive procedural scene encodes and
    evaluates consistently through the native path."""
    spheres = rng.uniform(-4, 4, (64, 4)).astype(np.float32)
    spheres[:, 3] = np.abs(spheres[:, 3]) * 0.3 + 0.1
    tape = nat_t.build_sphere_union(spheres)
    assert nat_t.validate(tape) == (127, 2)  # a left-leaning chain
    pts = rng.uniform(-4, 4, (128, 3)).astype(np.float32)
    d_native = nat_t.eval_tape(tape, pts)
    np.testing.assert_allclose(d_native, rt.oracle.eval_tape(tape, pts), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i", range(N_SCENES))
def test_fallbacks_match_reference_fallbacks(fallback, i, rng):
    assert not nat_t.available() and not nat_j.available()
    tape = _tape(i)
    pts = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(nat_t.eval_tape(tape, pts), nat_j.eval_tape(tape, pts))
    assert nat_t.validate(tape) == nat_j.validate(tape)
    cam = rt.Camera.looking_at(position=(0.0, 1.0, 4.0), target=(0, 0, 0))
    o, d = rt.camera_rays_np(cam, 8, 8, rt.DEFAULT_CONFIG)
    o, d = o.reshape(-1, 3)[:64], d.reshape(-1, 3)[:64]
    for a, b in zip(nat_t.march(tape, o, d), nat_j.march(tape, o, d)):
        np.testing.assert_array_equal(a, b)
    spheres = np.abs(rng.uniform(0.1, 2, (5, 4))).astype(np.float32)
    np.testing.assert_array_equal(nat_t.build_sphere_union(spheres), nat_j.build_sphere_union(spheres))


def test_build_goes_outside_native(monkeypatch, tmp_path):
    """Without native/libtape_core.so the port builds the library into its
    build directory (here a temporary one) and leaves native/ as it was."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on this host")
    before = {f: hashlib.sha256(open(os.path.join(nat_t._NATIVE_DIR, f), "rb").read()).hexdigest()
              for f in sorted(os.listdir(nat_t._NATIVE_DIR))}
    monkeypatch.setattr(nat_t, "_LIB_PATH", str(tmp_path / "absent" / "libtape_core.so"))
    monkeypatch.setattr(nat_t, "_BUILD_PATH", str(tmp_path / "build" / "libtape_core.so"))
    monkeypatch.setattr(nat_t, "_lib", None)
    monkeypatch.setattr(nat_t, "_tried", False)
    assert nat_t.available()
    assert os.path.samefile(nat_t._lib._name, tmp_path / "build" / "libtape_core.so")
    tape = _tape(2)
    pts = np.random.default_rng(1).uniform(-3, 3, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(nat_t.eval_tape(tape, pts), rt.oracle.eval_tape(tape, pts), rtol=1e-5, atol=1e-5)
    after = {f: hashlib.sha256(open(os.path.join(nat_t._NATIVE_DIR, f), "rb").read()).hexdigest()
             for f in sorted(os.listdir(nat_t._NATIVE_DIR))}
    assert after == before
