"""The port's fit on one device against the JAX package's.

`raymarch_tpu_torch.make_fit_step` (the fused forward+backward renderer,
torch.optim) against `raymarch_tpu.parallel.make_fit_step` over a 1-device
mesh with the fused VJP in interpret mode (tests/test_parallel_fused.py:
67-91's class); `fit_scene` against a loop of the port's own step;
checkpoints and the watchdog as tests/test_elastic.py holds the JAX ones;
the copied `io` against the reference's.
"""

import dataclasses
import functools
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu import io as io_j
from raymarch_tpu.parallel import make_fit_step as make_fit_step_j
from raymarch_tpu.parallel import make_mesh
from raymarch_tpu_torch import io as io_t
from raymarch_tpu_torch.parallel import FitCheckpointer, Watchdog
from raymarch_tpu_torch.ops.tape import from_reference

from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores (the
# small ops of the plain versions then run ~10x slower).
torch.set_num_threads(1)

# tests/test_parallel_fused.py:19-26, the sphere's material left out.
CFG = dataclasses.replace(
    rm.DEFAULT_CONFIG, aa_samples=2, max_iter=120, min_dist=1e-3, bound_accel=True
)
SCENE = rm.sphere(center=(-0.3, 0, 0), radius=0.9) | rm.box(
    center=(0.8, 0, 0), half_extents=(0.4, 0.4, 0.4)
)
CAM = rm.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0, 0, 0))
W, H = 48, 36
CFG_T = rt.RenderConfig(**dataclasses.asdict(CFG))
CAM_T = rt.Camera(CAM.position, CAM.rotation)


@pytest.fixture(scope="module")
def compiled():
    spec, arrays = rm.compile_scene(SCENE, static=True)
    return (spec, arrays), from_reference(spec, arrays)


def _masks(arrays):
    m_leaf = np.zeros_like(arrays.leaf_params)
    m_leaf[:, 4:8] = 1.0  # centres and the first shape word of every row
    m_op = np.ones_like(arrays.op_param)
    return m_leaf, m_op


def _target():
    return np.zeros((H, W, 3), np.float32) + 0.2


@pytest.fixture(scope="module")
def one_step(compiled):
    """One step of each package from the same parameters: Adam(1e-2) on the
    masked scene words, SGD(1e-2) on the camera pose."""
    (spec_j, arrays_j), (spec, arrays) = compiled
    step_j = make_fit_step_j(
        spec_j, W, H, make_mesh(1), optax.adam(1e-2), CFG, backend="pallas_fused",
        interpret=True, fit_camera=True, camera_optimizer=optax.sgd(1e-2),
        grad_mask=_masks(arrays_j),
    )
    st_j = step_j.init_opt_state(arrays_j, CAM)
    a_j, cam_j, _, loss_j = step_j(arrays_j, CAM, st_j, jnp.asarray(_target()))

    step = rt.make_fit_step(
        spec, W, H, None, functools.partial(torch.optim.Adam, lr=1e-2), CFG_T,
        backend="pallas_fused", fit_camera=True, grad_mask=_masks(arrays),
        camera_optimizer=functools.partial(torch.optim.SGD, lr=1e-2), device="cpu",
    )
    st = step.init_opt_state(arrays, CAM_T)
    out = step(arrays, CAM_T, st, _target())
    ref = (np.asarray(a_j.leaf_params), np.asarray(a_j.op_param),
           np.asarray(cam_j.position), np.asarray(cam_j.rotation), float(loss_j))
    return step, st, step_j.backward_info, ref, out


def test_fit_step_matches_jax(compiled, one_step):
    step, st, info_j, (lp_j, op_j, _, _, loss_j), (a1, _, st1, loss) = one_step
    arrays = compiled[1][1]
    assert st1 is st
    assert loss.shape == () and float(loss) == pytest.approx(loss_j, rel=1e-4)
    np.testing.assert_allclose(a1.leaf_params.numpy(), lp_j, atol=1e-5)
    np.testing.assert_allclose(a1.op_param.numpy(), op_j, atol=1e-5)
    # Masked words did not move; the others did.
    m_leaf, _ = _masks(arrays)
    moved = a1.leaf_params.numpy() != arrays.leaf_params
    assert not moved[m_leaf == 0].any() and moved[m_leaf == 1].any()
    for key in ("kind", "compact", "reason"):
        assert step.backward_info[key] == info_j[key]


def test_fit_camera_matches_jax(compiled, one_step):
    step, _, _, (_, _, pos_j, rot_j, _), (_, cam1, _, _) = one_step
    np.testing.assert_allclose(cam1.position.numpy(), pos_j, atol=1e-5)
    np.testing.assert_allclose(cam1.rotation.numpy(), rot_j, atol=1e-5)
    assert float(torch.linalg.norm(cam1.rotation)) == pytest.approx(1.0, abs=1e-6)
    assert not np.allclose(cam1.position.numpy(), CAM.position)  # the pose moved
    with pytest.raises(ValueError, match="camera"):
        step.init_opt_state(compiled[1][1])


def _fit_target(spec, arrays):
    render = rt.make_renderer(spec, W, H, CFG_T, mode="forward", backend="pallas_prepass", device="cpu")
    return render(arrays, CAM_T)


def _perturbed(arrays):
    lp = arrays.leaf_params.copy()
    lp[0, 4] -= 0.1
    m_leaf = np.zeros_like(lp)
    m_leaf[0, 4] = 1.0
    return dataclasses.replace(arrays, leaf_params=lp), m_leaf


def test_fit_scene_equals_step_loop(compiled):
    _, (spec, arrays) = compiled
    target = _fit_target(spec, arrays)
    a0, m_leaf = _perturbed(arrays)
    logs = []
    res = rt.fit_scene(
        spec, a0, CAM_T, target, width=W, height=H, cfg=CFG_T, steps=4,
        learning_rate=2e-2, leaf_mask=m_leaf, backend="pallas_fused", device="cpu",
        log_every=2, log_fn=logs.append,
    )
    step = rt.make_fit_step(
        spec, W, H, None, functools.partial(torch.optim.Adam, lr=2e-2), CFG_T,
        backend="pallas_fused", grad_mask=(m_leaf, np.ones_like(a0.op_param)), device="cpu",
    )
    st = step.init_opt_state(a0)
    a, losses = a0, []
    for _ in range(4):
        a, _, st, loss = step(a, CAM_T, st, target)
        losses.append(float(loss))
    assert res.losses == losses
    assert torch.equal(res.arrays.leaf_params, a.leaf_params)
    assert res.losses[-1] < res.losses[0]
    assert res.backward_info["kind"] == "pallas_legacy_unrolled"
    assert "leaf_cull disabled" in logs[0] and len(logs) == 4
    assert res.steps_per_sec > 0


@pytest.mark.parametrize(
    "kw,exc",
    [
        # backend "jnp" is ported (tests/test_torch_surfaces_grad.py); its
        # mode "forward" carries no gradient through the march.
        (dict(backend="jnp", mode="forward"), ValueError),
        (dict(backend="pallas_prepass"), ValueError),
        # mode "soft" is ported (tests/test_torch_soft.py); it raises the
        # reference's ValueError where aa_samples^2 does not divide 128.
        (dict(mode="soft", cfg=dataclasses.replace(CFG_T, aa_samples=3)), ValueError),
        # Multi-device is ported (tests/test_torch_parallel.py and
        # tests/test_torch_multiprocess.py run worlds of 2 and 4 ranks): a
        # mesh of two devices in a world of one process raises the
        # reference's ValueError (mesh.py:25-37).
        (dict(mesh=2), ValueError),
        # row_interleave is ported: it trains (None below).
        (dict(row_interleave=2), None),
    ],
    ids=["jnp", "prepass", "soft", "two_devices", "interleave"],
)
def test_fit_step_unported_raise(compiled, kw, exc):
    _, (spec, arrays) = compiled
    kw = {"backend": "pallas_fused", "cfg": CFG_T, **kw}
    opt = functools.partial(torch.optim.SGD, lr=1.0)
    if exc is None:
        # Two bands of 18 rows against the one band of the whole frame: the
        # same loss, the same update up to the order of the bands' sums
        # (tests/test_parallel.py:261-272's class).
        steps = [rt.make_fit_step(spec, W, H, optimizer=opt, device="cpu", **{**kw, "row_interleave": k})
                 for k in (1, 2)]
        assert [s.bands for s in steps] == [[(0, H)], [(0, H // 2), (H // 2, H // 2)]]
        (a1, _, _, l1), (a2, _, _, l2) = (s(arrays, CAM_T, s.init_opt_state(arrays), _target()) for s in steps)
        assert float(l2) == pytest.approx(float(l1), rel=1e-5)
        np.testing.assert_allclose(a2.leaf_params.numpy(), a1.leaf_params.numpy(), atol=1e-4)
        return
    with pytest.raises(exc):
        if "mesh" in kw:
            kw["mesh"] = rt.parallel.make_mesh(kw["mesh"], device="cpu")
        rt.make_fit_step(spec, W, H, optimizer=opt, device="cpu", **kw)


class TestCheckpointer:
    def test_round_trip_and_atomicity(self, compiled, tmp_path):
        _, (spec, arrays) = compiled
        step = rt.make_fit_step(spec, W, H, None, functools.partial(torch.optim.Adam, lr=1e-2),
                                CFG_T, backend="pallas_fused", device="cpu")
        state = step.init_opt_state(arrays)
        _, _, state, _ = step(arrays, CAM_T, state, _target())  # Adam state exists
        ck = FitCheckpointer(str(tmp_path), keep=2)
        assert ck.latest_step() is None
        ck.save(5, spec, arrays, CAM_T, state, [1.0, 0.5])
        ck.save(10, spec, arrays, CAM_T, state, [1.0, 0.5, 0.25])
        ck.save(15, spec, arrays, CAM_T, state, [1.0, 0.5, 0.25, 0.1])
        assert ck.latest_step() == 15
        assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 2  # keep=2
        fresh = step.init_opt_state(arrays)
        n, a, cam, st, losses = ck.restore(spec, fresh)
        assert n == 15 and losses == [1.0, 0.5, 0.25, 0.1] and st is fresh
        np.testing.assert_array_equal(a.leaf_params, arrays.leaf_params)
        np.testing.assert_array_equal(cam.rotation, CAM_T.rotation)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st.optimizer.state_dict()["state"][0][key],
                               state.optimizer.state_dict()["state"][0][key])
        assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]  # atomic publish

    def test_spec_mismatch_raises(self, compiled, tmp_path):
        _, (spec, arrays) = compiled
        step = rt.make_fit_step(spec, W, H, None, functools.partial(torch.optim.Adam, lr=1e-2),
                                CFG_T, backend="pallas_fused", device="cpu")
        state = step.init_opt_state(arrays)
        ck = FitCheckpointer(str(tmp_path))
        ck.save(1, spec, arrays, CAM_T, state, [1.0])
        other, _ = rt.compile_scene(SCENES["all_prims"](rt), static=True)
        with pytest.raises(ValueError, match="different TapeSpec"):
            ck.restore(other, state)

    def test_interrupted_fit_matches_uninterrupted(self, compiled, tmp_path):
        _, (spec, arrays) = compiled
        target = _fit_target(spec, arrays)
        a0, m_leaf = _perturbed(arrays)
        kw = dict(width=W, height=H, cfg=CFG_T, learning_rate=2e-2, leaf_mask=m_leaf,
                  backend="pallas_fused", device="cpu")
        full = rt.fit_scene(spec, a0, CAM_T, target, steps=6, **kw)
        ckdir = str(tmp_path / "ck")
        part = rt.fit_scene(spec, a0, CAM_T, target, steps=3, checkpoint_dir=ckdir, checkpoint_every=2, **kw)
        assert len(part.losses) == 3
        resumed = rt.fit_scene(spec, a0, CAM_T, target, steps=6, checkpoint_dir=ckdir, checkpoint_every=2, **kw)
        assert len(resumed.losses) == 6
        np.testing.assert_allclose(resumed.losses[:3], part.losses, rtol=0, atol=0)
        np.testing.assert_allclose(resumed.losses, full.losses, rtol=1e-6)
        np.testing.assert_allclose(resumed.arrays.leaf_params.numpy(), full.arrays.leaf_params.numpy(), rtol=1e-6)


class TestWatchdog:
    def test_detects_stall_and_recovers(self):
        fired = []
        with Watchdog(0.3, on_stall=lambda s: fired.append(s)) as wd:
            for _ in range(3):
                time.sleep(0.05)
                wd.beat()
            assert not wd.stalled
            time.sleep(0.8)  # no beats: stall
        assert wd.stalled and fired and fired[0] > 0.3

    def test_no_false_positive_under_steady_beats(self):
        with Watchdog(0.5, on_stall=lambda s: None) as wd:
            for _ in range(8):
                time.sleep(0.05)
                wd.beat()
        assert not wd.stalled


@pytest.mark.parametrize("name", sorted(SCENES))
def test_spec_fingerprint_matches_jax(name, tmp_path):
    spec_j, arrays_j = rm.compile_scene(SCENES[name](rm), static=True)
    spec, arrays = from_reference(spec_j, arrays_j)
    assert io_t._spec_fingerprint(spec) == io_j._spec_fingerprint(spec_j)
    # A parameter file written by either package loads in the other.
    io_j.save_params(str(tmp_path / "j.npz"), spec_j, arrays_j)
    got = io_t.load_params(str(tmp_path / "j.npz"), spec)
    np.testing.assert_array_equal(got.leaf_params, arrays.leaf_params)
    io_t.save_params(str(tmp_path / "t.npz"), spec, arrays)
    back = io_j.load_params(str(tmp_path / "t.npz"), spec_j)
    np.testing.assert_array_equal(np.asarray(back.op_param), arrays_j.op_param)
    # Scenes too: a wire tape saved by the port loads in the reference.
    io_t.save_scene(str(tmp_path / "s.npz"), rt.encode_wire(SCENES[name](rt)), camera=[0.0, 1.6, 4.2])
    wire, meta = io_j.load_scene(str(tmp_path / "s.npz"))
    np.testing.assert_array_equal(wire, rm.encode_wire(SCENES[name](rm)))
    assert meta == {"camera": [0.0, 1.6, 4.2]}
