"""The port's cone-prepass passes against the JAX Pallas kernels.

The JAX renderer runs in interpret mode on the CPU, as tests/test_prepass.py
runs it; the port's wrappers run their plain versions on CPU tensors (the
CUDA kernels are held to those plain versions on the card by chip_smoke.py
and tests/test_torch_cuda.py).
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops.pallas_march import compute_bound as compute_bound_j
from raymarch_tpu.ops.pallas_prepass import cone_omega as cone_omega_j
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as render_aa_j
from raymarch_tpu_torch.ops import cuda_grad as cg
from raymarch_tpu_torch.ops import cuda_prepass as cp
from raymarch_tpu_torch.ops.cuda_march import compute_bound, scene_buffers

from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores (the
# small ops of the plain versions then run ~10x slower).
torch.set_num_threads(1)

W, H = 65, 47  # non-multiples of the lane count and of any tile
CFG = dataclasses.replace(
    rm.DEFAULT_CONFIG, aa_samples=2, max_iter=80, bound_accel=True, exit_check_every=4
)
CAM = rm.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))


def _cfg_t(cfg):
    return rt.RenderConfig(**dataclasses.asdict(cfg))


def _cv_j(cam):
    return jnp.asarray(np.concatenate([cam.position, cam.rotation, [0.0]]).astype(np.float32))


def _cv_t(cam):
    return rt.cam_vec(rt.Camera(cam.position, cam.rotation), device="cpu")


def _unflat(v):
    """JAX prepass plane (padded flat pixel layout) -> f32[H, W]."""
    return np.asarray(v).reshape(-1)[: H * W].reshape(H, W)


def _assert_images_close(img, ref):
    # tests/test_prepass.py's class: mean agreement tight; isolated
    # silhouette/crease pixels may flip within the min_dist hit tolerance.
    d = np.abs(img - ref)
    assert d.mean() < 1e-3, f"mean diff {d.mean()}"
    assert (d > 1e-3).mean() < 0.03, f"frac>1e-3 {(d > 1e-3).mean()}"
    assert (d > 0.3).mean() == 0.0, f"max diff {d.max()}"


@pytest.fixture(scope="module")
def compiled():
    return (
        rm.compile_scene(SCENES["config2"](rm), static=True),
        rt.compile_scene(SCENES["config2"](rt), static=True),
    )


@pytest.fixture(scope="module")
def jax_planes(compiled):
    """JAX coarse planes (t0, status) f32[H, W] with bound_accel on / off."""
    (spec_j, arrays_j), _ = compiled
    out = {}
    for bound in (True, False):
        cfg = dataclasses.replace(CFG, bound_accel=bound)
        rnd = render_aa_j(
            spec_j, cfg, W, H, interpret=True, prepass_block=1, aa_packed=True, bm_coarse=8
        )
        out[bound] = tuple(_unflat(v) for v in rnd.coarse(arrays_j, _cv_j(CAM)))
    return out


@pytest.mark.parametrize("bound", [True, False], ids=["bound", "nobound"])
def test_coarse_plain_matches_jax(compiled, jax_planes, bound):
    _, (spec, arrays) = compiled
    rp = cp.make_pallas_image_render_aa(
        spec, _cfg_t(dataclasses.replace(CFG, bound_accel=bound)), W, H, device="cpu"
    )
    t0, status = (v.numpy() for v in rp.coarse(arrays, _cv_t(CAM)))
    t0_j, status_j = jax_planes[bound]
    assert t0.shape == status.shape == (H, W)
    # Status may flip only where the centre ray grazes the cone threshold.
    assert (status == status_j).mean() >= 0.99
    assert 0 < status.sum() < H * W  # both hits and misses in frame
    both = (status == 1) & (status_j == 1)
    # Same f32 step formula from the same start: rounding only.
    np.testing.assert_allclose(t0[both], t0_j[both], rtol=1e-4)


def test_fine_plain_matches_jax(compiled, jax_planes):
    (spec_j, arrays_j), (spec, arrays) = compiled
    t0_j, status_j = jax_planes[True]
    rnd = render_aa_j(
        spec_j, CFG, W, H, interpret=True, prepass_block=1, aa_packed=True, bm_coarse=8
    )
    pre_j = [jnp.asarray(v.reshape(-1)) for v in (t0_j, status_j)]
    ref = np.asarray(rnd.fine(arrays_j, _cv_j(CAM), pre_j))
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu")
    # The same prepass planes feed both fine passes, so each is judged alone.
    img = rp.fine(arrays, _cv_t(CAM), (torch.tensor(t0_j), torch.tensor(status_j)))
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    _assert_images_close(img.numpy(), ref)
    # And the port's whole frame (its own prepass) against the JAX frame.
    _assert_images_close(rp(arrays, _cv_t(CAM)).numpy(), np.asarray(rnd(arrays_j, _cv_j(CAM))))


def test_no_prepass_strict_semantics(compiled):
    # Every AA ray marches from t=0 with plain steps: the reference's exact
    # march semantics, so only f32 reassociation separates the two
    # (tests/test_prepass.py:241-242).
    (spec_j, arrays_j), (spec, arrays) = compiled
    cfg = dataclasses.replace(CFG, bound_accel=False)
    ref = np.asarray(
        render_aa_j(spec_j, cfg, W, H, interpret=True, aa_packed=True, no_prepass=True)(
            arrays_j, _cv_j(CAM)
        )
    )
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, H, device="cpu", no_prepass=True)
    img = rp(arrays, _cv_t(CAM)).numpy()
    d = np.abs(img - ref)
    assert d.max() < 1e-3 and d.mean() < 1e-5, (d.max(), d.mean())


def test_cpu_wrappers_run_plain_versions(compiled):
    _, (spec, arrays) = compiled
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu")
    scene, cam, bound = rp.scene_args(arrays, _cv_t(CAM))
    before = (cp.coarse.launches, cp.fine.launches)
    pre = cp.coarse(scene, cam, bound, rp.params)
    pre_plain = cp.coarse_plain(scene, cam, bound, rp.params)
    for a, b in zip(pre, pre_plain):
        assert torch.equal(a, b)
    assert torch.equal(
        cp.fine(scene, cam, bound, rp.params, *pre),
        cp.fine_plain(scene, cam, bound, rp.params, *pre),
    )
    assert (cp.coarse.launches, cp.fine.launches) == before  # no kernel ran


def test_wrappers_check_inputs(compiled):
    _, (spec, arrays) = compiled
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu")
    scene, cam, bound = rp.scene_args(arrays, _cv_t(CAM))
    with pytest.raises(TypeError):
        cp.coarse(scene, cam.double(), bound, rp.params)
    with pytest.raises(ValueError):
        cp.coarse(scene, cam[:7], bound, rp.params)
    with pytest.raises(ValueError):
        cp.fine(scene, cam, bound, rp.params, torch.zeros(H, W + 1), torch.zeros(H, W + 1))
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        cp.coarse(scene, meta, bound, rp.params)


@pytest.mark.parametrize("aa,block", [(4, 1), (2, 1), (1, 1), (4, 4)])
def test_cone_omega_matches_jax(aa, block):
    cfg = dataclasses.replace(CFG, aa_samples=aa)
    assert cp.cone_omega(_cfg_t(cfg), 1920, 1080, block) == cone_omega_j(cfg, 1920, 1080, block)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compute_bound_matches_jax(name):
    spec_j, arrays_j = rm.compile_scene(SCENES[name](rm), static=True)
    spec, arrays = rt.compile_scene(SCENES[name](rt), static=True)
    ref = np.asarray(compute_bound_j(spec_j, arrays_j))
    got = compute_bound(spec, arrays)
    assert got.dtype == np.float32 and got.shape == (8,)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_params_layout_matches_cuda_struct():
    """The ctypes mirrors, the Python params and the C structs list the same
    fields in the same order, all 4 bytes wide (no padding): RenderParams,
    then BlockParams, then the soft-mode constants that the soft builds
    take in their own structs (SoftParams of the fine kernel, SoftRes of
    the backwards: two pointers, then two floats), then the unpacked fine
    pass's flags (the layout, and the shared normal K4 takes as a launch
    argument)."""
    csrc = Path(cp.__file__).parent.parent / "csrc"
    src = (csrc / "render_common.cuh").read_text()
    all_ct = []
    for struct, mirror in (("RenderParams", cp._CParams), ("BlockParams", cp._CBlockParams)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", src, re.S).group(1)
        c_fields = re.findall(r"^\s*(?:int32_t|float)\s+(\w+)", body, re.M)
        ct_fields = [name for name, _ in mirror._fields_]
        assert c_fields == ct_fields
        n_words = sum(
            3 if name in ("light", "albedo", "floor_base") else 1 for name in ct_fields
        )
        assert ctypes.sizeof(mirror) == 4 * n_words
        all_ct += ct_fields
    soft = ["soft", "beta_inv", "soft_infl", "soft_gate"]
    unpacked = ["unpacked", "shared_normals"]
    assert all_ct + soft + unpacked == [f.name for f in dataclasses.fields(cp.PrepassParams)]
    for path, struct, mirror in (("fine.cuh", "SoftParams", cp._CSoftParams),
                                 ("scene_grad.cuh", "SoftRes", cg._CSoftRes)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", (csrc / path).read_text(), re.S).group(1)
        c_fields = re.findall(r"^\s*(?:const )?float\*?\s+(\w+);", body, re.M)
        assert c_fields == [name for name, _ in mirror._fields_]
        assert ctypes.sizeof(mirror) == 2 * 8 + 2 * 4
    p = cp.PrepassParams.make(_cfg_t(CFG), W, H)
    c = cp._CParams.of(p)
    assert c.width == W and c.naa == 2 and tuple(c.light) == p.light
    assert np.float32(c.omega) == np.float32(p.omega)


def test_scene_buffers_layout(compiled):
    _, (spec, arrays) = compiled
    sb = scene_buffers(spec, arrays, "cpu")
    tape = sb.tape.numpy()
    assert tape.dtype == np.int32 and tape.shape == (3, len(spec.static_tape))
    # The device tape is the real-instruction prefix of the compiled streams.
    n = len(spec.static_tape)
    np.testing.assert_array_equal(tape[0], arrays.tape_ops[:n])
    np.testing.assert_array_equal(tape[1], arrays.tape_arg[:n])
    np.testing.assert_array_equal(tape[2], arrays.out_slot[:n])
    with pytest.raises(ValueError):
        scene_buffers(spec, dataclasses.replace(arrays, op_param=arrays.op_param[:-1]), "cpu")
