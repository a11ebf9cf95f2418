"""The port's scene evaluators and ray generation against raymarch_tpu.

Two torch evaluators of a static tape are checked: `ops.sdf.scene_distance`
(bank-row form, the JAX package's jnp path) and `ops.cuda_march.scene_plain`
(per-leaf form in the op order of the Pallas `_leaf_distance_tile`, the plain
version of the CUDA scene function). Both are held to the JAX
`_apply_static_tape` in f32 and to the f64 NumPy oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops import raygen as raygen_j
from raymarch_tpu.ops import sdf as sdf_j
from raymarch_tpu_torch.ops import cuda_march, raygen as raygen_t, sdf as sdf_t
from raymarch_tpu_torch.ops.cuda_march import scene_buffers

from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores (the
# small ops of the plain versions then run ~10x slower).
torch.set_num_threads(1)

# f32 evaluators of the same formulas: differences are rounding in a few
# ulps of values of order 1-10 (|p| <= 3*sqrt(3)), far inside 1e-5.
ATOL_F32 = 1e-5
# Against the f64 oracle the f32 rounding of the inputs and of ~30 ops per
# leaf accumulates to a few 1e-6; 1e-4 leaves room for the +1e-20 floors
# and the smooth blends.
ATOL_F64 = 1e-4


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(0).uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)


def _jax_static_distance(spec, arrays, pts):
    rows = sdf_j._leaf_row_types(spec)
    lp = jnp.asarray(arrays.leaf_params)
    p = jnp.asarray(pts)

    def leaf_fn(row):
        t, rot = rows[row]
        return sdf_j._single_leaf_distance(p, lp[row], t, rot)

    d = sdf_j._apply_static_tape(
        spec, jnp.asarray(arrays.op_param), leaf_fn, rm.DEFAULT_CONFIG.max_dist, p[:, 0]
    )
    return np.asarray(d)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_plain_matches_jax_and_oracle(name, points):
    scene_j = SCENES[name](rm)
    spec_j, arrays_j = rm.compile_scene(scene_j, static=True)
    spec, arrays = rt.compile_scene(SCENES[name](rt), static=True)
    ref = _jax_static_distance(spec_j, arrays_j, points)
    oracle = rm.oracle.eval_tape(rm.encode_wire(scene_j), points)

    sb = scene_buffers(spec, arrays, "cpu")
    p = torch.as_tensor(points)
    d_tile = cuda_march.scene_plain(
        sb, rt.DEFAULT_CONFIG.max_dist, p[:, 0], p[:, 1], p[:, 2]
    ).numpy()
    d_rows = sdf_t.scene_distance(
        spec, torch.as_tensor(arrays.leaf_params), torch.as_tensor(arrays.op_param),
        p, rt.DEFAULT_CONFIG.max_dist,
    ).numpy()
    for d in (d_tile, d_rows):
        assert d.shape == (4096,) and d.dtype == np.float32
        np.testing.assert_allclose(d, ref, rtol=0, atol=ATOL_F32)
        np.testing.assert_allclose(d, oracle, rtol=0, atol=ATOL_F64)


def test_smooth_ops_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 1000)).astype(np.float32)
    for k in (0.0, 1e-9, 0.1, 0.5):
        for fj, ft in ((sdf_j.smooth_min, sdf_t.smooth_min), (sdf_j.smooth_max, sdf_t.smooth_max)):
            np.testing.assert_allclose(
                ft(torch.as_tensor(a), torch.as_tensor(b), torch.tensor(k)).numpy(),
                np.asarray(fj(jnp.asarray(a), jnp.asarray(b), jnp.float32(k))),
                rtol=0, atol=1e-6,
            )


def test_quat_rotate_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    for fj, ft in ((sdf_j.quat_rotate, sdf_t.quat_rotate), (sdf_j.quat_rotate_inv, sdf_t.quat_rotate_inv)):
        np.testing.assert_allclose(
            ft(torch.as_tensor(q), torch.as_tensor(v)).numpy(),
            np.asarray(fj(jnp.asarray(q), jnp.asarray(v))),
            rtol=0, atol=1e-6,
        )


@pytest.mark.parametrize("aa", [1, 2, 4])
def test_raygen_flat_matches_jax(aa):
    import dataclasses

    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, aa_samples=aa)
    cfg_j = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=aa)
    W, H = 37, 23
    cam = rm.Camera.looking_at(position=(0.3, 1.6, 4.2), target=(0.0, 0.1, 0.0))
    idx = np.arange(W * H * aa * aa, dtype=np.int32)
    oj, dj = raygen_j.raygen_flat(jnp.asarray(idx), cam.position, cam.rotation, W, H, cfg_j)
    ot, dt = raygen_t.raygen_flat(torch.as_tensor(idx), cam.position, cam.rotation, W, H, cfg)
    # Same f32 formulas: agreement to rounding of unit vectors.
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    # The NumPy matrix path (a copy) is bit-identical to the JAX package's.
    cam_t = rt.Camera(cam.position, cam.rotation)
    for a, b in zip(raygen_j.camera_rays_np(cam, W, H, cfg_j), raygen_t.camera_rays_np(cam_t, W, H, cfg)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(raygen_t.aa_offsets(aa), raygen_j.aa_offsets(aa))
