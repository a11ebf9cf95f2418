"""The port's torch reference renderer against raymarch_tpu's jnp one.

`ops.sdf.make_scene_fn` / `make_scene_color_fn` (static and dynamic tapes,
the empty scene), `ops.march.make_march` in its three modes and
`make_march_soft`, `render_rays`, and `make_renderer(backend="jnp")` in its
four modes, held against `raymarch_tpu.ops.sdf` / `ops.march` on the same
scene and camera, and the images against the f64 NumPy oracle. Images are
in the exact-semantics class (max |d| < 1e-3), gradients of two f32
implementations within 0.01 max|g| (scene words) and 0.02 max|g| (camera).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops import march as march_j
from raymarch_tpu.ops import sdf as sdf_j
from raymarch_tpu_torch.ops import march as march_t
from raymarch_tpu_torch.ops import sdf as sdf_t
from raymarch_tpu_torch.ops.tape import from_reference

from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)

CFG = rm.RenderConfig(aa_samples=2, max_iter=60)
CFG_T = rt.RenderConfig(**dataclasses.asdict(CFG))
W, H = 24, 18
POS = (0.0, 1.5, 4.0)
CAM = rm.Camera.looking_at(position=POS, target=(0, 0, 0))
CAM_T = rt.Camera(CAM.position, CAM.rotation)
# Two f32 evaluators of one formula: a few ulps of values of order 1-10.
ATOL_D = 1e-5
IMG_ATOL = 1e-3  # the exact-semantics class (bench.py:236-259)


def _compiled(name, static):
    spec_j, arr_j = rm.compile_scene(SCENES[name](rm), static=static)
    return (spec_j, arr_j), from_reference(spec_j, arr_j)


def _points(n=2048, seed=0):
    return np.random.default_rng(seed).uniform(-3.0, 3.0, (n, 3)).astype(np.float32)


def _rays(n=700):
    idx = jnp.arange(n, dtype=jnp.int32)
    o, d = rm.raygen_flat(idx, CAM.position, CAM.rotation, W, H, CFG)
    return np.asarray(o), np.asarray(d)


def _grad_close(got, ref, frac):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max())
    if scale == 0.0:  # e.g. the op words of hard ops
        assert float(np.abs(got).max()) == 0.0
        return
    np.testing.assert_allclose(got, ref, atol=frac * scale, rtol=0)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_fn_matches_jax(name, static):
    (spec_j, arr_j), (spec, arr) = _compiled(name, static)
    pts = _points()
    d_j = np.asarray(sdf_j.make_scene_fn(spec_j, CFG)(jnp.asarray(pts), arr_j))
    d_t = sdf_t.make_scene_fn(spec, CFG_T)(torch.as_tensor(pts), arr).numpy()
    np.testing.assert_allclose(d_t, d_j, atol=ATOL_D, rtol=0)
    if static:  # the static and dynamic forms of one scene agree
        _, (spec_d, arr_d) = _compiled(name, False)
        d_d = sdf_t.make_scene_fn(spec_d, CFG_T)(torch.as_tensor(pts), arr_d).numpy()
        np.testing.assert_allclose(d_d, d_t, atol=ATOL_D, rtol=0)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("name", ["painted_transformed", "ops", "empty"])
def test_scene_color_fn_matches_jax(name, static):
    (spec_j, arr_j), (spec, arr) = _compiled(name, static)
    pts = _points(1024, 1)
    d_j, c_j = (np.asarray(v) for v in sdf_j.make_scene_color_fn(spec_j, CFG)(jnp.asarray(pts), arr_j))
    d_t, c_t = sdf_t.make_scene_color_fn(spec, CFG_T)(torch.as_tensor(pts), arr)
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=ATOL_D, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), c_j, atol=1e-6, rtol=0)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_scene_fn_gradients_match_jax(static):
    """The scene function is differentiable with respect to leaf_params and
    op_param through autograd, on both tape forms."""
    (spec_j, arr_j), (spec, arr) = _compiled("ops", static)
    pts = _points(512, 2)
    w = np.random.default_rng(3).normal(size=512).astype(np.float32)
    scene_j = sdf_j.make_scene_fn(spec_j, CFG)

    def loss_j(lp, opp):
        return jnp.sum(jnp.asarray(w) * scene_j(jnp.asarray(pts), dataclasses.replace(arr_j, leaf_params=lp,
                                                                                       op_param=opp)))

    g_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(arr_j.leaf_params), jnp.asarray(arr_j.op_param))
    lp = torch.tensor(arr.leaf_params, requires_grad=True)
    opp = torch.tensor(arr.op_param, requires_grad=True)
    d = sdf_t.make_scene_fn(spec, CFG_T)(torch.as_tensor(pts), dataclasses.replace(arr, leaf_params=lp,
                                                                                      op_param=opp))
    torch.sum(torch.as_tensor(w) * d).backward()
    _grad_close(lp.grad.numpy(), g_j[0], 1e-4)
    _grad_close(opp.grad.numpy(), g_j[1], 1e-4)


@pytest.mark.parametrize("mode", ["forward", "implicit", "unrolled", "soft"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_march_matches_jax(mode, static):
    (spec_j, arr_j), (spec, arr) = _compiled("config2", static)
    o, d = _rays()
    if mode == "soft":
        out_j = march_j.make_march_soft(spec_j, CFG)(jnp.asarray(o), jnp.asarray(d), arr_j)
        out_t = march_t.make_march_soft(spec, CFG_T)(torch.as_tensor(o), torch.as_tensor(d), arr)
    else:
        out_j = jax.jit(march_j.make_march(spec_j, CFG, mode))(jnp.asarray(o), jnp.asarray(d), arr_j)
        out_t = march_t.make_march(spec, CFG_T, mode)(torch.as_tensor(o), torch.as_tensor(d), arr)
    t_j, hit_j = np.asarray(out_j[0]), np.asarray(out_j[1])
    t_t, hit_t = out_t[0].detach().numpy(), out_t[1].numpy()
    np.testing.assert_array_equal(hit_t, hit_j)
    m = hit_j > 0.5
    assert m.any() and (~m).any()
    np.testing.assert_allclose(t_t[m], t_j[m], atol=1e-4, rtol=0)
    if mode == "soft":
        np.testing.assert_allclose(out_t[2].detach().numpy(), np.asarray(out_j[2]), atol=1e-4, rtol=0)
    else:
        np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("name", ["config2", "painted_transformed", "empty"])
def test_jnp_renderer_matches_jax_and_oracle(name, static):
    (spec_j, arr_j), (spec, arr) = _compiled(name, static)
    img_j = np.asarray(jax.jit(rm.make_renderer(spec_j, W, H, CFG, mode="forward"))(arr_j, CAM))
    img_t = rt.make_renderer(spec, W, H, CFG_T, mode="forward", device="cpu")(arr, CAM_T)
    assert img_t.shape == (H, W, 3) and img_t.dtype == torch.float32
    assert np.abs(img_t.numpy() - img_j).max() < IMG_ATOL
    img_o = rm.oracle.render(rm.encode_wire(SCENES[name](rm)), CAM, W, H, CFG)
    assert np.abs(img_t.numpy() - img_o).max() < IMG_ATOL


def _jax_grads(spec_j, arr_j, mode, chunk=None):
    render = rm.make_renderer(spec_j, W, H, CFG, mode=mode, chunk=chunk)

    def loss(lp, opp, pos, rot):
        img = render(dataclasses.replace(arr_j, leaf_params=lp, op_param=opp), rm.Camera(pos, rot))
        return jnp.mean(img ** 2)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(arr_j.leaf_params), jnp.asarray(arr_j.op_param), jnp.asarray(CAM.position),
        jnp.asarray(CAM.rotation))


def _torch_grads(spec, arr, mode, chunk=None, backend="jnp"):
    render = rt.make_renderer(spec, W, H, CFG_T, mode=mode, chunk=chunk, backend=backend, device="cpu")
    lp = torch.tensor(arr.leaf_params, requires_grad=True)
    opp = torch.tensor(arr.op_param, requires_grad=True)
    pos = torch.tensor(np.asarray(CAM.position, np.float32), requires_grad=True)
    rot = torch.tensor(np.asarray(CAM.rotation, np.float32), requires_grad=True)
    img = render(dataclasses.replace(arr, leaf_params=lp, op_param=opp), rt.Camera(pos, rot))
    torch.mean(img ** 2).backward()
    return img.detach(), (lp.grad, opp.grad, pos.grad, rot.grad)


@pytest.mark.parametrize("mode", ["implicit", "soft", "unrolled"])
def test_jnp_renderer_gradients_match_jax(mode):
    (spec_j, arr_j), (spec, arr) = _compiled("config2" if mode == "soft" else "ops", False)
    g_j = _jax_grads(spec_j, arr_j, mode)
    _, g_t = _torch_grads(spec, arr, mode)
    _grad_close(g_t[0].numpy(), g_j[0], 0.01)
    _grad_close(g_t[1].numpy(), g_j[1], 0.01)
    _grad_close(torch.cat(g_t[2:]).numpy(), np.concatenate([np.asarray(g) for g in g_j[2:]]), 0.02)


@pytest.mark.parametrize("mode", ["implicit", "soft"])
def test_chunk_equals_no_chunk(mode):
    """`chunk` renders in chunks and recomputes their shading in the
    backward: the image and the gradients are those of one chunk."""
    _, (spec, arr) = _compiled("config2", True)
    img1, g1 = _torch_grads(spec, arr, mode)
    img2, g2 = _torch_grads(spec, arr, mode, chunk=500)
    torch.testing.assert_close(img2, img1, atol=0, rtol=0)
    # The same terms, summed per chunk and then over the chunks: the order
    # of the f32 sums moves the last bits.
    for a, b in zip(g2, g1):
        _grad_close(a.numpy(), b.numpy(), 1e-4)


def test_render_rays_matches_jax():
    (spec_j, arr_j), (spec, arr) = _compiled("rotated", True)
    o, d = _rays(500)
    c_j = np.asarray(rm.render_rays(spec_j, arr_j, jnp.asarray(o), jnp.asarray(d), CFG, mode="forward"))
    c_t = rt.render_rays(spec, arr, torch.as_tensor(o), torch.as_tensor(d), CFG_T, mode="forward")
    assert np.abs(c_t.numpy() - c_j).max() < IMG_ATOL


def test_exports_and_raygen_match_jax():
    """The package exports the reference's surface of this slice; its
    raygen_flat and camera_rays_np give the JAX package's rays."""
    for name in ("make_march", "render_rays", "raygen_flat", "camera_rays_np", "make_scene_fn", "MarchStats",
                 "march_stats"):
        assert name in rt.__all__ and hasattr(rt, name)
    idx = np.arange(W * H * 4, dtype=np.int32)
    o_j, d_j = rm.raygen_flat(jnp.asarray(idx), CAM.position, CAM.rotation, W, H, CFG)
    o_t, d_t = rt.raygen_flat(torch.as_tensor(idx), CAM.position, CAM.rotation, W, H, CFG_T)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=0)
    for a, b in zip(rt.camera_rays_np(CAM_T, W, H, CFG_T), rm.camera_rays_np(CAM, W, H, CFG)):
        np.testing.assert_array_equal(a, b)
