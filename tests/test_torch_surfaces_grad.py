"""The port's differentiable surfaces of this slice against raymarch_tpu's.

`make_renderer(backend="pallas", mode="implicit")` (K5's forward, the
implicit-function VJP over `make_scene_fn`, torch shading; bench.py's
`fwdbwd_jnp` form, chunked) against the JAX renderer in interpret mode;
the forward backends "pallas", "pallas_image" and
"pallas_full" through `make_renderer`; `make_fit_step` with backends "jnp"
and "pallas" over one step, and `fit_scene`; ROADMAP §3 fault 13.

The reference's own fit steps of these backends do not run on the CPU: its
"jnp" step fails inside `shard_map` in this JAX version (the implicit VJP's
`jax.vjp` over integer tape arrays), and its "pallas" step builds
`make_march_pallas` without `interpret` (render.py:98-101). So the
reference step here is the one `make_fit_step` computes at world size 1,
built from the JAX package's pieces: the loss sum((img - target)^2) / (H W
3) of its renderer, `jax.value_and_grad`, `optax.adam` on the masked scene
words, `optax.sgd` on the pose and the rotation projected to unit norm
(render.py:256-345). Images are held in the exact-semantics class (max |d|
< 1e-3), gradients within 0.01 max|g| (scene words) and 0.02 max|g|
(camera).

The port's flat kernels start every ray at t = 0 under `bound_accel` (the
bounding sphere gives only a miss test and an exit cap), where the JAX
package's flat kernels start at the sphere's entry (ROADMAP §3 fault 15):
a JAX flat backend is the reference here built with `bound_accel=False`.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.parallel import render as render_j
from raymarch_tpu_torch.ops import cuda_march as cm
from raymarch_tpu_torch.ops.tape import from_reference

from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)

CFG = rm.RenderConfig(aa_samples=2, max_iter=60, bound_accel=True)
CFG_R = dataclasses.replace(CFG, relax=1.6)
W = H = 24
CAM = rm.Camera.looking_at(position=(0.0, 1.5, 4.0), target=(0, 0, 0))
CAM_T = rt.Camera(CAM.position, CAM.rotation)
IMG_ATOL = 1e-3  # the exact-semantics class (bench.py:236-259)


def _t(cfg):
    return rt.RenderConfig(**dataclasses.asdict(cfg))


def _compiled(name, static):
    spec_j, arr_j = rm.compile_scene(SCENES[name](rm), static=static)
    return (spec_j, arr_j), from_reference(spec_j, arr_j)


def _grad_close(got, ref, frac):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max())
    if scale == 0.0:  # e.g. the op words of hard ops
        assert float(np.abs(got).max()) == 0.0
        return
    np.testing.assert_allclose(got, ref, atol=frac * scale, rtol=0)


def _grads_j(spec_j, arr_j, backend, mode, chunk=None, cfg=CFG):
    render = rm.make_renderer(spec_j, W, H, cfg, mode=mode, backend=backend, chunk=chunk, interpret=True)

    def loss(lp, opp, pos, rot):
        return jnp.mean(render(dataclasses.replace(arr_j, leaf_params=lp, op_param=opp), rm.Camera(pos, rot)) ** 2)

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(arr_j.leaf_params), jnp.asarray(arr_j.op_param), jnp.asarray(CAM.position),
        jnp.asarray(CAM.rotation))
    return np.asarray(g[0]), np.asarray(g[1]), np.concatenate([np.asarray(g[2]), np.asarray(g[3])])


def _grads_t(spec, arr, backend, mode, chunk=None):
    render = rt.make_renderer(spec, W, H, _t(CFG), mode=mode, backend=backend, chunk=chunk, device="cpu")
    lp = torch.tensor(arr.leaf_params, requires_grad=True)
    opp = torch.tensor(arr.op_param, requires_grad=True)
    pos = torch.tensor(np.asarray(CAM.position, np.float32), requires_grad=True)
    rot = torch.tensor(np.asarray(CAM.rotation, np.float32), requires_grad=True)
    img = render(dataclasses.replace(arr, leaf_params=lp, op_param=opp), rt.Camera(pos, rot))
    torch.mean(img ** 2).backward()
    return lp.grad.numpy(), opp.grad.numpy(), torch.cat([pos.grad, rot.grad]).numpy()


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_march_pallas_gradients_match_jax(static):
    """make_renderer(backend="pallas", mode="implicit") with bound_accel, in
    bench.py's fwdbwd_jnp form (chunked), against the JAX "pallas" renderer
    without the bound (module docstring), against the JAX "jnp" backend
    with it (both march from t = 0), and against itself unchunked."""
    (spec_j, arr_j), (spec, arr) = _compiled("config2", static)
    g_j = _grads_j(spec_j, arr_j, "pallas", "implicit", chunk=512,
                   cfg=dataclasses.replace(CFG, bound_accel=False))
    g_jnp = _grads_j(spec_j, arr_j, "jnp", "implicit")
    g = _grads_t(spec, arr, "pallas", "implicit", chunk=512)
    g_whole = _grads_t(spec, arr, "pallas", "implicit")
    for got, ref, ref_jnp, whole, frac in zip(g, g_j, g_jnp, g_whole, (0.01, 0.01, 0.02)):
        _grad_close(got, ref, frac)
        _grad_close(got, ref_jnp, frac)
        _grad_close(got, whole, 1e-3)  # chunk sums add in another order
    march = cm.make_march_pallas(spec, _t(CFG), device="cpu")
    o, d = rt.raygen_flat(torch.arange(300), CAM.position, CAM.rotation, W, H, _t(CFG))
    t, hit, steps = march(o, d, arr)
    assert not hit.requires_grad and steps.dtype == torch.int32


@pytest.mark.parametrize(
    "backend,case",
    [(b, c) for b in ("pallas", "pallas_image", "pallas_full") for c in ("config2_dynamic", "empty_dynamic")]
    + [("pallas", "painted_dynamic"), ("pallas_image", "all_prims_static_relax"),
       ("pallas_full", "all_prims_static_relax")],
)
def test_backends_match_jax(backend, case):
    """Each forward backend on the default (dynamic) tape, the empty scene,
    and a painted or relaxed scene (K7 with materials: tests/
    test_torch_surfaces.py), against the JAX backend without the bound
    (module docstring)."""
    name, static, cfg = {
        "config2_dynamic": ("config2", False, CFG),
        "painted_dynamic": ("painted_transformed", False, CFG),
        "empty_dynamic": ("empty", False, CFG),
        "all_prims_static_relax": ("all_prims", True, CFG_R),
    }[case]
    (spec_j, arr_j), (spec, arr) = _compiled(name, static)
    img_j = np.asarray(jax.jit(rm.make_renderer(spec_j, W, H, dataclasses.replace(cfg, bound_accel=False),
                                                mode="forward", backend=backend, interpret=True))(arr_j, CAM))
    img = rt.make_renderer(spec, W, H, _t(cfg), mode="forward", backend=backend, device="cpu")(arr, CAM_T)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert np.abs(img.numpy() - img_j).max() < IMG_ATOL


FIT_SCENE = rm.sphere(center=(-0.3, 0, 0), radius=0.9).union(rm.box(center=(0.8, 0, 0), half_extents=(0.4,) * 3),
                                                             k=0.2)


def _reference_step(spec_j, arr_j, backend, mode, masks, target):
    """One step of the reference's fit at world size 1 (see the module
    docstring) -> (leaf_params, op_param, position, rotation, loss)."""
    render = rm.make_renderer(spec_j, W, H, CFG, mode=mode, backend=backend, interpret=True)

    def loss_fn(diff):
        (lp, opp), cam = diff
        img = render(dataclasses.replace(arr_j, leaf_params=lp, op_param=opp), cam)
        return jnp.sum((img - target) ** 2) / float(H * W * 3)

    params = (jnp.asarray(arr_j.leaf_params), jnp.asarray(arr_j.op_param))
    cam = rm.Camera(jnp.asarray(CAM.position), jnp.asarray(CAM.rotation))
    loss, ((g_leaf, g_op), g_cam) = jax.jit(jax.value_and_grad(loss_fn))((params, cam))
    opt, cam_opt = optax.adam(1e-2), optax.sgd(1e-2)
    upd, _ = opt.update((g_leaf * masks[0], g_op * masks[1]), opt.init(params), params)
    lp, opp = (p + u for p, u in zip(params, upd))
    cupd, _ = cam_opt.update(g_cam, cam_opt.init(cam), cam)
    pos = cam.position + cupd.position
    rot = cam.rotation + cupd.rotation
    rot = rot / jnp.maximum(jnp.linalg.norm(rot), 1e-8)
    return np.asarray(lp), np.asarray(opp), np.asarray(pos), np.asarray(rot), float(loss)


@pytest.mark.parametrize("backend,mode", [("jnp", "implicit"), ("jnp", "soft"), ("pallas", "implicit")])
def test_fit_step_matches_reference_step(backend, mode):
    """One step of the port's fit from the same parameters (Adam on the
    centres, SGD on the camera pose) over a dynamic tape, against the
    reference's step (module docstring)."""
    spec_j, arr_j = rm.compile_scene(FIT_SCENE)
    spec, arr = from_reference(spec_j, arr_j)
    m_leaf = np.zeros_like(arr.leaf_params)
    m_leaf[:, 4:7] = 1.0
    m_op = np.ones_like(arr.op_param)
    target = np.zeros((H, W, 3), np.float32) + 0.2
    lp_j, op_j, pos_j, rot_j, loss_j = _reference_step(spec_j, arr_j, backend, mode, (m_leaf, m_op), target)
    step = rt.make_fit_step(spec, W, H, None, functools.partial(torch.optim.Adam, lr=1e-2), _t(CFG),
                            mode=mode, backend=backend, fit_camera=True, grad_mask=(m_leaf, m_op),
                            camera_optimizer=functools.partial(torch.optim.SGD, lr=1e-2), device="cpu")
    kind = "pallas_fwd_jnp_vjp" if backend == "pallas" else f"jnp_{mode}"
    assert step.backward_info == {"kind": kind, "compact": False, "reason": None}
    a, cam, _, loss = step(arr, CAM_T, step.init_opt_state(arr, CAM_T), target)
    assert float(loss) == pytest.approx(loss_j, rel=1e-4)
    # Adam's first step moves each trained word by lr * sign(g) where the
    # gradient is clear of 0; a word whose gradient is ~0 moves less.
    np.testing.assert_allclose(a.leaf_params.numpy(), lp_j, atol=2e-3)
    np.testing.assert_allclose(a.op_param.numpy(), op_j, atol=2e-3)
    np.testing.assert_allclose(cam.position.numpy(), pos_j, atol=1e-4)
    np.testing.assert_allclose(cam.rotation.numpy(), rot_j, atol=1e-4)


def test_fit_scene_trains_through_jnp_and_pallas():
    spec, arr = rt.compile_scene(SCENES["config2"](rt))
    truth = arr.leaf_params
    target = rt.make_renderer(spec, W, H, _t(CFG), mode="forward", device="cpu")(arr, CAM_T)
    start = truth.copy()
    start[0, 4] -= 0.15
    mask = np.zeros_like(truth)
    mask[0, 4] = 1.0
    for backend in ("jnp", "pallas"):
        res = rt.fit_scene(spec, dataclasses.replace(arr, leaf_params=start), CAM_T, target, width=W, height=H,
                           cfg=_t(CFG), steps=6, learning_rate=2e-2, leaf_mask=mask, backend=backend,
                           device="cpu")
        assert res.losses[-1] < res.losses[0]
        assert abs(float(res.arrays.leaf_params[0, 4]) - truth[0, 4]) < 0.15
        assert res.backward_info["kind"] == ("pallas_fwd_jnp_vjp" if backend == "pallas" else "jnp_implicit")


def test_fault13_pallas_fit_step_in_soft_mode():
    """ROADMAP §3 fault 13: the reference's "pallas" fit step unpacks four
    outputs of its three-output march in soft mode (render.py:98-121), so
    its band renderer fails as it is traced; the port raises its
    make_renderer's ValueError when the step is built."""
    spec_j, arr_j = rm.compile_scene(SCENES["config2"](rm))
    band = render_j._local_renderer(spec_j, W, H, CFG, "soft", "pallas", interpret=True)
    with pytest.raises(ValueError, match="unpack"):
        jax.eval_shape(lambda a: band(a, CAM, 0, H), arr_j)
    spec, _ = from_reference(spec_j, arr_j)
    with pytest.raises(ValueError, match="pallas backend"):
        rt.make_fit_step(spec, W, H, None, functools.partial(torch.optim.Adam, lr=1e-2), _t(CFG),
                         mode="soft", backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="pallas backend"):
        rt.make_renderer(spec, W, H, _t(CFG), mode="soft", backend="pallas", device="cpu")


def test_fault15_ray_starts_against_oracle():
    """ROADMAP §3 fault 15, classed against the f64 oracle
    (`oracle_grad.pixel_grads`, which marches from t = 0): a 32x24 frame
    over config 2's torus cut, weighted-pixel-loss gradients of every tape
    word and of the camera, with bound_accel. Both backends land in the
    reference's oracle class (tests/test_pallas_grad.py:277-293): "jnp"
    starts its rays at t = 0, and so does "pallas" (K5's plain version),
    which takes from the bound only its miss test and exit cap. The JAX
    package's Pallas flat kernels start them at the bound's entry, where a
    grazing ray of this frame samples other points and stops on another
    surface, and that one ray moved the gradient by about max|g| (the
    fault, repaired in the port)."""
    from raymarch_tpu.ops.oracle_grad import pixel_grads

    from test_grad_oracle import _word_map

    cfg = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=120, bound_accel=True)
    cam = rm.Camera.looking_at(position=(0.3, 2.4, 2.0), target=(0.0, 0.6, 0.0))
    w, h, s = 32, 24, 4
    scene = SCENES["config2"](rm)
    tape = rm.encode_wire(scene)
    spec_j, arr_j = rm.compile_scene(scene, static=True, rebalance=False)
    wmap = _word_map(tape, spec_j)
    o, d = rm.raygen_flat(jnp.arange(w * h * s, dtype=jnp.int32), jnp.asarray(cam.position, jnp.float64),
                          jnp.asarray(cam.rotation, jnp.float64), w, h, cfg)
    col, dcol, dcam = pixel_grads(tape, np.asarray(o, np.float64), np.asarray(d, np.float64), cfg,
                                  cam_rotation=np.asarray(cam.rotation))
    g = np.random.default_rng(23).uniform(0.5, 1.5, (h, w, 3))
    g_ray = np.repeat(g[:, :, None, :], s, axis=2).reshape(-1, 3) / s
    oracle_words = np.einsum("nc,ncw->w", g_ray, dcol)
    oracle_cam = np.einsum("nc,ncw->w", g_ray, dcam)
    scale, cscale = np.abs(oracle_words).max(), np.abs(oracle_cam).max()
    spec, arr = from_reference(spec_j, arr_j)
    off = {}
    for backend in ("jnp", "pallas"):
        render = rt.make_renderer(spec, w, h, _t(cfg), mode="implicit", backend=backend, device="cpu")
        lp = torch.tensor(arr.leaf_params, requires_grad=True)
        opp = torch.tensor(arr.op_param, requires_grad=True)
        pos = torch.tensor(np.asarray(cam.position, np.float32), requires_grad=True)
        rot = torch.tensor(np.asarray(cam.rotation, np.float32), requires_grad=True)
        img = render(dataclasses.replace(arr, leaf_params=lp, op_param=opp), rt.Camera(pos, rot))
        torch.sum(img * torch.tensor(g, dtype=torch.float32)).backward()
        words = np.zeros(len(tape))
        for wd, m in wmap.items():
            words[wd] = lp.grad[m[1], m[2]] if m[0] == "leaf" else opp.grad[m[1]]
        gcam = torch.cat([pos.grad, rot.grad]).numpy()
        np.testing.assert_allclose(words, oracle_words, rtol=3e-2, atol=1e-3 * scale)
        rel = np.abs(words - oracle_words) / (np.abs(oracle_words) + 1e-3 * scale)
        assert np.median(rel) < 1e-2
        np.testing.assert_allclose(gcam, oracle_cam, rtol=3e-2, atol=1e-3 * cscale)
        off[backend] = (np.abs(words - oracle_words).max() / scale, np.abs(gcam - oracle_cam).max() / cscale)
    assert off["jnp"][0] < 1e-2 and off["jnp"][1] < 1e-2
    assert off["pallas"][0] < 1e-2 and off["pallas"][1] < 1e-2, off
