"""The port's remaining render surfaces against raymarch_tpu's.

The plain versions of K5 (`make_pallas_ray_march`), K6
(`make_pallas_image_march`) and K7 (`make_pallas_image_render`), and of the
fine kernel's march-only build (`make_pallas_image_march_fast`), against the
JAX kernels in interpret mode, at the sizes of tests/test_pallas.py, on
static, dynamic, empty, painted and relaxed scenes, and the reference's
ValueErrors (the gradients, backends and fits of this slice:
tests/test_torch_surfaces_grad.py). Hit flags are held equal on every ray,
t within 1e-5 on hits, images in the exact-semantics class (max |d| <
1e-3).

The port's flat kernels start every ray at t = 0 and take from
`bound_accel` only the bounding sphere's miss test and exit cap, so the
bound leaves hit and t as they are and only lowers steps
(raymarch_tpu/config.py's promise). The JAX flat kernels start a bounded
ray at the sphere's entry, which moves a grazing ray's samples, so the
reference of a bounded case is the JAX kernel built with
`bound_accel=False`: steps are equal on hits and no larger elsewhere.
Without the bound, steps are equal on every ray.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops import pallas_march as pm_j
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_march_fast as march_fast_j
from raymarch_tpu_torch.ops import cuda_march as cm
from raymarch_tpu_torch.ops import cuda_prepass as cp
from raymarch_tpu_torch.ops.tape import from_reference

from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)

CFG = rm.RenderConfig(aa_samples=2, max_iter=60)
CFG_B = dataclasses.replace(CFG, bound_accel=True)
CFG_R = dataclasses.replace(CFG, bound_accel=True, relax=1.6)
CONFIGS = {"plain": CFG, "bound": CFG_B, "relax": CFG_R}
W = H = 24
CAM = rm.Camera.looking_at(position=(0.0, 1.5, 4.0), target=(0, 0, 0))
CAM_T = rt.Camera(CAM.position, CAM.rotation)
CV = np.concatenate([CAM.position, CAM.rotation, [0.0]]).astype(np.float32)
IMG_ATOL = 1e-3  # the exact-semantics class (bench.py:236-259)

# scene, tape form, config
CASES = {
    "config2_static": ("config2", True, "bound"),
    "config2_dynamic": ("config2", False, "bound"),
    "empty_dynamic": ("empty", False, "bound"),
    "painted_dynamic": ("painted_transformed", False, "plain"),
    "config2_dynamic_relax": ("config2", False, "relax"),
    "all_prims_static_relax": ("all_prims", True, "relax"),
}


def _t(cfg):
    return rt.RenderConfig(**dataclasses.asdict(cfg))


def _case(case):
    name, static, c = CASES[case]
    spec_j, arr_j = rm.compile_scene(SCENES[name](rm), static=static)
    return CONFIGS[c], (spec_j, arr_j), from_reference(spec_j, arr_j)


def _unbounded(cfg):
    """The JAX reference's config for the port's `cfg`: its flat kernels
    march from t = 0 only without the bound (module docstring)."""
    return dataclasses.replace(cfg, bound_accel=False)


def _march_equal(got, ref, bounded):
    """hit equal, t within 1e-5 on hits; steps equal on every ray, or, where
    only `got` had the bound, equal on hits and no larger elsewhere."""
    t, hit, steps = (np.asarray(v) for v in got)
    t_j, hit_j, steps_j = (np.asarray(v) for v in ref)
    np.testing.assert_array_equal(hit, hit_j)
    m = hit_j > 0.5
    np.testing.assert_allclose(t[m], t_j[m], atol=1e-5, rtol=0)
    if bounded:
        np.testing.assert_array_equal(steps[m], steps_j[m])
        assert (steps <= steps_j).all()
    else:
        np.testing.assert_array_equal(steps, steps_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k5_plain_matches_jax(case):
    cfg, (spec_j, arr_j), (spec, arr) = _case(case)
    n = 1024 + 130  # no multiple of the reference's tile
    o, d = (np.asarray(v) for v in rm.raygen_flat(jnp.arange(n, dtype=jnp.int32), CAM.position, CAM.rotation,
                                                  48, 48, cfg))
    ref = jax.jit(pm_j.make_pallas_ray_march(spec_j, _unbounded(cfg), True))(arr_j, o, d)
    got = cm.make_pallas_ray_march(spec, _t(cfg), device="cpu")(arr, torch.as_tensor(o), torch.as_tensor(d))
    assert got[2].dtype == torch.int32
    _march_equal(got, ref, cfg.bound_accel)


@pytest.mark.parametrize("case", ["config2_static", "config2_dynamic_relax"])
def test_k5_chunks_match_one_call(case):
    """K5 through `make_pallas_ray_march` in the chunks `make_renderer(
    chunk=...)` makes (the last one shorter) gives, ray for ray, what one
    call over every ray gives; the wrappers raise on rays and bounds they
    do not take."""
    cfg, _, (spec, arr) = _case(case)
    n, chunk = 1000, 256
    o, d = (v.contiguous() for v in rt.raygen_flat(torch.arange(n), CAM.position, CAM.rotation, 48, 48, _t(cfg)))
    march = cm.make_pallas_ray_march(spec, _t(cfg), device="cpu")
    whole = march(arr, o, d)
    parts = [march(arr, o[i:i + chunk], d[i:i + chunk]) for i in range(0, n, chunk)]
    for k in range(3):
        assert torch.equal(torch.cat([q[k] for q in parts]), whole[k])
    fm = march.flat
    sc, _, bound = fm.scene_args(arr)
    for k, v in enumerate(cm.ray_march(sc, bound, fm.params, o, d)):
        assert torch.equal(v, whole[k])
    with pytest.raises(ValueError, match="origins has shape"):
        march(arr, o[:, :2], d)
    with pytest.raises(ValueError, match="dirs has shape"):
        cm.ray_march(sc, bound, fm.params, o, d[:-1])
    with pytest.raises(TypeError, match="origins has dtype"):
        cm.ray_march(sc, bound, fm.params, o.double(), d)
    with pytest.raises(ValueError, match="dirs is not contiguous"):
        cm.ray_march(sc, bound, fm.params, o, torch.stack([d[:, 0], d[:, 1], d[:, 2]], dim=1).t().contiguous().t())
    with pytest.raises(ValueError, match="bound has shape"):
        cm.ray_march(sc, bound[:4], fm.params, o, d)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k6_plain_matches_jax(case):
    cfg, (spec_j, arr_j), (spec, arr) = _case(case)
    ref = jax.jit(pm_j.make_pallas_image_march(spec_j, _unbounded(cfg), W, H, True))(arr_j, jnp.asarray(CV))
    got = cm.make_pallas_image_march(spec, _t(cfg), W, H, device="cpu")(arr, torch.as_tensor(CV))
    assert got[0].shape == (W * H * 4,)
    _march_equal(got, ref, cfg.bound_accel)
    st = rt.march_stats(got[2], got[1])
    assert st.n_rays == W * H * 4 and st.max_steps == int(np.asarray(got[2]).max())
    assert st.max_steps <= int(np.asarray(ref[2]).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_k7_plain_matches_jax(case):
    cfg, (spec_j, arr_j), (spec, arr) = _case(case)
    ref = jax.jit(pm_j.make_pallas_image_render(spec_j, _unbounded(cfg), W, H, True))(arr_j, jnp.asarray(CV))
    got = cm.make_pallas_image_render(spec, _t(cfg), W, H, device="cpu")(arr, torch.as_tensor(CV))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    img = torch.stack(got, dim=-1).reshape(H, W, 4, 3).mean(dim=2).numpy()
    img_j = np.stack([np.asarray(r) for r in ref], axis=-1).reshape(H, W, 4, 3).mean(axis=2)
    assert np.abs(img - img_j).max() < IMG_ATOL


def _flat_run(kernel, spec, arr, cfg, cv):
    """K5 (over K6's rays), K6 or K7 through their plain versions -> a
    tuple of tensors (t, hit, steps; or r, g, b)."""
    if kernel == "k5":
        o, d = (v.contiguous() for v in rt.raygen_flat(torch.arange(W * H * 4), cv[:3], cv[3:7], W, H, cfg))
        return cm.make_pallas_ray_march(spec, cfg, device="cpu")(arr, o, d)
    factory = cm.make_pallas_image_march if kernel == "k6" else cm.make_pallas_image_render
    return factory(spec, cfg, W, H, device="cpu")(arr, torch.as_tensor(cv))


CAM_IN = rm.Camera.looking_at(position=(0.0, 0.4, 1.5), target=(0, 0, 0))  # inside config 2's bound
CV_INSIDE = np.concatenate([CAM_IN.position, CAM_IN.rotation, [0.0]]).astype(np.float32)


@pytest.mark.parametrize("kernel", ["k5", "k6", "k7"])
@pytest.mark.parametrize("case", sorted(CASES) + ["config2_static_inside"])
def test_flat_bound_accel_is_exact(case, kernel):
    """The flat kernels start every ray at t = 0 and take from bound_accel
    only the bounding sphere's miss test and its exit cap t_exit +
    min_dist (ROADMAP §3 fault 15): with and without the bound, hit and t
    are bit-equal (K7's colours with them), steps are equal on hits and no
    larger elsewhere, and fewer on some ray where the bound is valid. The
    empty scene and the one with a plane (all_prims) have no valid bound;
    "inside" puts the camera inside config 2's bound."""
    cfg, _, (spec, arr) = _case(case.removesuffix("_inside"))
    cv = CV_INSIDE if case.endswith("_inside") else CV
    on, off = (_flat_run(kernel, spec, arr, _t(dataclasses.replace(cfg, bound_accel=b)), cv) for b in (True, False))
    if kernel == "k7":
        for a, b in zip(on, off):
            assert torch.equal(a, b)
        return
    (t, hit, steps), (t0, hit0, steps0) = on, off
    assert torch.equal(hit, hit0)
    m = hit0 > 0.5
    assert torch.equal(t[m], t0[m]) and torch.equal(steps[m], steps0[m])
    assert bool((steps <= steps0).all())
    if cm.compute_bound(spec, arr)[4] > 0:
        assert bool((steps < steps0).any())
    else:
        assert torch.equal(steps, steps0) and torch.equal(t, t0)


def test_flat_bound_cap_admits_samples_within_min_dist():
    """The exit cap is t_exit + min_dist: a sample past the sphere's exit by
    less than min_dist that does not hit marches on, and the ray hits at
    its next sample as it does without the bound. A synthetic scene d =
    0.99 (L - z), L = 2.005 / 0.99, on the ray from the origin along +z,
    with the bound (0, 0, 1), R = 1 (t_exit 2, the cap 2.01) and min_dist
    0.01: samples at t = 0, 2.005 (d = 0.02) and 2.025, which hits. A ray
    whose sphere lies behind its origin takes no step."""
    p = cp.PrepassParams.make(_t(CFG_B), W, H, no_prepass=True)  # the flat factories' constants
    assert p.min_dist == np.float32(0.01)
    k, lim = 0.99, 2.005 / 0.99

    def scene(x, y, z):
        return k * (lim - z)

    bound = torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    zero, one = torch.zeros(1), torch.ones(1)
    (t, hit, steps), (t0, hit0, steps0) = (
        cm.march_tile_plain(scene, dataclasses.replace(p, use_bound=b), bound, zero, zero, zero, zero, zero, one)
        for b in (True, False))
    assert float(hit) == float(hit0) == 1.0 and float(steps) == float(steps0) == 3.0
    assert torch.equal(t, t0) and float(t) > 2.02
    t, hit, steps = cm.march_tile_plain(scene, p, bound, zero, zero, zero - 3.0, zero, zero, -one)
    assert float(hit) == 0.0 and float(steps) == 0.0


@pytest.mark.parametrize("kw", [dict(prepass_block=1), dict(prepass_block=4), dict(prepass_block=1, n_intervals=2)],
                         ids=["b1", "b4", "intervals"])
@pytest.mark.parametrize("relax", [1.0, 1.6], ids=["plain", "relax"])
def test_march_only_build_matches_jax(kw, relax):
    cfg = dataclasses.replace(CFG_B, relax=relax)
    spec_j, arr_j = rm.compile_scene(SCENES["config2"](rm), static=True)
    spec, arr = from_reference(spec_j, arr_j)
    t_j, h_j = (np.asarray(v) for v in march_fast_j(spec_j, cfg, W, H, interpret=True, bm_coarse=8, bm_fine=8,
                                                     **kw)(arr_j, jnp.asarray(CV)))
    rp = cp.make_pallas_image_march_fast(spec, _t(cfg), W, H, device="cpu", **kw)
    t, h = (v.numpy() for v in rp(arr, torch.as_tensor(CV)))
    assert t.shape == (W * H * 4,)
    # The conservative prepass class: hits agree but on rays that graze a
    # silhouette within one min_dist step of the cone's stop.
    assert np.mean(h != h_j) < 0.01
    m = (h > 0.5) & (h_j > 0.5)
    assert np.abs(t[m] - t_j[m]).max() < 1e-3
    # Its plain version is fine_res_plain's (t, hit), ray for ray.
    full = cp.make_pallas_image_render_aa(spec, _t(cfg), W, H, device="cpu", **kw)
    sc, cam, bound = full.scene_args(arr, torch.as_tensor(CV))
    _, t_r, h_r = cp.fine_res_plain(sc, cam, bound, full.params, *full.prepass(sc, cam, bound, None, plain=True))
    np.testing.assert_array_equal(t, t_r.reshape(-1).numpy())
    np.testing.assert_array_equal(h, h_r.reshape(-1).numpy())


@pytest.mark.parametrize(
    "backend,mode",
    [("pallas", "unrolled"), ("pallas", "soft"), ("pallas_image", "implicit"), ("pallas_full", "implicit"),
     ("pallas_prepass", "implicit"), ("pallas_fused", "forward"), ("nope", "forward")],
)
def test_reference_value_errors(backend, mode):
    spec, _ = rt.compile_scene(SCENES["config2"](rt))
    with pytest.raises(ValueError):
        rt.make_renderer(spec, W, H, _t(CFG), mode=mode, backend=backend, device="cpu")
    spec_s, _ = rt.compile_scene(SCENES["config2"](rt), static=True)
    with pytest.raises(ValueError, match="march_only"):
        cp.make_pallas_image_render_aa(spec_s, _t(CFG), W, H, device="cpu", march_only=True, aa_packed=False)
    with pytest.raises(ValueError, match="march_only"):
        cp.make_pallas_image_render_aa(spec_s, _t(CFG), W, H, device="cpu", march_only=True, soft=True,
                                       no_prepass=True)


@pytest.mark.parametrize("aa", [2, 3, 4])
@pytest.mark.parametrize("case", ["config2_static", "config2_dynamic", "painted_dynamic"])
def test_pixel_build_plain_matches_jax_pallas_full(case, aa):
    """K7's pixel build (the AA mean inside the kernel) through its plain
    version, `make_renderer(backend="pallas_full")` on the CPU, against the
    JAX package's pallas_full frame in interpret mode without the bound
    (module docstring): the exact class. aa 3 is the build's shared-memory
    sum, aa 2 and 4 its shuffles."""
    cfg, (spec_j, arr_j), (spec, arr) = _case(case)
    cfg = dataclasses.replace(cfg, aa_samples=aa)
    img_j = np.asarray(jax.jit(rm.make_renderer(spec_j, W, H, _unbounded(cfg), mode="forward",
                                                backend="pallas_full", interpret=True))(arr_j, CAM))
    render = rt.make_renderer(spec, W, H, _t(cfg), mode="forward", backend="pallas_full", device="cpu")
    before = cm.image_pixels.launches
    img = render(arr, CAM_T)
    assert cm.image_pixels.launches == before  # the plain version: no kernel ran
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert np.abs(img.numpy() - img_j).max() < IMG_ATOL
    fm = render.renderer.flat
    sc, cam, bound = fm.scene_args(arr, torch.as_tensor(CV))
    per_ray = torch.stack(cm.image_render_plain(sc, cam, bound, fm.params), -1).reshape(H, W, aa * aa, 3).mean(2)
    assert torch.equal(cm.image_pixels_plain(sc, cam, bound, fm.params), per_ray)


@pytest.mark.parametrize("name,static", [("config2", True), ("config2", False), ("all_prims", True),
                                         ("painted_transformed", False)])
def test_flat_scene_buffers_carry_words_and_route(name, static):
    """The flat path hands K5-K7 the packed words (per TapeSpec, or per frame
    for a dynamic tape) and the route of the spec's stack depth, as K1/K2
    get them."""
    spec, arr = rt.compile_scene(SCENES[name](rt), static=static)
    fm = cm.FlatMarch(spec, _t(CFG_B), W, H, torch.device("cpu"))
    sc, _, _ = fm.scene_args(arr, torch.as_tensor(CV))
    assert sc.words is not None and tuple(sc.words.shape) == (max(sc.n_instr, 1), 4)
    np.testing.assert_array_equal(sc.words.numpy(), cm.pack_words(*sc.tape.numpy(), cm.row_kinds(spec)))
    assert sc.route == cm.stack_route(spec) == (cm.REG_STACK if spec.stack_depth <= 2 else cm.STK_SMEM)


def test_flat_path_refuses_a_dynamic_tape_deeper_than_its_spec():
    """A frame's dynamic tape whose slots pass the spec's stack depth raises
    on the flat path too: the kernels size the stack's route by the spec."""
    spec, arr = rt.compile_scene(SCENES["config2"](rt), static=False)
    slots = np.asarray(arr.out_slot).copy()
    slots[np.asarray(arr.tape_ops) != 0] = spec.stack_depth
    deep = dataclasses.replace(arr, out_slot=slots)
    for factory in (cm.make_pallas_image_march, cm.make_pallas_image_render, cm.make_pallas_pixel_render):
        with pytest.raises(ValueError, match="past the spec's depth"):
            factory(spec, _t(CFG_B), W, H, device="cpu")(deep, torch.as_tensor(CV))
    with pytest.raises(ValueError, match="past the spec's depth"):
        cm.make_pallas_ray_march(spec, _t(CFG_B), device="cpu")(deep, torch.zeros(4, 3), torch.ones(4, 3))


def test_pixel_build_refuses_what_it_does_not_take():
    """The pixel build holds a pixel's samples in one block: more than 1,024
    samples a pixel raise (on the CPU as on the card), as does a block whose
    stacks pass the card's shared memory (a painted scene's four stacks at
    depth 32 and aa 32); the wrapper has no other build to fall back to."""
    spec, arr = rt.compile_scene(SCENES["config2"](rt), static=True)
    render = cm.make_pallas_pixel_render(spec, _t(dataclasses.replace(CFG_B, aa_samples=33)), 2, 2, device="cpu")
    with pytest.raises(ValueError, match="exceed the pixel build's"):
        render(arr, torch.as_tensor(CV))
    deep, arr_d = rt.compile_scene(SCENES["painted_transformed"](rt), static=True, stack_depth=32)
    assert deep.has_materials and cm.pixel_smem(deep, 32 * 32) > cm.SMEM_MAX >= cm.pixel_smem(deep, 16 * 16)
    render = cm.make_pallas_pixel_render(deep, _t(dataclasses.replace(CFG_B, aa_samples=32)), 2, 2, device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        render(arr_d, torch.as_tensor(CV))
