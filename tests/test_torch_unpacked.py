"""The unpacked fine pass K4 against the JAX package.

The port's K4 plain version (`cuda_prepass.fine_unpacked_plain`, what the
wrapper runs on CPU tensors) against the JAX `fine_kernel`
(pallas_prepass.py:1010, `aa_packed=False`, Pallas in interpret mode as
tests/test_prepass.py runs it): AA grids that pack and ones that do not
(aa 3 and 5, whose pixels straddle warps in the kernel's lane map), with
and without `aa_shared_normals`, static and dynamic tapes, un-culled and
`leaf_cull`; the Python mirror of the kernel's block shape and shared
memory. Then shared normals against the NumPy oracle, K4 without
sharing against the packed fine pass, K4's residuals against the packed
build's, and the fused VJP at aa = 3 (K4 with residuals, then K8) against
the JAX fused VJP. The CUDA kernel is held to the plain version on the card
by chip_smoke.py and tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops.pallas_grad import make_fused_render_vjp as fused_vjp_j
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as render_aa_j
from raymarch_tpu_torch.ops import cuda_grad as cg
from raymarch_tpu_torch.ops import cuda_march as cm
from raymarch_tpu_torch.ops import cuda_prepass as cp

from test_torch_prepass import _assert_images_close, _cfg_t, _cv_j, _cv_t
from test_torch_tape import SCENES

# One torch thread per process (see tests/test_torch_prepass.py).
torch.set_num_threads(1)

W, H = 32, 24  # not a multiple of the kernels' tiles
CFG = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=80, bound_accel=True, exit_check_every=4)
CAM = rm.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))


def _port_image(scene, cfg, static, **kw):
    spec, arrays = rt.compile_scene(scene(rt), static=static)
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, H, device="cpu", **kw)
    return rp, rp(arrays, _cv_t(CAM)).numpy()


@pytest.mark.parametrize(
    "aa,shared,static,cull",
    [
        (2, False, True, False),
        (3, False, True, False),
        (2, True, True, False),
        (3, True, True, True),
        (2, True, False, False),
        (3, False, False, True),
        (5, True, True, False),
        (5, False, False, True),
    ],
    ids=["aa2", "aa3", "aa2_shared", "aa3_shared_cull", "aa2_shared_dynamic", "aa3_dynamic_cull", "aa5_shared",
         "aa5_dynamic_cull"],
)
def test_k4_plain_matches_jax_k4(aa, shared, static, cull):
    cfg = dataclasses.replace(CFG, aa_samples=aa, aa_shared_normals=shared, leaf_cull=cull)
    spec_j, arrays_j = rm.compile_scene(SCENES["config2"](rm), static=static)
    ref = np.asarray(render_aa_j(spec_j, cfg, W, H, interpret=True, bm_coarse=8, bm_fine=8, prepass_block=1,
                                 aa_packed=False)(arrays_j, _cv_j(CAM)))
    rp, img = _port_image(SCENES["config2"], cfg, static, aa_packed=False)
    assert rp.params.unpacked and rp.params.shared_normals == shared
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    _assert_images_close(img, ref)


# K4's block for S samples a pixel (csrc/fine_unpacked.cuh pixel_lanes):
# (lanes a pixel, samples a lane, pixels a block, threads a block). A block
# holds whole pixels, floor(128 / lanes) of them; past 128 samples each
# lane walks k = ceil(S / 128) of them, a pixel ceil(S / k) lanes of a
# block of its own.
LANE_MAPS = {1: (1, 1, 128, 128), 4: (4, 1, 32, 128), 9: (9, 1, 14, 126), 16: (16, 1, 8, 128),
             25: (25, 1, 5, 125), 36: (36, 1, 3, 108), 49: (49, 1, 2, 98), 64: (64, 1, 2, 128),
             1089: (121, 9, 1, 121)}


@pytest.mark.parametrize("route", ["register", "shared"])
@pytest.mark.parametrize("s", sorted(LANE_MAPS))
def test_k4_block_shape_and_shared_memory(s, route):
    """The mirror of K4's lane map and dynamic shared memory: the stack's
    columns on the shared-memory route (a depth-8 union of spheres: 7
    slots a thread), then three floats a sample of the block's pixels and
    eight words a pixel (first hit, hit point, four taps)."""
    lanes, rounds, pixels, threads = LANE_MAPS[s]
    assert cp.unpacked_shape(s) == LANE_MAPS[s]
    assert lanes * rounds >= s > lanes * (rounds - 1) and pixels * lanes == threads <= 128
    scene = SCENES["config2"] if route == "register" else (
        lambda m: functools.reduce(lambda a, b: a | b, [m.sphere(center=(k, 0, 0), radius=0.3) for k in range(8)]))
    spec, _ = rt.compile_scene(scene(rt), static=True, **({} if route == "register" else {"stack_depth": 8}))
    assert (cm.stack_route(spec) == cm.STK_SMEM) == (route == "shared")
    stack = 0 if route == "register" else 7 * threads * 4
    exchange = (3 * pixels * s + 8 * pixels) * 4
    assert cp.unpacked_smem(spec, s) == stack + exchange
    assert cp.unpacked_smem(spec, s, compact=True) == exchange  # the item lists read no stack
    assert cp.unpacked_lanes(spec, s) == cp.UNPACKED_MAX_LANES


def test_k4_lanes_shrink_to_fit_shared_memory():
    """A painted scene at stack depth 32 keeps four stacks of 31 slots a
    thread (496 bytes): at aa 120 (14,400 samples a pixel, 172,800 bytes of
    colours) a block of 128 lanes would pass the card's 227 KB, so a pixel
    takes 64 lanes of 225 samples each."""
    spec, _ = rt.compile_scene(SCENES["painted_transformed"](rt), static=True, stack_depth=32)
    assert spec.has_materials
    s = 120 * 120
    assert cp.unpacked_smem(spec, s) > cp.SMEM_MAX >= cp.unpacked_smem(spec, s, 64)
    assert cp.unpacked_lanes(spec, s) == 64 and cp.unpacked_shape(s, 64) == (64, 225, 1, 64)
    assert cp.unpacked_lanes(spec, 16) == cp.UNPACKED_MAX_LANES


def test_shared_normals_match_oracle():
    """tests/test_prepass.py:266-281's class: approximate by design (a
    pixel's later samples shade with its first hit's normal), so mean |d|
    under 5e-3 and under 3% of pixels off by more than 0.05."""
    cfg = dataclasses.replace(CFG, aa_shared_normals=True)
    w, h = 65, 47
    spec, arrays = rt.compile_scene(SCENES["config2"](rt), static=True)
    img = rt.make_renderer(spec, w, h, _cfg_t(cfg), mode="forward", backend="pallas_prepass", device="cpu")(
        arrays, rt.Camera(CAM.position, CAM.rotation)).numpy()
    ref = rm.oracle.render(rm.encode_wire(SCENES["config2"](rm)), CAM, w, h, cfg)
    assert np.isfinite(img).all()
    d = np.abs(img - ref)
    assert d.mean() < 5e-3, d.mean()
    assert (d.max(-1) > 0.05).mean() < 0.03


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_unshared_k4_matches_packed_frame(static):
    _, packed = _port_image(SCENES["config2"], CFG, static)
    rp, img = _port_image(SCENES["config2"], CFG, static, aa_packed=False)
    assert rp.params.unpacked and not rp.params.shared_normals
    assert np.abs(img - packed).max() < 1e-3


def test_k4_residuals_match_packed_build():
    spec, arrays = rt.compile_scene(SCENES["config2"](rt), static=True)
    rp_p = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu")
    rp_u = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu", aa_packed=False)
    sc, cam, bound = rp_p.scene_args(arrays, _cv_t(CAM))
    pre = rp_p.prepass(sc, cam, bound, None)
    img_p, t_p, hit_p = cp.fine_res(sc, cam, bound, rp_p.params, *pre)
    img_u, t_u, hit_u = cp.fine_unpacked_res(sc, cam, bound, rp_u.params, *pre)
    assert t_u.shape == hit_u.shape == (H, W, 4)
    assert torch.equal(t_u, t_p) and torch.equal(hit_u, hit_p)
    assert 0 < float(hit_u.mean()) < 1
    assert float((img_u - img_p).abs().max()) < 1e-6
    assert torch.equal(img_u, cp.fine_unpacked(sc, cam, bound, rp_u.params, *pre))


def _cv(cam):
    return np.concatenate([cam.position, cam.rotation, [0.0]]).astype(np.float32)


def test_fused_vjp_aa3_matches_jax():
    """make_renderer(backend="pallas_fused") at aa = 3 takes the reference's
    unpacked route (pallas_grad.py:1296-1310): K4 with residuals, then K8.
    Gradients of mean((img - 0.3)^2) within 0.01 max|g| (scene words) and
    0.02 max|g| (camera) of the JAX fused VJP."""
    cfg = dataclasses.replace(CFG, aa_samples=3)
    spec_j, arrays_j = rm.compile_scene(SCENES["config2"](rm), static=True)
    rf = fused_vjp_j(spec_j, cfg, W, H, interpret=True, bm=8)
    cv = _cv(CAM)

    def loss_j(lp, opp, c):
        a = dataclasses.replace(arrays_j, leaf_params=lp, op_param=opp)
        return jnp.mean((rf(a, c) - 0.3) ** 2)

    img_j = np.asarray(rf(arrays_j, jnp.asarray(cv)))
    g_j = [np.asarray(g) for g in jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(arrays_j.leaf_params), jnp.asarray(arrays_j.op_param), jnp.asarray(cv))]

    spec, arrays = rt.compile_scene(SCENES["config2"](rt), static=True)
    render = rt.make_renderer(spec, W, H, _cfg_t(cfg), mode="implicit", backend="pallas_fused", device="cpu")
    info = render.backward_info
    assert (info["aa_packed"], info["kind"], info["reason"]) == (False, "pallas_legacy_unrolled", "leaf_cull disabled")
    assert {k: info[k] for k in ("kind", "compact", "reason", "aa_packed", "soft")} == {
        k: rf.backward_info[k] for k in ("kind", "compact", "reason", "aa_packed", "soft")}
    lp = torch.tensor(arrays.leaf_params, requires_grad=True)
    opp = torch.tensor(arrays.op_param, requires_grad=True)
    c = torch.tensor(cv, requires_grad=True)
    before = cp.fine_unpacked_res.launches
    img = render.renderer(dataclasses.replace(arrays, leaf_params=lp, op_param=opp), c)
    torch.mean((img - 0.3) ** 2).backward()
    assert cp.fine_unpacked_res.launches == before  # the CPU runs the plain version, no launch
    assert np.abs(img.detach().numpy() - img_j).mean() < 1e-4
    scale = np.abs(g_j[0]).max()
    assert scale > 0
    np.testing.assert_allclose(lp.grad.numpy(), g_j[0], atol=0.01 * scale)
    np.testing.assert_allclose(opp.grad.numpy(), g_j[1], atol=0.01 * scale)
    cscale = np.abs(g_j[2][:7]).max()
    np.testing.assert_allclose(c.grad.numpy()[:7], g_j[2][:7], atol=0.02 * cscale)


def test_fit_scene_trains_at_aa3():
    """fit_scene at aa = 3 moves a sphere's centre toward the truth through
    K4's residuals and K8."""
    cfg = _cfg_t(dataclasses.replace(CFG, aa_samples=3))
    spec, arrays = rt.compile_scene(SCENES["config2"](rt), static=True)
    cam = rt.Camera(CAM.position, CAM.rotation)
    target = rt.make_renderer(spec, W, H, cfg, mode="forward", backend="pallas_prepass", device="cpu")(arrays, cam)
    start = arrays.leaf_params.copy()
    start[0, 4] -= 0.1
    mask = np.zeros_like(start)
    mask[0, 4] = 1.0
    res = rt.fit_scene(spec, dataclasses.replace(arrays, leaf_params=start), cam, target, width=W, height=H,
                       cfg=cfg, steps=4, learning_rate=1e-2, leaf_mask=mask, backend="pallas_fused", device="cpu")
    assert res.losses[-1] < res.losses[0]
    assert abs(res.arrays.leaf_params[0, 4] - arrays.leaf_params[0, 4]) < 0.1
    assert res.backward_info["aa_packed"] is False


@pytest.mark.parametrize(
    "kw,cfg_kw,match",
    [
        (dict(aa_packed=True), dict(aa_shared_normals=True), "aa_shared_normals"),
        (dict(march_only=True, aa_packed=False), {}, "march_only"),
        (dict(march_only=True), dict(aa_samples=3), "march_only"),
        (dict(soft=True, no_prepass=True), dict(aa_samples=3), "soft"),
    ],
    ids=["packed_shared", "march_only_unpacked", "march_only_aa3", "soft_aa3"],
)
def test_reference_value_errors(kw, cfg_kw, match):
    """The reference's ValueErrors of the layout (pallas_prepass.py:636-650,
    728-732)."""
    spec, _ = rt.compile_scene(SCENES["config2"](rt), static=True)
    with pytest.raises(ValueError, match=match):
        cp.make_pallas_image_render_aa(spec, dataclasses.replace(_cfg_t(CFG), **cfg_kw), W, H, device="cpu", **kw)


@pytest.mark.parametrize(
    "kw,cfg_kw,match",
    [
        (dict(aa_packed=True), dict(aa_samples=3), "128"),
        (dict(aa_packed=True), dict(aa_shared_normals=True), "aa_shared_normals"),
        (dict(soft=True), dict(aa_shared_normals=True), "aa_shared_normals"),
    ],
    ids=["packed_aa3", "packed_shared", "soft_shared"],
)
def test_fused_vjp_value_errors(kw, cfg_kw, match):
    """The reference's fused VJP raises for a packed layout that cannot be
    (pallas_grad.py:1309-1310) and for a packed VJP with shared normals."""
    spec, _ = rt.compile_scene(SCENES["config2"](rt), static=True)
    with pytest.raises(ValueError, match=match):
        cg.make_fused_render_vjp(spec, dataclasses.replace(_cfg_t(CFG), **cfg_kw), W, H, device="cpu", **kw)


def test_shared_normals_vjp_takes_k4():
    cfg = dataclasses.replace(_cfg_t(CFG), aa_shared_normals=True)
    spec, _ = rt.compile_scene(SCENES["config2"](rt), static=True)
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, device="cpu")
    assert fr.prepass.params.shared_normals and fr.backward_info["aa_packed"] is False
