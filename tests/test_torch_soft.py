"""Soft coverage (silhouette gradients) in the port against the JAX package.

Mirrors tests/test_soft_coverage.py. On the CPU the port's fused renderer
with `mode="soft"` runs the plain versions of the soft builds: the soft
fine pass (`fine_res_plain`, which also keeps each ray's closest approach
s_min, t_min), and `bwd_plain` / `compact_bwd_plain` with the envelope
term. Here:

- `leaf_bound_spheres(soft=True)` against the JAX one (and the fault-2
  repair kept under the soft inflation);
- the soft forward and its residuals against the JAX soft forward
  (`make_pallas_image_render_aa(soft=True)`, Pallas in interpret mode) and
  the jnp soft renderer, atol 5e-4 (the reference's own class for the two);
  the bound acceleration exact; the reference's argument checks;
- a two-group stream plan against the port's un-culled soft backward;
- a pure translation's silhouette gradient, against the jnp soft path;
- soft_cull_log_alpha = 24 against 104;
- reference fault 11 (ROADMAP §3): the reference's `pallas_fused` fit step
  builds its fused VJP without `soft`, so `make_fit_step(mode="soft")`
  trains the implicit gradients there; the port's fit step is held against
  the reference's soft VJP called directly, never against that fault;
- a silhouette-driven pose fit of twelve spheres.

Gradients against the JAX fused soft VJP are in tests/test_torch_soft_vjp.py
(two files, so that each runs in well under 90 s on one worker). The CUDA
builds are held to these plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py. Gradient classes: two f32 implementations of one
backward (tests/test_pallas_grad.py:78-105): 0.01·max|g| for scene words,
0.02·max|g| for the camera.
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
from raymarch_tpu.ops import culling as cull_j
from raymarch_tpu.ops.pallas_grad import make_fused_render_vjp as fused_vjp_j
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as prepass_j
from raymarch_tpu.parallel import make_fit_step as make_fit_step_j
from raymarch_tpu.parallel import make_mesh
from raymarch_tpu_torch.ops import cuda_grad as cg
from raymarch_tpu_torch.ops import cuda_prepass as cp
from raymarch_tpu_torch.ops import culling as cull_t
from raymarch_tpu_torch.ops.tape import from_reference

from test_torch_blend import _seg1_mixed, _stream9
from test_torch_compact import _six_spheres
from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)

CFG_J = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=64, bound_accel=True, exit_check_every=4)
W, H = 48, 32
POS = (0.3, 1.8, 5.0)  # tests/test_pallas_grad.py:310-312

# tests/test_soft_coverage.py:20-29: ambient 1 makes the interior shading
# constant and the camera looks up at a black sky, so a translation's only
# image signal is the outline moving.
SIL_CFG = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=60, ambient=1.0, coverage_beta=0.05)
SIL_CAM = rm.Camera.looking_at(position=(0.0, -0.5, 4.0), target=(0.0, 0.2, 0.0))


def _cfg_t(cfg):
    return rt.RenderConfig(**dataclasses.asdict(cfg))


def _cv(cam):
    return np.concatenate([cam.position, cam.rotation, [0.0]]).astype(np.float32)


def _look(pos):
    return rm.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0))


def _sphere_box(m):
    """tests/test_soft_coverage.py:123-126."""
    return m.sphere(center=(0.0, 0.2, 0.0), radius=0.8) | m.box(
        center=(1.2, 0.0, -0.3), half_extents=(0.4, 0.4, 0.4)
    )


def _eight_spheres(m):
    """tests/test_soft_coverage.py:322-333: eight random spheres (seed 19)."""
    rng = np.random.default_rng(19)
    parts = [m.sphere(center=tuple(rng.uniform(-1.5, 1.5, 3) * [1, 0.5, 1]), radius=float(rng.uniform(0.25, 0.5)))
             for _ in range(8)]
    return functools.reduce(lambda a, b: a | b, parts)


def _twelve_spheres(m):
    """tests/test_soft_coverage.py:258-266: twelve random spheres (seed 41)."""
    rng = np.random.default_rng(41)
    parts = [m.sphere(center=tuple(rng.uniform(-1.5, 1.5, 3) * [1, 0.6, 1]), radius=float(rng.uniform(0.25, 0.5)))
             for _ in range(12)]
    return functools.reduce(lambda a, b: a | b, parts)


def _tensor_arrays(arrays, grad=False):
    return dataclasses.replace(arrays, leaf_params=torch.tensor(arrays.leaf_params, requires_grad=grad),
                               op_param=torch.tensor(arrays.op_param, requires_grad=grad))


def _port_soft(spec, arrays, cfg_j, cam_vec, w=W, h=H, loss=lambda img: torch.mean(img**2)):
    """Image, gradients (d_lp, d_opp, d_cam) of `loss` and the backward_info
    of the port's soft fused renderer on the CPU."""
    render = rt.make_renderer(spec, w, h, _cfg_t(cfg_j), mode="soft", backend="pallas_fused", device="cpu")
    a = _tensor_arrays(arrays, grad=True)
    cv = torch.tensor(cam_vec, requires_grad=True)
    img = render.renderer(a, cv)
    loss(img).backward()
    return img.detach().numpy(), (a.leaf_params.grad.numpy(), a.op_param.grad.numpy(), cv.grad.numpy()), \
        render.backward_info


def _assert_grad_class(got, ref):
    """Two f32 implementations of one backward (tests/test_pallas_grad.py:
    78-105): 0.01·max|g| for the leaf and op words, 0.02·max|g| for the
    camera."""
    (gl, go, gc), (gl_r, go_r, gc_r) = got, ref
    scale = np.abs(gl_r).max()
    assert scale > 0
    np.testing.assert_allclose(gl, gl_r, atol=0.01 * scale)
    np.testing.assert_allclose(go, go_r, atol=0.01 * scale)
    cscale = np.abs(gc_r[:7]).max()
    np.testing.assert_allclose(gc[:7], gc_r[:7], atol=0.02 * cscale)
    assert gc[7] == 0.0


# --------------------------------------------------------------------------
# Soft culling


@pytest.mark.parametrize("name", ["spheres", "seg1", "stream", "plane_blend"])
def test_soft_leaf_bounds_match_jax(name):
    """leaf_bound_spheres(soft=True) adds soft_cull_log_alpha * beta to
    every bound, as the reference's (culling.py:243-297); on a sphere blended
    with a plane the port keeps its fault-2 repair (the blend radius) under
    the soft inflation too."""
    build = {
        "spheres": _six_spheres,
        "seg1": _seg1_mixed,
        "stream": _stream9,
        "plane_blend": lambda m: m.sphere(center=(6.0, 0.3, 0.0), radius=0.5).union(
            m.plane(normal=(0.0, 1.0, 0.0), offset=0.0), k=0.3) | m.sphere(center=(0.0, 0.5, 0.0), radius=0.6),
    }[name]
    cfg_j = dataclasses.replace(CFG_J, leaf_cull=True, soft_cull_log_alpha=24.0)
    spec_j, arrays_j = rm.compile_scene(build(rm), static=True)
    spec, arrays = from_reference(spec_j, arrays_j)
    ref = np.asarray(cull_j.leaf_bound_spheres(spec_j, arrays_j, cfg_j, soft=True))
    got = cull_t.leaf_bound_spheres(spec, _tensor_arrays(arrays), _cfg_t(cfg_j), soft=True).numpy()
    hard = cull_t.leaf_bound_spheres(spec, _tensor_arrays(arrays), _cfg_t(cfg_j)).numpy()
    infl = cfg_j.soft_cull_log_alpha * cfg_j.coverage_beta
    np.testing.assert_allclose(got[:, 3] - hard[:, 3], infl, rtol=0.0, atol=1e-6)
    np.testing.assert_array_equal(got[:, [0, 1, 2, 4]], hard[:, [0, 1, 2, 4]])
    if name == "plane_blend":
        # Reference fault 2 (ROADMAP §3 fault 2): the port's bound keeps k.
        assert (got[:, 3] >= ref[:, 3]).all() and (got[:, 3] - ref[:, 3]).max() == pytest.approx(0.3, abs=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0.0)


# --------------------------------------------------------------------------
# The soft forward and its residuals


def _unpack_packed(v, s):
    """A Pallas packed residual plane (sublane u = pixel_row * S + sample)
    -> f32[H, W, S] in the port's lane order."""
    v = np.asarray(v)
    return v.reshape(-1, s, v.shape[1])[:H, :, :W].transpose(0, 2, 1)


@pytest.fixture(scope="module", params=[False, True], ids=["unbounded", "bound_accel"])
def soft_frame(request):
    cfg_j = dataclasses.replace(CFG_J, bound_accel=request.param)
    spec_j, arrays_j = rm.compile_scene(_sphere_box(rm), static=True)
    spec, arrays = from_reference(spec_j, arrays_j)
    cam = rm.Camera.looking_at(position=(0.3, 2.9, 4.2), target=(0.0, 0.0, 0.0))
    cv = _cv(cam)
    rj = prepass_j(spec_j, cfg_j, W, H, interpret=True, no_prepass=True, aa_packed=True, soft=True)
    img_j, *res_j = rj.fine_res(arrays_j, jnp.asarray(cv), [])
    img_j = np.asarray(img_j)
    res_j = [_unpack_packed(v, cfg_j.aa_samples**2) for v in res_j]
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg_j), W, H, device="cpu", no_prepass=True, soft=True)
    sc, cam_t, bound = rp.scene_args(arrays, torch.tensor(cv))
    img, *res = cp.fine_res(sc, cam_t, bound, rp.params)
    img_jnp = np.asarray(jax.jit(rm.make_renderer(spec_j, W, H, cfg_j, mode="soft"))(arrays_j, cam))
    return img.numpy(), [r.numpy() for r in res], img_j, res_j, img_jnp, rp, arrays, cv


def test_soft_forward_matches_jax(soft_frame):
    img, (t, hit, s_min, t_min), img_j, (t_j, hit_j, s_j, tm_j), img_jnp, rp, arrays, cv = soft_frame
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, img_j, atol=5e-4)
    np.testing.assert_allclose(img, img_jnp, atol=5e-4)
    # The frame through the renderer is the fine pass's image.
    np.testing.assert_array_equal(rp(arrays, torch.tensor(cv)).numpy(), img)
    assert (hit == hit_j).mean() >= 0.999 and 0 < hit.mean() < 1
    covered = cp.soft_alpha(rp.params, torch.tensor(s_j)).numpy() > 0.0
    assert covered.sum() > hit.sum()  # a halo of missed rays takes coverage
    # On 99.9% of the covered rays: s_min within 1e-4 |s_min| + 1e-5 (a hit
    # ray's s_min is its last sample's distance, under min_dist, which an
    # ulp of the position moves by ~5e-7), t_min within rtol 1e-4.
    for a, b, atol in ((s_min, s_j, 1e-5), (t_min, tm_j, 0.0)):
        off = np.abs(a - b)[covered] > 1e-4 * np.abs(b[covered]) + atol
        assert off.mean() < 1e-3
    both = (hit == 1) & (hit_j == 1)
    np.testing.assert_allclose(t[both], t_j[both], rtol=1e-4)


def test_soft_bound_accel_is_exact(soft_frame):
    """The inflated soft bound skips or caps only samples that cannot lower
    s_min or hit (tests/test_soft_coverage.py:213-235): the frame with and
    without bound_accel is the same, bit for bit."""
    *_, rp, arrays, cv = soft_frame
    other = dataclasses.replace(rp.cfg, bound_accel=not rp.cfg.bound_accel)
    rp2 = cp.make_pallas_image_render_aa(rp.spec, other, W, H, device="cpu", no_prepass=True, soft=True)
    np.testing.assert_array_equal(rp(arrays, torch.tensor(cv)).numpy(), rp2(arrays, torch.tensor(cv)).numpy())


def test_soft_options_raise_like_the_reference():
    spec, _ = rt.compile_scene(SCENES["config2"](rt), static=True)
    cfg = _cfg_t(CFG_J)
    for kw, c in ((dict(soft=True), cfg), (dict(soft=True, no_prepass=True, aa_packed=False), cfg),
                  (dict(soft=True, no_prepass=True), dataclasses.replace(cfg, relax=1.6)),
                  (dict(soft=True, no_prepass=True, march_only=True), cfg)):
        with pytest.raises(ValueError):
            cp.make_pallas_image_render_aa(spec, c, W, H, device="cpu", **kw)
    with pytest.raises(ValueError, match="128"):
        cg.make_fused_render_vjp(spec, dataclasses.replace(cfg, aa_samples=3), W, H, soft=True, device="cpu")
    # The soft VJP takes the packed layout whatever aa_packed says, and no
    # prepass whatever prepass_block says (pallas_grad.py:1243-1249).
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, aa_packed=False, prepass_block=4, soft=True, device="cpu")
    assert fr.params.no_prepass and fr.params.soft and fr.backward_info["aa_packed"]


# --------------------------------------------------------------------------
# Two stream groups, the silhouette gradient, the log_alpha floor, the fit
# (fault 11)


def test_two_stream_groups_match_own_legacy_backward():
    """A two-group stream plan: the compact soft backward (K9's soft branch)
    against the port's un-culled soft backward (K8's: the whole tape, no
    lists), which tests/test_torch_soft_vjp.py holds to the JAX fused soft
    VJP; the reference's compact VJP is no target here (ROADMAP §3 fault
    1), and its legacy VJP on this 29-leaf tape takes 90 s in interpret
    mode. The culled soft frame matches the JAX soft forward's."""
    spec_j, arrays_j = rm.compile_scene(_stream9(rm), static=True, rebalance=False)
    spec, arrays = from_reference(spec_j, arrays_j)
    plan = cg.build_compact_plan(spec)
    assert plan["seg1"] is None and len(plan["stream"]) == 2
    cfg_c = dataclasses.replace(CFG_J, leaf_cull=True)
    cv = _cv(_look((0.4, 2.0, 6.0)))
    img_c, g_c, info_c = _port_soft(spec, arrays, cfg_c, cv)
    _, g_l, info_l = _port_soft(spec, arrays, CFG_J, cv)
    assert (info_c["kind"], info_c["reason"], info_l["kind"]) == ("pallas_compact", None, "pallas_legacy_unrolled")
    _assert_grad_class(g_c, g_l)
    assert np.abs(g_c[1]).max() > 0  # the blend radii
    rj = prepass_j(spec_j, cfg_c, W, H, interpret=True, no_prepass=True, aa_packed=True, soft=True)
    np.testing.assert_allclose(img_c, np.asarray(rj(arrays_j, jnp.asarray(cv))), atol=5e-4)


def _translation_problem(dx):
    """The silhouette-only problem of tests/test_soft_coverage.py:57-76: a
    sphere offset dx from its target, on both packages."""
    target_j = rm.sphere(center=(0.25, 0.2, 0.0), radius=0.8)
    spec_j, arrays_tj = rm.compile_scene(target_j, static=True)
    _, arrays_j = rm.compile_scene(rm.sphere(center=(0.25 + dx, 0.2, 0.0), radius=0.8), static=True)
    return spec_j, arrays_tj, arrays_j


def _translation_grad(mode, dx):
    """d mean((img - target)^2) / d centre_x through the port's fused
    renderer, the target rendered in soft mode."""
    spec_j, arrays_tj, arrays_j = _translation_problem(dx)
    spec, arrays_t = from_reference(spec_j, arrays_tj)
    _, arrays = from_reference(spec_j, arrays_j)
    cfg = _cfg_t(SIL_CFG)
    cam = rt.Camera(SIL_CAM.position, SIL_CAM.rotation)
    target = rt.make_renderer(spec, W, W, cfg, mode="soft", backend="pallas_fused", device="cpu")(arrays_t, cam)
    render = rt.make_renderer(spec, W, W, cfg, mode=mode, backend="pallas_fused", device="cpu")
    a = _tensor_arrays(arrays, grad=True)
    torch.mean((render(a, cam) - target.detach()) ** 2).backward()
    return a.leaf_params.grad.numpy()


def test_pure_translation_has_a_silhouette_gradient():
    """Interior-only gradients are blind to a pure translation; soft ones
    point at the target (tests/test_soft_coverage.py:78-89), and agree with
    the jnp soft path's in the class of two f32 implementations."""
    assert np.abs(_translation_grad("implicit", 0.15)).max() < 1e-7
    g_pos, g_neg = _translation_grad("soft", 0.15), _translation_grad("soft", -0.15)
    assert g_pos[0, 4] > 1e-5 and g_neg[0, 4] < -1e-5  # the loss falls toward the target
    spec_j, arrays_tj, arrays_j = _translation_problem(0.15)
    render = rm.make_renderer(spec_j, W, W, SIL_CFG, mode="soft")
    target = jax.jit(render)(arrays_tj, SIL_CAM)

    def loss(lp):
        return jnp.mean((render(dataclasses.replace(arrays_j, leaf_params=lp), SIL_CAM) - target) ** 2)

    g_j = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(arrays_j.leaf_params)))
    np.testing.assert_allclose(g_pos, g_j, atol=0.01 * np.abs(g_j).max())


def test_log_alpha_24_against_104():
    """soft_cull_log_alpha = 24 (tests/test_soft_coverage.py:315-380) culls
    leaves whose coverage would stay under exp(-24): more leaves than 104
    on the port's 16 x 16 tiles. What it drops directly is below 4e-11; the
    rest is the sample-phase class the reference's docstring names: a
    culled leaf lengthens a step far from the surface, which moves a
    grazing ray's sampled closest approach. The reference's coarser tiles
    cull little on this scene and match to 1e-6; the port's frames match in
    the exact-semantics class (max |d| < 1e-3) and its gradients in the
    class of two f32 implementations, and the la = 24 frame matches the
    reference's."""
    spec_j, arrays_j = rm.compile_scene(_eight_spheres(rm), static=True)
    spec, arrays = from_reference(spec_j, arrays_j)
    cv = _cv(_look((0.3, 1.8, 5.0)))
    outs, active = {}, {}
    for la in (104.0, 24.0):
        cfg_j = dataclasses.replace(CFG_J, coverage_beta=0.02, leaf_cull=True, soft_cull_log_alpha=la)
        img, g, info = _port_soft(spec, arrays, cfg_j, cv, loss=lambda img: torch.sum(img**2))
        assert info["kind"] == "pallas_compact"
        outs[la] = (img, g)
        rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg_j), W, H, device="cpu", no_prepass=True, soft=True)
        sc, cam, _ = rp.scene_args(arrays, torch.tensor(cv))
        active[la] = int(rp.cull_args(sc, cam)[1].counts.sum())
    assert active[24.0] < active[104.0]
    d = np.abs(outs[104.0][0] - outs[24.0][0])
    assert d.max() < 1e-3 and d.mean() < 5e-4
    _assert_grad_class(outs[24.0][1], outs[104.0][1])
    rj = prepass_j(spec_j, cfg_j, W, H, interpret=True, no_prepass=True, aa_packed=True, soft=True)
    np.testing.assert_allclose(outs[24.0][0], np.asarray(rj(arrays_j, jnp.asarray(cv))), atol=1e-3)


def test_fit_step_trains_soft_where_the_reference_step_does_not():
    """Fault 11: one SGD step of the silhouette-only translation problem.
    The reference's pallas_fused fit step in mode "soft" trains the implicit
    gradients, which are blind to it: the centre does not move. The port's
    takes the soft VJP: its update is lr times the gradient of the
    reference's soft VJP called directly, in the class of two f32
    implementations of one backward."""
    spec_j, arrays_tj, arrays_j = _translation_problem(0.15)
    spec, arrays = from_reference(spec_j, arrays_j)
    cv = jnp.asarray(_cv(SIL_CAM))
    rv = fused_vjp_j(spec_j, SIL_CFG, W, W, interpret=True, soft=True)
    target = np.asarray(rv(arrays_tj, cv))
    masks = (np.zeros_like(arrays_j.leaf_params), np.zeros_like(arrays_j.op_param))
    masks[0][0, 4] = 1.0
    lr = 1.0
    step_j = make_fit_step_j(spec_j, W, W, make_mesh(1), optax.sgd(lr), SIL_CFG, mode="soft",
                             backend="pallas_fused", interpret=True, grad_mask=masks)
    a_j, *_ = step_j(arrays_j, SIL_CAM, step_j.init_opt_state(arrays_j), jnp.asarray(target))
    x0 = float(arrays_j.leaf_params[0, 4])
    assert float(np.asarray(a_j.leaf_params)[0, 4]) == pytest.approx(x0, abs=1e-7)  # the reference's fault

    def loss(lp):
        img = rv(dataclasses.replace(arrays_j, leaf_params=lp), cv)
        return jnp.sum((img - target) ** 2) / (W * W * 3)

    g_j = np.asarray(jax.grad(loss)(jnp.asarray(arrays_j.leaf_params)))
    step = rt.make_fit_step(spec, W, W, None, functools.partial(torch.optim.SGD, lr=lr), _cfg_t(SIL_CFG),
                            mode="soft", backend="pallas_fused", grad_mask=masks, device="cpu")
    assert step.backward_info["soft"]
    a, *_ = step(arrays, rt.Camera(SIL_CAM.position, SIL_CAM.rotation), step.init_opt_state(arrays), target)
    moved = (x0 - float(a.leaf_params[0, 4])) / lr
    assert g_j[0, 4] > 1e-6 and moved == pytest.approx(float(g_j[0, 4]), abs=0.01 * np.abs(g_j).max())


def test_soft_pose_fit_converges():
    """tests/test_soft_coverage.py:248-314 through the port's fit step: the
    silhouette-driven camera-pose fit of twelve spheres, from the same
    perturbed pose (the quaternion perturbed unnormalised, as there), with
    Adam at 2e-2 on the pose, through the compact soft backward: 30 steps
    recover most of the loss (l1 < 0.3 l0)."""
    spec, arrays = rt.compile_scene(_twelve_spheres(rt), static=True)
    w, h = 32, 24
    cfg = rt.RenderConfig(aa_samples=2, coverage_beta=0.05, leaf_cull=True, bound_accel=True)
    cam_true = rt.Camera.looking_at(position=(0.2, 1.6, 5.0), target=(0.0, 0.0, 0.0))
    render = rt.make_renderer(spec, w, h, cfg, mode="soft", backend="pallas_fused", device="cpu")
    assert render.backward_info["kind"] == "pallas_compact"
    target = render(arrays, cam_true).detach()
    d = np.asarray([0.15, -0.1, 0.12, 0.03, -0.02, 0.03, 0.0], np.float32)
    cam = rt.Camera(np.asarray(cam_true.position) + d[:3], np.asarray(cam_true.rotation) + d[3:])
    step = rt.make_fit_step(spec, w, h, None, functools.partial(torch.optim.SGD, lr=0.0), cfg, mode="soft",
                            backend="pallas_fused", fit_camera=True,
                            camera_optimizer=functools.partial(torch.optim.Adam, lr=2e-2), device="cpu")
    state = step.init_opt_state(arrays, cam)
    losses = []
    for _ in range(31):  # 30 updates, then the loss at the pose they reach
        arrays, cam, state, loss = step(arrays, cam, state, target)
        losses.append(float(loss))
    assert losses[-1] < 0.3 * losses[0], losses
