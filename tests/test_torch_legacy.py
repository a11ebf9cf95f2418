"""The port's legacy backward (K8) on every static scene that the reference
sends to it, against the JAX package.

`make_fused_render_vjp` / `make_renderer(backend="pallas_fused")` on the CPU
run the plain versions (`fine_res_plain`, `bwd_plain`). They are held
against the JAX fused VJP (Pallas in interpret mode) in the reference's
class for two f32 implementations of this backward (0.01 max|g| for scene
words, 0.02 for the camera; tests/test_pallas_grad.py:78-105) and against
the f64 analytic oracle (`oracle_grad.pixel_grads`, rtol 3e-2 with atol
1e-3 max|g| and a median relative error under 1e-2; 277-293), on:

- a painted scene without `leaf_cull` (reason "leaf_cull disabled");
- a painted smooth blend under `leaf_cull` (reason "painted materials on
  smooth/ordered segments"): the albedo's cotangent also reaches the blend
  weights, the geometry and the blend radius;
- a plan with residual subtrees whose tape has 67 instructions (33 spheres
  intersected with a box; the long build of K8 on the card). The JAX
  backward of this tape in interpret mode takes minutes, so this case is
  held against the oracle alone;
- BASELINE config 2 with `prepass_block=4` (image and gradients).

It also makes the reference's calls (positional `chunk`, `bm=128`,
`interpret=False`) and fits a painted scene's albedo. The kernels are held
to these plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.
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
from raymarch_tpu.ops.oracle_grad import pixel_grads
from raymarch_tpu.ops.pallas_grad import make_fused_render_vjp as fused_vjp_j
from raymarch_tpu_torch.ops import cuda_grad as cg
from raymarch_tpu_torch.ops.tape import from_reference

from test_grad_oracle import _word_map
from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes.
torch.set_num_threads(1)

CFG = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=300, min_dist=1e-4, bound_accel=True)
W, H = 32, 24


def _painted_smooth(m):
    """tests/test_torch_grad.py's painted smooth blend: a painted sphere
    smooth-united with an unpainted one, and a third sphere (one seg1 chain
    under leaf_cull)."""
    return m.sphere(center=(-0.5, 0, 0), radius=0.7, material=(0.8, 0.2, 0.1)).union(
        m.sphere(center=(0.5, 0, 0), radius=0.6), k=0.2) | m.sphere(center=(0.0, 1.0, 0.0), radius=0.3)


def _long_tape(m):
    """bench.py's random spheres (seed 7), the first 33, intersected at the
    root with a box: a plan with residual subtrees, 67 instructions."""
    rng = np.random.default_rng(7)
    parts = []
    for _ in range(33):
        c = rng.uniform(-3, 3, 3)
        c[1] = rng.uniform(-1.0, 1.5)
        parts.append(m.sphere(center=tuple(c), radius=float(rng.uniform(0.15, 0.5))))
    scene = parts[0]
    for p in parts[1:]:
        scene = scene | p
    return scene & m.box(half_extents=(3.2, 1.2, 3.2))


# name -> (scene, config changes, make_fused_render_vjp keywords, camera
# position, the reference's reason)
CASES = {
    "painted_transformed": (SCENES["painted_transformed"], {}, {}, (0.0, 1.6, 4.2), "leaf_cull disabled"),
    "painted_smooth": (_painted_smooth, dict(leaf_cull=True), {}, (0.0, 1.6, 4.2),
                       "painted materials on smooth/ordered segments"),
    # max_iter 80 and one ray per pixel: the f64 oracle's march walks the
    # 67-instruction tape per step in numpy (43 s at 300 steps and 2x2 AA).
    "long_tape": (_long_tape, dict(leaf_cull=True, relax=1.6, max_iter=80, aa_samples=1), {}, (0.0, 2.5, 9.0),
                  "plan has residual (unrolled) subtrees"),
    "block4": (SCENES["config2"], {}, dict(prepass_block=4), (0.0, 1.6, 4.2), "leaf_cull disabled"),
}


def _case(name):
    build, cfg_kw, kw, pos, reason = CASES[name]
    cfg = dataclasses.replace(CFG, **cfg_kw)
    cam = rm.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0))
    return build, cfg, kw, cam, reason


def _cv(cam):
    return np.concatenate([cam.position, cam.rotation, [0.0]]).astype(np.float32)


def _cfg_t(cfg):
    return rt.RenderConfig(**dataclasses.asdict(cfg))


def _port_grads(spec_j, arrays_j, cfg, kw, cam, loss_fn):
    """Image and (d_lp, d_opp, d_cam) of the port's fused renderer on the
    CPU, from the same numpy parameters."""
    spec, arrays = from_reference(spec_j, arrays_j)
    fr = cg.make_fused_render_vjp(spec, _cfg_t(cfg), W, H, device="cpu", **kw)
    lp = torch.tensor(arrays.leaf_params, requires_grad=True)
    opp = torch.tensor(arrays.op_param, requires_grad=True)
    cv = torch.tensor(_cv(cam), requires_grad=True)
    img = fr(dataclasses.replace(arrays, leaf_params=lp, op_param=opp), cv)
    loss_fn(img).backward()
    return img.detach().numpy(), lp.grad.numpy(), opp.grad.numpy(), cv.grad.numpy()


@pytest.fixture(scope="module", params=["painted_transformed", "painted_smooth", "block4"])
def vs_jax(request):
    """The JAX fused VJP (interpret mode) and the port on one case: image
    and gradients of mean((img - 0.3)^2), the JAX side in one jax.vjp."""
    build, cfg, kw, cam, _ = _case(request.param)
    spec, arrays = rm.compile_scene(build(rm), static=True)
    rf = fused_vjp_j(spec, cfg, W, H, interpret=True, bm=8, **kw)
    cv = jnp.asarray(_cv(cam))

    def render(lp, opp, c):
        return rf(dataclasses.replace(arrays, leaf_params=lp, op_param=opp), c)

    img_j, vjp = jax.vjp(render, jnp.asarray(arrays.leaf_params), jnp.asarray(arrays.op_param), cv)
    grads_j = vjp(2.0 * (img_j - 0.3) / img_j.size)
    port = _port_grads(spec, arrays, cfg, kw, cam, lambda img: torch.mean((img - 0.3) ** 2))
    return request.param, (np.asarray(img_j), *(np.asarray(g) for g in grads_j)), port


def test_image_matches_jax(vs_jax):
    _, (img_j, *_), (img, *_) = vs_jax
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert np.abs(img - img_j).mean() < 1e-4


def test_grads_match_jax(vs_jax):
    name, (_, gl_j, go_j, gc_j), (_, gl, go, gc) = vs_jax
    scale = np.abs(gl_j).max()
    assert scale > 0
    np.testing.assert_allclose(gl, gl_j, atol=0.01 * scale)
    np.testing.assert_allclose(go, go_j, atol=0.01 * scale)
    cscale = np.abs(gc_j[:7]).max()
    np.testing.assert_allclose(gc[:7], gc_j[:7], atol=0.02 * cscale)
    assert gc[7] == 0.0
    if name.startswith("painted"):
        # The albedo and flag words carry gradient.
        assert np.abs(gl[:, 12:16]).max() > 0.05 * scale
    if name == "painted_smooth":
        # The blend radius: through the distance and the blend weight.
        assert np.abs(go).max() > 0


@pytest.mark.parametrize("name", ["painted_transformed", "painted_smooth", "long_tape"])
def test_grads_match_oracle(name):
    """tests/test_pallas_grad.py:178-293 on the legacy backward's scenes:
    weighted-pixel-loss gradients of every tape word (the albedo words of
    a painted leaf among them) and of the camera pose against the f64
    oracle. The pixels are those where the port's own forward agrees with
    the oracle's image."""
    build, cfg, kw, cam, _ = _case(name)
    scene = build(rm)
    tape = rm.encode_wire(scene)
    spec, arrays = rm.compile_scene(scene, static=True, rebalance=False)
    wmap = _word_map(tape, spec)
    S = cfg.aa_samples ** 2
    idx = jnp.arange(W * H * S, dtype=jnp.int32)
    o_dev, d_dev = rm.raygen_flat(
        idx, jnp.asarray(cam.position, jnp.float64), jnp.asarray(cam.rotation, jnp.float64), W, H, cfg
    )
    col, dcol, dcam = pixel_grads(
        tape, np.asarray(o_dev, np.float64), np.asarray(d_dev, np.float64), cfg,
        cam_rotation=np.asarray(cam.rotation),
    )
    img_o = col.reshape(H, W, S, 3).mean(2)
    spec_t, arrays_t = from_reference(spec, arrays)
    img_d = cg.make_fused_render_vjp(spec_t, _cfg_t(cfg), W, H, device="cpu", **kw)(arrays_t, _cv(cam)).numpy()
    agree = np.abs(img_d - img_o).max(-1) < 1e-4
    assert agree.mean() > 0.9
    G = np.random.default_rng(23).uniform(0.5, 1.5, (H, W, 3)) * agree[:, :, None]
    Gt = torch.tensor(G, dtype=torch.float32)
    _, gl, go, gc = _port_grads(spec, arrays, cfg, kw, cam, lambda img: torch.sum(img * Gt))

    Gray = np.repeat(G[:, :, None, :], S, axis=2).reshape(-1, 3) / S
    oracle_words = np.einsum("nc,ncw->w", Gray, dcol)
    oracle_cam = np.einsum("nc,ncw->w", Gray, dcam)
    dev_words = np.zeros(len(tape))
    for wd, m in wmap.items():
        dev_words[wd] = gl[m[1], m[2]] if m[0] == "leaf" else go[m[1]]
    scale = np.abs(oracle_words).max()
    np.testing.assert_allclose(dev_words, oracle_words, rtol=3e-2, atol=1e-3 * scale)
    rel = np.abs(dev_words - oracle_words) / (np.abs(oracle_words) + 1e-3 * scale)
    assert np.median(rel) < 1e-2, rel
    cscale = np.abs(oracle_cam).max()
    np.testing.assert_allclose(gc[:7], oracle_cam, rtol=3e-2, atol=1e-3 * cscale)
    albedo_words = [wd for wd, m in wmap.items() if m[0] == "leaf" and m[2] >= 12]
    if name.startswith("painted"):
        assert albedo_words and np.abs(oracle_words[albedo_words]).max() > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_info_is_the_references(name):
    """Every case takes the legacy backward with the reference's kind and
    reason, through make_fused_render_vjp and make_renderer alike; the long
    tape takes K8's long build."""
    build, cfg, kw, _, reason = _case(name)
    spec_j, arrays_j = rm.compile_scene(build(rm), static=True)
    ref = fused_vjp_j(spec_j, cfg, W, H, interpret=True, bm=8, **kw).backward_info
    spec, _ = from_reference(spec_j, arrays_j)
    fr = cg.make_fused_render_vjp(spec, _cfg_t(cfg), W, H, device="cpu", **kw)
    # aa_packed is left out: the port packs a pixel's samples wherever
    # aa_samples^2 divides 128, where the reference's VMEM budget may unpack
    # the legacy kernel's layout.
    for key in ("kind", "compact", "reason", "soft"):
        assert fr.backward_info[key] == ref[key], key
    assert (fr.backward_info["kind"], fr.backward_info["reason"]) == ("pallas_legacy_unrolled", reason)
    assert fr.params.block == kw.get("prepass_block", 1)
    if not kw:
        render = rt.make_renderer(spec, W, H, _cfg_t(cfg), mode="implicit", backend="pallas_fused", device="cpu")
        assert render.backward_info == fr.backward_info
    assert fr.layout.long == (name == "long_tape")
    if name == "long_tape":
        assert fr.layout.n_real == 67 > cg.MAX_BWD_INSTR


def test_long_build_limits():
    """The long build's record and gradient-row sizes: 2 floats per
    instruction (5 with materials) per thread, nscal words per block; the
    64 spheres of bench.py intersected with a box need 129 instructions and
    1,176 words, past both limits of the per-thread build."""
    spec, _ = rt.compile_scene(_long_tape(rt), static=True)
    lay = cg.GradLayout.of(spec, rt.DEFAULT_CONFIG)
    assert lay.long and lay.hist_len(False) == 2 * 67 and lay.hist_len(True) == 5 * 67
    rng = np.random.default_rng(7)
    parts = [rt.sphere(center=tuple(rng.uniform(-3, 3, 3)), radius=0.3) for _ in range(64)]
    scene = functools.reduce(lambda a, b: a | b, parts) & rt.box(half_extents=(3.2, 1.2, 3.2))
    lay64 = cg.GradLayout.of(rt.compile_scene(scene, static=True)[0], rt.DEFAULT_CONFIG)
    assert (lay64.n_real, lay64.nscal) == (129, 1176)
    assert lay64.long and lay64.nscal * (cg.BWD_THREADS + 1) * 4 > cg.SMEM_PER_BLOCK
    assert lay64.nscal * 4 <= cg.SMEM_PER_BLOCK
    small = cg.GradLayout.of(rt.compile_scene(SCENES["config2"](rt), static=True)[0], rt.DEFAULT_CONFIG)
    assert not small.long


@pytest.mark.parametrize("entry", ["make_renderer", "make_fused_render_vjp", "make_fit_step"])
def test_reference_style_calls(entry):
    """The reference's positional order and its layout keywords (`chunk`,
    `bm`, `interpret`) are accepted and change nothing."""
    spec, arrays = rt.compile_scene(SCENES["config2"](rt), static=True)
    cfg = _cfg_t(CFG)
    cam = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    if entry == "make_renderer":
        # raymarch_tpu.ops.march.make_renderer(spec, width, height, cfg,
        # mode, chunk, backend, interpret)
        render = rt.make_renderer(spec, W, H, cfg, "implicit", 4096, "pallas_fused", False, device="cpu")
        ref = rt.make_renderer(spec, W, H, cfg, mode="implicit", backend="pallas_fused", device="cpu")
        assert torch.equal(render(arrays, cam), ref(arrays, cam))
        fwd = rt.make_renderer(spec, W, H, cfg, "forward", None, "pallas_prepass", interpret=True, device="cpu")
        assert torch.equal(fwd(arrays, cam), ref(arrays, cam).detach())
    elif entry == "make_fused_render_vjp":
        # bench.py:701 passes bm=128; the reference's positional order is
        # (spec, cfg, width, height, interpret, bm, prepass_block, ...).
        fr = cg.make_fused_render_vjp(spec, cfg, W, H, False, 128, device="cpu")
        assert fr is cg.make_fused_render_vjp(spec, cfg, W, H, interpret=True, bm=8, device="cpu")
        assert fr.params.block == 1
        assert cg.make_fused_render_vjp(spec, cfg, W, H, False, None, 4, device="cpu").params.block == 4
    else:
        # raymarch_tpu.parallel.render.make_fit_step(spec, width, height,
        # mesh, optimizer, cfg, mode, backend, fit_camera, grad_mask,
        # interpret, camera_optimizer, row_interleave)
        opt = functools.partial(torch.optim.SGD, lr=1e-3)
        step = rt.make_fit_step(spec, W, H, None, opt, cfg, "implicit", "pallas_fused", False, None, False,
                                None, 1, device="cpu")
        target = np.zeros((H, W, 3), np.float32) + 0.2
        a1, _, _, loss = step(arrays, cam, step.init_opt_state(arrays), target)
        assert float(loss) > 0 and a1.leaf_params.shape == arrays.leaf_params.shape
    # The "jnp" backend is ported (tests/test_torch_march.py), and so is the
    # unpacked fine pass K4 that the reference's make_renderer takes with
    # aa_shared_normals (march.py:446-449; tests/test_torch_unpacked.py).
    shared = rt.make_renderer(spec, W, H, dataclasses.replace(cfg, aa_shared_normals=True), "forward", None,
                              "pallas_prepass", device="cpu")
    assert shared.renderer.params.unpacked and shared.renderer.params.shared_normals
    img = shared(arrays, cam)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())


def test_painted_fit_recovers_albedo():
    """fit_scene through the legacy backward's albedo words: the painted
    sphere's albedo, started off its truth, moves back toward it."""
    spec, arrays = rt.compile_scene(SCENES["painted_transformed"](rt), static=True)
    cfg = _cfg_t(CFG)
    cam = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    target = rt.make_renderer(spec, W, H, cfg, mode="forward", backend="pallas_prepass", device="cpu")(arrays, cam)
    row = int(np.nonzero(arrays.leaf_params[:, 15])[0][0])  # a painted leaf
    truth = arrays.leaf_params.copy()
    start = truth.copy()
    start[row, 12:15] = np.clip(truth[row, 12:15] + np.array([-0.3, 0.3, 0.3]), 0.05, 0.95)
    mask = np.zeros_like(truth)
    mask[row, 12:15] = 1.0
    res = rt.fit_scene(spec, dataclasses.replace(arrays, leaf_params=start), cam, target, width=W, height=H,
                       cfg=cfg, steps=8, learning_rate=5e-2, leaf_mask=mask, backend="pallas_fused",
                       device="cpu", log_fn=lambda m: None)
    assert res.backward_info["reason"] == "leaf_cull disabled"
    assert res.losses[-1] < 0.5 * res.losses[0]
    got = res.arrays.leaf_params.numpy()[row, 12:15]
    assert np.abs(got - truth[row, 12:15]).sum() < 0.5 * np.abs(start[row, 12:15] - truth[row, 12:15]).sum()
