"""The port's fused forward+backward renderer against the JAX package.

`make_renderer(backend="pallas_fused")` on the CPU runs the plain versions
(`fine_res_plain`, `bwd_plain`); it is held against the JAX fused VJP
(`make_fused_render_vjp`, Pallas in interpret mode) in the reference's
class for two f32 implementations of this backward
(tests/test_pallas_grad.py:78-105), and against the f64 analytic oracle
(`oracle_grad.pixel_grads`) in the reference's oracle class (277-293).
The CUDA kernel is held to `bwd_plain` on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import dataclasses
from pathlib import Path

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
from raymarch_tpu_torch.ops import cuda_prepass as cp
from raymarch_tpu_torch.ops.cuda_march import compute_bound, compute_bound_torch
from raymarch_tpu_torch.ops.tape import from_reference

from test_grad_oracle import _word_map
from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores (the
# small ops of the plain versions then run ~10x slower).
torch.set_num_threads(1)

# tests/test_pallas_grad.py:18-31, the sphere's material left out.
CFG = dataclasses.replace(
    rm.DEFAULT_CONFIG, aa_samples=2, max_iter=300, min_dist=1e-4, bound_accel=True
)
SCENE = (
    rm.sphere(center=(-0.6, 0, 0), radius=0.9)
    | rm.box(center=(0.8, 0, 0), half_extents=(0.5, 0.5, 0.5))
).union(rm.torus(center=(0, 0.8, 0), major_radius=0.7, minor_radius=0.25), k=0.2)
CAM = rm.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
W, H = 32, 24


def _cfg_t(cfg):
    return rt.RenderConfig(**dataclasses.asdict(cfg))


def _cv(cam):
    return np.concatenate([cam.position, cam.rotation, [0.0]]).astype(np.float32)


def _port_grads(spec, arrays, cfg, w, h, cam_vec, loss_fn):
    """Image and (d_lp, d_opp, d_cam) of the port's fused renderer on the
    CPU, from the same numpy parameters."""
    spec_t, arrays_t = from_reference(spec, arrays)
    render = rt.make_renderer(spec_t, w, h, _cfg_t(cfg), mode="implicit", backend="pallas_fused", device="cpu")
    lp = torch.tensor(arrays_t.leaf_params, requires_grad=True)
    opp = torch.tensor(arrays_t.op_param, requires_grad=True)
    cv = torch.tensor(cam_vec, requires_grad=True)
    img = render.renderer(dataclasses.replace(arrays_t, leaf_params=lp, op_param=opp), cv)
    loss_fn(img).backward()
    return img.detach().numpy(), lp.grad.numpy(), opp.grad.numpy(), cv.grad.numpy()


@pytest.fixture(scope="module")
def vs_jax():
    spec, arrays = rm.compile_scene(SCENE, static=True)
    rf = fused_vjp_j(spec, CFG, W, H, interpret=True, bm=8)
    cv = _cv(CAM)

    def loss_j(lp, opp, c):
        a = dataclasses.replace(arrays, leaf_params=lp, op_param=opp)
        return jnp.mean((rf(a, c) - 0.3) ** 2)

    img_j = np.asarray(rf(arrays, jnp.asarray(cv)))
    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(arrays.leaf_params), jnp.asarray(arrays.op_param), jnp.asarray(cv)
    )
    port = _port_grads(spec, arrays, CFG, W, H, cv, lambda img: torch.mean((img - 0.3) ** 2))
    return (img_j, *(np.asarray(g) for g in grads_j)), port


def test_fused_forward_matches_jax(vs_jax):
    (img_j, *_), (img, *_) = vs_jax
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert np.abs(img - img_j).mean() < 1e-4


@pytest.mark.parametrize("which", ["leaf_params", "op_param", "camera"])
def test_fused_grads_match_jax(vs_jax, which):
    (_, gl_j, go_j, gc_j), (_, gl, go, gc) = vs_jax
    scale = np.abs(gl_j).max()
    assert scale > 0
    if which == "leaf_params":
        np.testing.assert_allclose(gl, gl_j, atol=0.01 * scale)
    elif which == "op_param":
        assert np.abs(go_j).max() > 0  # the blend radius carries gradient
        np.testing.assert_allclose(go, go_j, atol=0.01 * scale)
    else:
        cscale = np.abs(gc_j[:7]).max()
        np.testing.assert_allclose(gc[:7], gc_j[:7], atol=0.02 * cscale)
        assert gc[7] == 0.0 and gc_j[7] == 0.0


def test_fused_grads_match_oracle():
    """tests/test_pallas_grad.py:178-293 with the port in the place of the
    JAX fused VJP: weighted-pixel-loss gradients of every tape word and of
    the camera pose against the f64 analytic oracle, with the reference
    test's pixel weights."""
    cfg = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=80)
    scene = (
        rm.sphere(center=(-0.55, 0.0, 0.1), radius=0.85).union(
            rm.box(center=(0.7, 0.05, -0.1), half_extents=(0.45, 0.5, 0.4)), k=0.35
        )
    ) - rm.torus(center=(0.0, 0.75, 0.0), major_radius=0.65, minor_radius=0.22)
    cam = rm.Camera.looking_at(position=(0.4, 1.5, 4.0), target=(0.0, 0.0, 0.0))
    w, h = 64, 32
    tape = rm.encode_wire(scene)
    spec, arrays = rm.compile_scene(scene, static=True, rebalance=False)
    wmap = _word_map(tape, spec)
    S = cfg.aa_samples**2

    idx = jnp.arange(w * h * S, dtype=jnp.int32)
    o_dev, d_dev = rm.raygen_flat(
        idx, jnp.asarray(cam.position, jnp.float64), jnp.asarray(cam.rotation, jnp.float64), w, h, cfg
    )
    col, dcol, dcam = pixel_grads(
        tape, np.asarray(o_dev, np.float64), np.asarray(d_dev, np.float64), cfg,
        cam_rotation=np.asarray(cam.rotation),
    )
    img_o = col.reshape(h, w, S, 3).mean(2)

    # The weights of the reference's test: its own fused forward picks the
    # pixels where f32 and f64 agree (a pixel inside the 1e-4 band can still
    # hold a sample whose f32 hit lies a min_dist step off the f64 one, and
    # its gradient is then off by a few percent: choosing the pixels with
    # the port's forward instead would weigh other such pixels).
    rv = fused_vjp_j(spec, cfg, w, h, interpret=True, prepass_block=1)
    img_j = np.asarray(rv(arrays, jnp.asarray(_cv(cam))))
    agree = np.abs(img_j - img_o).max(-1) < 1e-4
    G = np.random.default_rng(23).uniform(0.5, 1.5, (h, w, 3)) * agree[:, :, None]
    Gt = torch.tensor(G, dtype=torch.float32)
    img_d, gl, go, gc = _port_grads(spec, arrays, cfg, w, h, _cv(cam), lambda img: torch.sum(img * Gt))
    assert (np.abs(img_d - img_o).max(-1) < 1e-4).mean() > 0.9

    Gray = np.repeat(G[:, :, None, :], S, axis=2).reshape(-1, 3) / S
    oracle_words = np.einsum("nc,ncw->w", Gray, dcol)
    oracle_cam = np.einsum("nc,ncw->w", Gray, dcam)
    dev_words = np.zeros(len(tape))
    for wd, m in wmap.items():
        dev_words[wd] = gl[m[1], m[2]] if m[0] == "leaf" else go[m[1]]

    # The reference's class: f32 rounding passes through the eps = 1e-4
    # tetrahedron taps, so single words sit at the percent level.
    scale = np.abs(oracle_words).max()
    np.testing.assert_allclose(dev_words, oracle_words, rtol=3e-2, atol=1e-3 * scale)
    rel = np.abs(dev_words - oracle_words) / (np.abs(oracle_words) + 1e-3 * scale)
    assert np.median(rel) < 1e-2, rel
    cscale = np.abs(oracle_cam).max()
    np.testing.assert_allclose(gc[:7], oracle_cam, rtol=3e-2, atol=1e-3 * cscale)
    assert gc[7] == 0.0


@pytest.fixture(scope="module")
def small():
    spec, arrays = rt.compile_scene(SCENES["config2"](rt), static=True)
    cfg = _cfg_t(CFG)
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, device="cpu")
    scene, cam, bound = fr.prepass.scene_args(arrays, rt.cam_vec(rt.Camera(CAM.position, CAM.rotation), device="cpu"))
    pre = cp.coarse(scene, cam, bound, fr.params)
    return spec, arrays, fr, scene, cam, bound, pre


def test_residuals_keep_the_image(small):
    *_, fr, scene, cam, bound, pre = small
    p = fr.params
    img = cp.fine_plain(scene, cam, bound, p, *pre)
    img_r, t, hit = cp.fine_res_plain(scene, cam, bound, p, *pre)
    assert torch.equal(img, img_r)
    assert t.shape == hit.shape == (H, W, p.naa * p.naa)
    assert set(torch.unique(hit).tolist()) == {0.0, 1.0}
    # The CPU wrappers are the plain versions; no kernel runs.
    before = (cp.fine.launches, cp.fine_res.launches)
    img_w, t_w, hit_w = cp.fine_res(scene, cam, bound, p, *pre)
    assert torch.equal(img_w, img) and torch.equal(t_w, t) and torch.equal(hit_w, hit)
    assert (cp.fine.launches, cp.fine_res.launches) == before


def test_bwd_layout_and_camera_word(small):
    spec, _, fr, scene, cam, bound, pre = small
    _, t, hit = cp.fine_res_plain(scene, cam, bound, fr.params, *pre)
    g = torch.tensor(np.random.default_rng(3).uniform(-1, 1, (H, W, 3)).astype(np.float32))
    before = cg.bwd.launches
    d_lp, d_opp, d_cam = cg.bwd(scene, cam, fr.params, fr.layout, t, hit, g)
    assert cg.bwd.launches == before
    assert d_lp.shape == (spec.n_leaves, 16) and d_opp.shape == (spec.n_instr,) and d_cam.shape == (8,)
    assert d_cam[7] == 0.0 and bool(torch.isfinite(d_cam).all())
    unpushed = [r for r in range(spec.n_leaves) if r not in fr.layout.pushed_rows]
    assert unpushed and float(d_lp[unpushed].abs().max()) == 0.0
    assert float(d_lp.abs().max()) > 0.0
    assert fr.layout.nscal == 16 * len(fr.layout.pushed_rows) + len(spec.static_tape) + 7
    # Bands add up to the whole frame.
    whole = cg.bwd_plain(scene, cam, fr.params, fr.layout, t, hit, g, band_rows=H)
    for a, b in zip(whole, (d_lp, d_opp, d_cam)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_backward_info_is_the_references(small):
    fr = small[2]
    spec_j, _ = rm.compile_scene(SCENES["config2"](rm), static=True)
    ref = fused_vjp_j(spec_j, dataclasses.replace(CFG, aa_samples=4), 64, 36, interpret=True).backward_info
    for key in ("kind", "compact", "reason", "aa_packed", "soft"):
        assert fr.backward_info[key] == ref[key], key
    render = rt.make_renderer(fr.spec, W, H, fr.cfg, mode="implicit", backend="pallas_fused", device="cpu")
    assert render.backward_info == fr.backward_info


@pytest.mark.parametrize(
    "kw,cfg_kw,what,exc",
    [
        # soft is ported (tests/test_torch_soft.py); it raises the
        # reference's ValueError where aa_samples^2 does not divide 128.
        (dict(soft=True), dict(aa_samples=3), None, ValueError),
        # leaf_cull, prepass_block and painted scenes are ported
        # (tests/test_torch_legacy.py); these cases raise as before.
        (dict(band_rows=8), {}, None, NotImplementedError),
        # The unpacked route is ported (tests/test_torch_unpacked.py): K4
        # with residuals, then K8; it trains (None below).
        (dict(aa_packed=False), {}, None, None),
        ({}, {}, "dynamic", NotImplementedError),
    ],
    ids=["soft", "band_rows", "unpacked", "dynamic"],
)
def test_unported_options_raise(kw, cfg_kw, what, exc):
    scene = SCENES["config2"](rt)
    spec, arrays = rt.compile_scene(scene, static=what != "dynamic")
    cfg = dataclasses.replace(_cfg_t(CFG), **cfg_kw)
    if exc is None:
        fr = cg.make_fused_render_vjp(spec, cfg, W, H, device="cpu", **kw)
        assert fr.prepass.params.unpacked and fr.backward_info["aa_packed"] is False
        lp = torch.tensor(arrays.leaf_params, requires_grad=True)
        img = fr(dataclasses.replace(arrays, leaf_params=lp), torch.tensor(_cv(CAM)))
        torch.mean(img * img).backward()
        assert bool(torch.isfinite(lp.grad).all()) and float(lp.grad.abs().max()) > 0
        return
    with pytest.raises(exc, match="ROADMAP" if exc is NotImplementedError else "128"):
        cg.make_fused_render_vjp(spec, cfg, W, H, device="cpu", **kw)


def test_fused_modes(small):
    spec = small[0]
    with pytest.raises(ValueError):
        rt.make_renderer(spec, W, H, _cfg_t(CFG), mode="forward", backend="pallas_fused", device="cpu")
    # Mode "soft" is ported (tests/test_torch_soft.py): its own renderer,
    # with no prepass.
    soft = rt.make_renderer(spec, W, H, _cfg_t(CFG), mode="soft", backend="pallas_fused", device="cpu")
    hard = rt.make_renderer(spec, W, H, _cfg_t(CFG), mode="implicit", backend="pallas_fused", device="cpu")
    assert soft.backward_info["soft"] and not hard.backward_info["soft"]
    assert soft.renderer.params.no_prepass and soft.renderer is not hard.renderer


def test_tensor_parameters_render_like_numpy(small):
    """Parameters that are already tensors (a fit's, with requires_grad)
    render through pallas_prepass bit for bit like the same numpy values."""
    spec, arrays = small[:2]
    render = rt.make_renderer(spec, W, H, _cfg_t(CFG), mode="forward", backend="pallas_prepass", device="cpu")
    cam = rt.Camera(CAM.position, CAM.rotation)
    ref = render(arrays, cam)
    lp = torch.tensor(arrays.leaf_params, requires_grad=True)
    opp = torch.tensor(arrays.op_param, requires_grad=True)
    img = render(dataclasses.replace(arrays, leaf_params=lp, op_param=opp), cam)
    assert torch.equal(img, ref)
    meta = dataclasses.replace(arrays, leaf_params=torch.zeros(arrays.leaf_params.shape, device="meta"))
    with pytest.raises(ValueError, match="expected cpu"):
        render(meta, cam)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bound_torch_form_equals_numpy(name):
    spec, arrays = rt.compile_scene(SCENES[name](rt), static=True)
    ref = compute_bound(spec, arrays)
    got = compute_bound_torch(spec, torch.tensor(arrays.leaf_params), torch.tensor(arrays.op_param))
    assert got.dtype == torch.float32 and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kernel_constants_match_cuda_sources():
    """The wrapper's sizes are the kernels': the block sizes behind the
    shared-memory routes and the record sets of a legacy backward thread."""
    csrc = Path(cg.__file__).parent.parent / "csrc"
    assert f"constexpr int BWD_THREADS = {cg.BWD_THREADS};" in (csrc / "fused_bwd.cu").read_text()
    assert f"constexpr int BWD_WARP_THREADS = {cg.BWD_WARP_THREADS};" in (csrc / "fused_bwd.cu").read_text()
    assert f"constexpr int CBWD_THREADS = {cg.CBWD_THREADS};" in (csrc / "compact_bwd.cu").read_text()
    assert f"constexpr int TAP_SETS = {cg.TAP_SETS};" in (csrc / "scene_grad.cuh").read_text()
