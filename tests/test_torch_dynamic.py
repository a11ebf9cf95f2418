"""The prepass renderer on a dynamic tape against the JAX package.

A dynamic tape (`compile_scene(scene)`, the reference's default) is data:
the frame's tape rides with its arrays, so a topology edit within the
tape's bucket is a buffer write and builds no renderer (runtime.py:1-27).
The port's coarse, chained pixel and fine passes interpret it in their DYN
builds (csrc/prepass_dyn.cu, the march-only builds of csrc/fine_march.cu,
the soft ones of csrc/fine_soft.cu; here their plain versions, on CPU
tensors). They are held against the JAX `make_pallas_image_render_aa` on
the same dynamic spec (Pallas in interpret mode, as tests/test_prepass.py
runs it), in tests/test_torch_prepass.py's class, and against the port's
static frame of the same scene.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_march_fast as march_fast_j
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as render_aa_j
from raymarch_tpu_torch.ops import cuda_prepass as cp

from test_torch_cuda import _rich
from test_torch_prepass import _assert_images_close, _cfg_t, _cv_j, _cv_t
from test_torch_tape import SCENES

# One torch thread per process (see tests/test_torch_prepass.py).
torch.set_num_threads(1)

W, H = 32, 24
CFG = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=80, bound_accel=True, exit_check_every=4)
CAM = rm.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
CAM_WIDE = rm.Camera.looking_at(position=(0.0, 2.6, 6.5), target=(0.0, 0.0, 0.0))


def _painted16(m):
    """16 painted spheres in one hard union (seed 17, bench.py:805-820's
    scene cut to 16)."""
    rng = np.random.default_rng(17)
    scene = None
    for _ in range(16):
        c = rng.uniform(-2, 2, 3)
        c[1] = rng.uniform(-0.8, 1.2)
        s = m.sphere(center=tuple(c), radius=float(rng.uniform(0.2, 0.5)), material=tuple(rng.uniform(0.1, 0.9, 3)))
        scene = s if scene is None else scene | s
    return scene


def _port(scene, cfg, static, cam=CAM, **kw):
    spec, arrays = rt.compile_scene(scene(rt), static=static)
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, H, device="cpu", **kw)
    return rp, rp(arrays, _cv_t(cam)).numpy()


@functools.lru_cache(maxsize=None)
def _jax(scene, cfg, static, wide=False):
    """The JAX frame from CAM (or CAM_WIDE), cached: the reference-call-form
    test reuses one."""
    spec, arrays = rm.compile_scene(scene(rm), static=static)
    return np.asarray(render_aa_j(spec, cfg, W, H, interpret=True, bm_coarse=8, bm_fine=8, prepass_block=1,
                                  aa_packed=True)(arrays, _cv_j(CAM_WIDE if wide else CAM)))


@pytest.mark.parametrize(
    "name,cfg_kw",
    [("config2", {}), ("empty", {}), ("config2", dict(leaf_cull=True)), ("config2", dict(relax=1.6))],
    ids=["config2", "empty", "config2_leaf_cull", "config2_relax"],
)
def test_dynamic_frame_matches_jax_dynamic(name, cfg_kw):
    cfg = dataclasses.replace(CFG, **cfg_kw)
    rp, img = _port(SCENES[name], cfg, static=False)
    assert rp.spec.static_tape is None and not rp.compact
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    _assert_images_close(img, _jax(SCENES[name], cfg, static=False))
    if name == "empty":  # floor and sky only
        assert float((img[..., 2] > img[..., 1]).mean()) > 0.1


@pytest.mark.parametrize("scene", [_rich, _painted16], ids=["rich", "painted16"])
def test_dynamic_frame_matches_jax(scene):
    """Every leaf type and op, and 16 painted spheres (the colour walk of a
    dynamic tape), held against the JAX package's frame of the same scene.
    The JAX dynamic interpreter takes 80-180 s at this size in interpret
    mode, so the JAX side renders the static tape, which its own tests hold
    equal to the dynamic one (tests/test_prepass.py); the port's dynamic
    frame is held to its static frame as well."""
    wide = scene is _painted16
    cam = CAM_WIDE if wide else CAM
    _, img = _port(scene, CFG, static=False, cam=cam)
    _, img_s = _port(scene, CFG, static=True, cam=cam)
    assert np.isfinite(img).all()
    _assert_images_close(img, _jax(scene, CFG, static=True, wide=wide))
    assert np.abs(img - img_s).max() < 1e-3


@pytest.mark.parametrize(
    "name,cfg_kw,kw",
    [
        ("config2", {}, {}),
        ("config2", dict(leaf_cull=True, relax=1.6), {}),
        ("all_prims", dict(leaf_cull=True), {}),
        ("painted_transformed", {}, {}),
        ("config2", {}, dict(prepass_block=4)),
        ("config2", dict(relax=1.6), dict(n_intervals=2)),
        ("config2", {}, dict(no_prepass=True)),
        ("config2", dict(aa_shared_normals=True), {}),
        ("config2", dict(aa_samples=3, leaf_cull=True), {}),
    ],
    ids=["config2", "cull_relax", "all_prims_cull", "painted", "block4", "intervals", "no_prepass",
         "shared_normals", "aa3_cull"],
)
def test_dynamic_frame_matches_static(name, cfg_kw, kw):
    """The dynamic tape through each option of the live path against the
    static tape of the same scene: the same leaves fold in the same order,
    so only the scene bound (a dynamic spec's bank keeps its padding rows)
    moves where the rays start."""
    cfg = dataclasses.replace(CFG, **cfg_kw)
    _, img_d = _port(SCENES[name], cfg, static=False, **kw)
    _, img_s = _port(SCENES[name], cfg, static=True, **kw)
    assert np.abs(img_d - img_s).max() < 1e-3


def test_make_renderer_reference_call_form():
    """make_renderer(spec, W, H, cfg, "forward", chunk, "pallas_prepass",
    interpret) on a dynamic spec, as runtime.py:142-151 and viewer.py:
    229-237 call it; a topology edit within the bucket keeps the TapeSpec,
    so it gets the same renderer back and renders the edit."""
    cfg = _cfg_t(CFG)
    cam = rt.Camera(CAM.position, CAM.rotation)
    spec, arrays = rt.compile_scene(SCENES["config2"](rt))
    render = rt.make_renderer(spec, W, H, cfg, "forward", None, "pallas_prepass", False, device="cpu")
    img = render(arrays, cam)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    ref = _jax(SCENES["config2"], CFG, static=False)
    _assert_images_close(img.numpy(), ref)
    edited = SCENES["config2"](rt) | rt.sphere(center=(0.0, 1.3, 0.0), radius=0.3)
    spec2, arrays2 = rt.compile_scene(edited)
    assert spec2 == spec
    assert rt.make_renderer(spec2, W, H, cfg, "forward", None, "pallas_prepass", False, device="cpu") is render
    img2 = render(arrays2, cam)
    assert float((img2 - img).abs().max()) > 0.05
    # The CPU runs the plain versions: no kernel launched.
    assert cp.coarse.dyn_launches == 0 and cp.fine.dyn_launches == 0


def test_plain_gated_dynamic_tape_matches_ungated():
    """The gated DYN interpreter (the tile masks of a culled frame) gives
    the un-culled frame's hits: the lemma of ops/culling.py."""
    cfg = _cfg_t(dataclasses.replace(CFG, leaf_cull=True))
    spec, arrays = rt.compile_scene(SCENES["all_prims"](rt))
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device="cpu")
    sc, cam, bound = rp.scene_args(arrays, _cv_t(CAM))
    cc, fc = rp.cull_args(sc, cam)
    assert cc is not None and not fc.compact
    culled = cp.fine_res_plain(sc, cam, bound, rp.params, *rp.prepass(sc, cam, bound, cc, plain=True), cull=fc)
    whole = cp.fine_res_plain(sc, cam, bound, rp.params, *rp.prepass(sc, cam, bound, None, plain=True))
    assert torch.equal(culled[2], whole[2])
    assert float((culled[0] - whole[0]).abs().max()) < 1e-3


@pytest.mark.parametrize(
    "kw,cfg_kw",
    [
        (dict(prepass_block=4, prepass_chain=True), {}),
        (dict(prepass_block=1, march_only=True), {}),
        (dict(soft=True, no_prepass=True), {}),
    ],
    ids=["chain", "march_only", "soft"],
)
def test_dynamic_options_not_ported_raise(kw, cfg_kw):
    """The chained pixel pass (K3's DYN build), K2's DYN march-only build
    and K2's DYN soft build on the dynamic tape of config 2, against the JAX
    renderer with the same options on the same dynamic spec (Pallas in
    interpret mode), whose kernels interpret dynamic specs too: images in
    tests/test_prepass.py's class; the march's (t, hit) in the prepass
    class of tests/test_torch_surfaces.py (hits agree but on < 1% of the
    rays, t within 1e-3 where both hit) and equal, ray for ray, to the
    plain fine pass's with residuals."""
    cfg = dataclasses.replace(CFG, **cfg_kw)
    spec, arrays = rt.compile_scene(SCENES["config2"](rt))
    spec_j, arrays_j = rm.compile_scene(SCENES["config2"](rm))
    assert spec.static_tape is None and spec_j.static_tape is None
    ref = render_aa_j(spec_j, cfg, W, H, interpret=True, bm_coarse=8, bm_fine=8, aa_packed=True,
                      **{"prepass_block": 1, **kw})(arrays_j, _cv_j(CAM))
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, H, device="cpu", **kw)
    got = rp(arrays, _cv_t(CAM))
    if not kw.get("march_only"):
        assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
        _assert_images_close(got.numpy(), np.asarray(ref))
        return
    _assert_march_close(got, ref)
    sc, cam, bound = rp.scene_args(arrays, _cv_t(CAM))
    _, t_r, h_r = cp.fine_res_plain(sc, cam, bound, rp.params, *rp.prepass(sc, cam, bound, None, plain=True))
    assert torch.equal(got[0], t_r.reshape(-1)) and torch.equal(got[1], h_r.reshape(-1))


def _assert_march_close(got, ref):
    t, h = (v.numpy() for v in got)
    t_j, h_j = (np.asarray(v) for v in ref)
    assert t.shape == t_j.shape == (W * H * CFG.aa_samples ** 2,)
    assert np.mean(h != h_j) < 0.01 and 0 < h.mean() < 1
    both = (h > 0.5) & (h_j > 0.5)
    assert np.abs(t[both] - t_j[both]).max() < 1e-3


def test_dynamic_march_fast_matches_jax():
    """`make_pallas_image_march_fast` (the reference's defaults: B = 4) on
    the dynamic tape of config 2 at relax 1.6, against the JAX one."""
    cfg = dataclasses.replace(CFG, relax=1.6)
    spec, arrays = rt.compile_scene(SCENES["config2"](rt))
    spec_j, arrays_j = rm.compile_scene(SCENES["config2"](rm))
    ref = march_fast_j(spec_j, cfg, W, H, interpret=True, bm_coarse=8, bm_fine=8)(arrays_j, _cv_j(CAM))
    rp = cp.make_pallas_image_march_fast(spec, _cfg_t(cfg), W, H, device="cpu")
    assert rp.params.block == 4 and rp.spec.static_tape is None
    _assert_march_close(rp(arrays, _cv_t(CAM)), ref)
