"""The port's near-interval prepass, B x B block cones, the chained pixel
pass and band rendering, against the JAX Pallas renderer.

The JAX renderer runs in interpret mode on the CPU, as tests/test_prepass.py
runs it; the port's wrappers run their plain versions on CPU tensors (the
CUDA kernels are held to those plain versions on the card by chip_smoke.py
and tests/test_torch_cuda.py).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as render_aa_j
from raymarch_tpu_torch.ops import cuda_prepass as cp
from raymarch_tpu_torch.ops.cuda_march import build_compact_plan

from test_compact import _cluster_scene
from test_torch_prepass import CAM, CFG, _assert_images_close, _cfg_t, _cv_j, _cv_t
from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)

W, H = 65, 47  # non-multiples of the block, the lane count and any tile


def _unflat(v, rows=H):
    """JAX prepass plane (padded flat pixel layout) -> f32[rows, W]."""
    return np.asarray(v).reshape(-1)[: rows * W].reshape(rows, W)


@pytest.fixture(scope="module")
def compiled():
    return (
        rm.compile_scene(SCENES["config2"](rm), static=True),
        rt.compile_scene(SCENES["config2"](rt), static=True),
    )


def _render_j(spec_j, cfg, w=W, h=H, **kw):
    return render_aa_j(spec_j, cfg, w, h, interpret=True, bm_coarse=8, aa_packed=True, **kw)


@pytest.mark.parametrize("ni", [1, 2, 3, 5, 6])
def test_interval_planes_match_jax(compiled, ni):
    (spec_j, arrays_j), (spec, arrays) = compiled
    ref = [_unflat(v) for v in _render_j(spec_j, CFG, prepass_block=1, n_intervals=ni).coarse(
        arrays_j, _cv_j(CAM))]
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu", n_intervals=ni)
    got = [v.numpy() for v in rp.coarse(arrays, _cv_t(CAM))]
    assert len(got) == len(ref) == 2 * ni
    n_fin = 0
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == (H, W) and a.dtype == np.float32
        fa, fb = a < 9e37, b < 9e37
        # The pattern may flip only where a centre ray grazes min_dist.
        assert (fa == fb).mean() >= 0.99, k
        both = fa & fb
        n_fin += int(both.sum())
        # Same f32 steps from the same start: rounding only.
        np.testing.assert_allclose(a[both], b[both], rtol=1e-4)
    assert n_fin > 0
    # "No interval" is the reference's finite 3.0e38, never inf.
    assert all(np.isfinite(v).all() for v in got)
    assert (got[0] < 9e37).any() and (got[0] >= 9e37).any()


@pytest.mark.parametrize("relax", [1.0, 1.6])
def test_interval_fine_matches_jax(compiled, relax):
    (spec_j, arrays_j), (spec, arrays) = compiled
    cfg = dataclasses.replace(CFG, relax=relax)
    rnd = _render_j(spec_j, cfg, prepass_block=1, n_intervals=2)
    pre_j = rnd.coarse(arrays_j, _cv_j(CAM))
    ref = np.asarray(rnd.fine(arrays_j, _cv_j(CAM), pre_j))
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, H, device="cpu", n_intervals=2)
    # The same interval planes feed both fine passes, so each is judged alone.
    img = rp.fine(arrays, _cv_t(CAM), [torch.tensor(_unflat(v)) for v in pre_j])
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    _assert_images_close(img.numpy(), ref)


@pytest.mark.parametrize(
    "block,ni,chain",
    [(4, 0, False), (4, 2, False), (4, 0, True)],
    ids=["block4", "block4_intervals", "block4_chain"],
)
def test_block_frames_match_jax(compiled, block, ni, chain):
    """tests/test_prepass.py:64-75 and 156-168: whole frames at B = 4, with
    and without intervals (relaxed with them), and chained."""
    (spec_j, arrays_j), (spec, arrays) = compiled
    cfg = dataclasses.replace(CFG, relax=1.6) if ni else CFG
    ref = np.asarray(_render_j(spec_j, cfg, prepass_block=block, n_intervals=ni, prepass_chain=chain)(
        arrays_j, _cv_j(CAM)))
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, H, device="cpu", prepass_block=block,
                                        n_intervals=ni, prepass_chain=chain)
    assert rp.params.plane_shape == ((H, W) if chain else (-(-H // block), -(-W // block)))
    pre = rp.coarse(arrays, _cv_t(CAM))
    assert all(tuple(v.shape) == rp.params.plane_shape for v in pre)
    _assert_images_close(rp(arrays, _cv_t(CAM)).numpy(), ref)
    if chain:
        # The chained pixel planes refine the block planes: no pixel starts
        # before its block, and none that its block killed lives.
        scene, cam, bound = rp.scene_args(arrays, _cv_t(CAM))
        t_b, s_b = cp.coarse_plain(scene, cam, bound, rp.params)
        t_px, s_px = pre
        up = [cp.expand_plane(v, block, H, W) for v in (t_b, s_b)]
        assert bool((s_px <= up[1]).all()) and bool((t_px[s_px > 0] >= up[0][s_px > 0]).all())


def test_interval_occluded_layers_match_jax():
    """tests/test_prepass.py:137-154: rays that graze the front sphere find
    the back ones through the interval jumps."""
    scene = lambda m: (  # noqa: E731
        m.sphere(center=(0, 0, 0), radius=0.8)
        | m.sphere(center=(0.9, 0, -2.5), radius=0.6)
        | m.sphere(center=(-1.4, 0.3, -5.0), radius=0.7)
    )
    spec_j, arrays_j = rm.compile_scene(scene(rm), static=True)
    spec, arrays = rt.compile_scene(scene(rt), static=True)
    w, h = 64, 48
    ref = np.asarray(_render_j(spec_j, CFG, w, h, prepass_block=1, n_intervals=2)(arrays_j, _cv_j(CAM)))
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), w, h, device="cpu", n_intervals=2)
    _assert_images_close(rp(arrays, _cv_t(CAM)).numpy(), ref)
    # More than one interval is recorded somewhere: the jumps are exercised.
    assert bool((rp.coarse(arrays, _cv_t(CAM))[1] < 9e37).any())


# scene -> (builder, camera position, plan kind, the culled-vs-unculled class
# of tests/test_torch_cull.py for that plan kind: (max, mean))
CULLED = {
    "seg1": (lambda m: SCENES["config2"](m), (0.0, 1.6, 4.2), "seg1", (1e-3, 1e-5)),
    "stream": (lambda m: _cluster_scene(n_clusters=5), (0.0, 2.0, 7.0), "stream", (5e-3, 1e-5)),
}


@pytest.mark.parametrize("name", sorted(CULLED))
def test_culled_interval_frame_matches_unculled(name):
    build, pos, kind, (max_cls, mean_cls) = CULLED[name]
    if name == "stream":
        from raymarch_tpu_torch.ops.tape import from_reference

        spec, arrays = from_reference(*rm.compile_scene(build(rm), static=True))
    else:
        spec, arrays = rt.compile_scene(build(rt), static=True)
    assert spec.n_leaves <= 16
    plan = build_compact_plan(spec)
    assert ("seg1" if plan["seg1"] is not None else "stream" if plan["stream"] else "pool") == kind
    cfg = _cfg_t(dataclasses.replace(CFG, relax=1.6, leaf_cull=True))
    cv = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device="cpu")
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device="cpu", n_intervals=2)
    assert rp.compact
    img = rp(arrays, cv).numpy()
    off = cp.make_pallas_image_render_aa(spec, dataclasses.replace(cfg, leaf_cull=False), W, H, device="cpu",
                                         n_intervals=2).render_plain(arrays, cv).numpy()
    d = np.abs(img - off)
    assert d.max() < max_cls and d.mean() < mean_cls, (d.max(), d.mean())


@pytest.mark.parametrize("cull", [False, True], ids=["unculled", "culled"])
def test_bands_stack_to_the_full_frame(compiled, cull):
    """Three bands of 16 rows (band_rows; the band's first row in
    cam_vec[7]) stacked: bit-equal to the full frame on the plain path
    un-culled, in the exact class culled; and each band against the JAX
    band."""
    (spec_j, arrays_j), (spec, arrays) = compiled
    h, band = 48, 16
    cfg = dataclasses.replace(CFG, relax=1.6, leaf_cull=cull)
    full = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, h, device="cpu", n_intervals=2)(
        arrays, _cv_t(CAM))
    rb = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, h, device="cpu", n_intervals=2, band_rows=band)
    bands = [rb(arrays, rt.cam_vec(rt.Camera(CAM.position, CAM.rotation), float(r0), device="cpu"))
             for r0 in range(0, h, band)]
    assert all(b.shape == (band, W, 3) for b in bands)
    stacked = torch.cat(bands, dim=0)
    if cull:
        assert float((stacked - full).abs().max()) < 1e-3
    else:
        assert torch.equal(stacked, full)
    rnd_j = _render_j(spec_j, cfg, W, h, prepass_block=1, n_intervals=2, band_rows=band)
    r0 = band  # the middle band
    ref = np.asarray(rnd_j(arrays_j, jnp.asarray(np.concatenate(
        [CAM.position, CAM.rotation, [float(r0)]]).astype(np.float32))))
    _assert_images_close(bands[1].numpy(), ref)


@pytest.mark.parametrize(
    "kw,exc",
    [
        (dict(prepass_chain=True, n_intervals=2), ValueError),
        (dict(no_prepass=True, n_intervals=1), ValueError),
        (dict(no_prepass=True, prepass_chain=True), ValueError),
        # More intervals than the register builds keep: it renders (None).
        (dict(n_intervals=6), None),
        (dict(band_rows=0), ValueError),
    ],
    ids=["chain_intervals", "no_prepass_intervals", "no_prepass_chain", "above_max_ni", "band_rows_0"],
)
def test_option_errors(compiled, kw, exc):
    (spec_j, _), (spec, _) = compiled
    if exc is None:
        _assert_layers_match_jax(kw["n_intervals"], CFG)
        return
    with pytest.raises(exc):
        cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu", **kw)
    if exc is ValueError and "band_rows" not in kw:
        # The reference raises the same error for the same options.
        with pytest.raises(ValueError):
            render_aa_j(spec_j, CFG, W, H, interpret=True, aa_packed=True, **kw)


CAM_AXIS = rm.Camera.looking_at(position=(0.0, 0.0, 8.0), target=(0.0, 0.0, 0.0))


def _layers(m, n=7):
    """n thin tori on the view axis of CAM_AXIS, their axes along it: a
    block's centre ray threads them all, and its cone comes near each one
    (up to 7 near intervals per block at B = 4)."""
    return functools.reduce(lambda a, b: a | b, [
        m.torus(center=(0.0, 0.0, 4.0 - 1.5 * k), major_radius=0.3, minor_radius=0.1,
                rotation=(0.7071068, 0.7071068, 0.0, 0.0)) for k in range(n)])


def _assert_layers_match_jax(ni, cfg):
    """The frame at B = 4 through ni > MAX_NI near intervals (the builds
    that read the interval planes in place on the card) against the JAX one
    on the layered scene, in tests/test_prepass.py's class; some block must
    keep more than MAX_NI intervals (test_interval_planes_match_jax holds
    the planes of ni = 5 and 6 against the JAX ones at B = 1)."""
    spec_j, arrays_j = rm.compile_scene(_layers(rm), static=True)
    spec, arrays = rt.compile_scene(_layers(rt), static=True)
    rnd = _render_j(spec_j, cfg, prepass_block=4, n_intervals=ni)
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(cfg), W, H, device="cpu", prepass_block=4, n_intervals=ni)
    planes = [v.numpy() for v in rp.coarse(arrays, _cv_t(CAM_AXIS))]
    assert len(planes) == 2 * ni and all(np.isfinite(v).all() for v in planes)
    n_open = sum((v < 9e37).astype(np.int32) for v in planes[:ni])
    assert n_open.max() > cp.MAX_NI
    img = rp(arrays, _cv_t(CAM_AXIS))
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    _assert_images_close(img.numpy(), np.asarray(rnd(arrays_j, _cv_j(CAM_AXIS))))


@pytest.mark.parametrize("relax", [1.0, 1.6])
def test_wide_interval_frames_match_jax(relax):
    """n_intervals = 5 on the layered scene, plain and relaxed."""
    _assert_layers_match_jax(5, dataclasses.replace(CFG, relax=relax))


def test_prepass_options_key_the_cache(compiled):
    _, (spec, _) = compiled
    a = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu", prepass_block=4)
    assert cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu", prepass_block=4) is a
    others = [
        cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu", **kw)
        for kw in (dict(), dict(prepass_block=4, prepass_chain=True), dict(prepass_block=4, n_intervals=2),
                   dict(prepass_block=4, band_rows=16), dict(prepass_block=2))
    ]
    assert len({id(r) for r in [a, *others]}) == 6
    # prepass_chain at B = 1 is a no-op (pallas_prepass.py:1408).
    assert cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu", prepass_chain=True) is others[0]
    # The CPU wrappers ran no kernel for any of them.
    scene, cam, bound = a.scene_args(compiled[1][1], _cv_t(CAM))
    before = (cp.coarse.launches, cp.coarse.interval_launches, cp.coarse_px.launches, cp.fine.interval_launches)
    pre = cp.coarse(scene, cam, bound, others[1].params)
    cp.coarse_px(scene, cam, bound, others[1].params, *pre)
    cp.fine(scene, cam, bound, others[2].params, *cp.coarse(scene, cam, bound, others[2].params))
    assert (cp.coarse.launches, cp.coarse.interval_launches, cp.coarse_px.launches,
            cp.fine.interval_launches) == before
