"""The CUDA kernels against their plain torch versions, on the card.

Marked `cuda`; every test skips where no CUDA device is present. This file
imports no jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up jax for the JAX package's tests.)
"""

import dataclasses

import pytest
import torch

import raymarch_tpu_torch as rt
from raymarch_tpu_torch.ops import cuda_prepass as cp

pytestmark = pytest.mark.cuda

Q = (0.9, 0.2, -0.3, 0.25)
W, H = 96, 64


def _config2(m):
    return (
        m.sphere(center=(-0.6, 0.0, 0.0), radius=0.9)
        | m.box(center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5))
    ) - m.torus(center=(0.0, 0.8, 0.0), major_radius=0.7, minor_radius=0.25)


def _rich(m):
    a = m.sphere(center=(-0.3, 0.0, 0.0), radius=0.8)
    b = m.box(center=(0.4, 0.1, 0.0), half_extents=(0.5, 0.5, 0.5), rotation=Q)
    c = m.torus(center=(0.0, 0.5, 0.0), major_radius=0.6, minor_radius=0.2, rotation=Q)
    d = m.cylinder(center=(0.0, -0.4, 0.2), radius=0.3, half_height=0.9, rotation=Q)
    e = m.capsule(center=(0.9, 0.3, -0.5), radius=0.25, half_height=0.4, rotation=Q)
    f = m.cone(center=(-0.9, 0.2, 0.4), half_height=0.5, r_bottom=0.4, r_top=0.1, rotation=Q)
    return (
        a.union(b, k=0.2).subtract(c, k=0.15).intersect(d.round(0.05), k=0.1)
        | (e & f.round(0.3)) - c.onion(0.03)
        | (e | f).round(0.02)
    )


SCENES = {"config2": _config2, "rich": _rich}
CAM = rt.Camera.looking_at(position=(0.0, 2.6, 4.2), target=(0.0, 0.0, 0.0))
CFG = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return cp.resolve_device("cuda")


def _args(spec, arrays, cfg, dev, row_offset=0.0, no_prepass=False):
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device=dev, no_prepass=no_prepass)
    return rp.scene_args(arrays, rt.cam_vec(CAM, row_offset, device=dev)) + (rp.params,)


def _neigh_frac(img, ref):
    h, w, _ = img.shape
    best = torch.full((h, w), float("inf"), device=img.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = slice(max(0, dy), h + min(0, dy))
            xs = slice(max(0, dx), w + min(0, dx))
            ys2 = slice(max(0, -dy), h + min(0, -dy))
            xs2 = slice(max(0, -dx), w + min(0, -dx))
            dd = (img[ys, xs] - ref[ys2, xs2]).abs().amax(-1)
            best[ys, xs] = torch.minimum(best[ys, xs], dd)
    return float((best > 0.01).float().mean())


@pytest.mark.parametrize("aa", [1, 2, 4])
@pytest.mark.parametrize("row_offset", [0.0, 10.0])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernels_match_plain(dev, name, row_offset, aa):
    spec, arrays = rt.compile_scene(SCENES[name](rt), static=True)
    cfg = dataclasses.replace(CFG, aa_samples=aa)
    sc, cam, bound, p = _args(spec, arrays, cfg, dev, row_offset)
    launches = (cp.coarse.launches, cp.fine.launches)
    t0k, stk = cp.coarse(sc, cam, bound, p)
    t0p, stp = cp.coarse_plain(sc, cam, bound, p)
    # Status flips only where the centre ray grazes the cone threshold.
    assert float((stk == stp).float().mean()) >= 0.999
    both = (stk == 1) & (stp == 1)
    assert int(both.sum()) > 0
    torch.testing.assert_close(t0k[both], t0p[both], rtol=1e-4, atol=0.0)
    img_k = cp.fine(sc, cam, bound, p, t0k, stk)
    img_p = cp.fine_plain(sc, cam, bound, p, t0k, stk)
    assert (cp.coarse.launches, cp.fine.launches) == (launches[0] + 1, launches[1] + 1)
    assert img_k.shape == (H, W, 3) and bool(torch.isfinite(img_k).all())
    # FMA contraction and the AA sum order may move a grazing sample across
    # the hit threshold: the accelerated-path class of bench.py:249-253.
    assert float((img_k - img_p).abs().mean()) < 5e-4
    assert _neigh_frac(img_k, img_p) < 0.008


@pytest.mark.parametrize("name", sorted(SCENES))
def test_no_prepass_kernel_is_tight(dev, name):
    spec, arrays = rt.compile_scene(SCENES[name](rt), static=True)
    sc, cam, bound, p = _args(spec, arrays, rt.DEFAULT_CONFIG, dev, no_prepass=True)
    d = (cp.fine(sc, cam, bound, p) - cp.fine_plain(sc, cam, bound, p)).abs()
    assert float(d.max()) < 1e-3


def test_renderer_on_cuda_matches_plain(dev):
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    render = rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass", device="cuda")
    img = render(arrays, CAM)
    assert img.device == dev
    ref = render.renderer.render_plain(arrays, rt.cam_vec(CAM, device=dev))
    assert float((img - ref).abs().mean()) < 5e-4


def test_aa_not_dividing_a_warp_raises(dev):
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    sc, cam, bound, p = _args(spec, arrays, dataclasses.replace(CFG, aa_samples=3), dev)
    with pytest.raises(NotImplementedError):
        cp.coarse(sc, cam, bound, p)


def test_cpu_tensors_on_cuda_renderer_raise(dev):
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    rp = cp.make_pallas_image_render_aa(spec, CFG, W, H, device=dev)
    with pytest.raises(ValueError):
        rp(arrays, rt.cam_vec(CAM, device="cpu"))
