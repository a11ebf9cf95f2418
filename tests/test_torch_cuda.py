"""The CUDA kernels against their plain torch versions, on the card, and
the fit step on the card against the same step on the CPU.

Marked `cuda`; every test skips where no CUDA device is present. This file
imports no jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up jax for the JAX package's tests.)
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import raymarch_tpu_torch as rt
from raymarch_tpu_torch.ops import cuda_grad as cg
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


def _smooth(m):
    """tests/test_pallas_grad.py:195-202: smooth union minus a torus."""
    return (
        m.sphere(center=(-0.55, 0.0, 0.1), radius=0.85).union(
            m.box(center=(0.7, 0.05, -0.1), half_extents=(0.45, 0.5, 0.4)), k=0.35
        )
    ) - m.torus(center=(0.0, 0.75, 0.0), major_radius=0.65, minor_radius=0.22)


def _plane(m):
    """A smooth blend with the ground plane (an unbounded leaf: no bound)."""
    return m.sphere(center=(0, 0, 0), radius=0.7).union(
        m.plane(normal=(0, 1, 0), offset=0.5), k=0.3
    ) | m.capsule(center=(0.9, 0.2, 0), radius=0.3, half_height=0.3)


@pytest.mark.parametrize("name", sorted(SCENES) + ["smooth", "plane"])
def test_fused_kernels_match_plain(dev, name):
    scenes = {**SCENES, "smooth": _smooth, "plane": _plane}
    spec, arrays = rt.compile_scene(scenes[name](rt), static=True)
    fr = cg.make_fused_render_vjp(spec, CFG, W, H, device=dev)
    p = fr.params
    sc, cam, bound = fr.prepass.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    pre = cp.coarse(sc, cam, bound, p)
    launches = (cp.fine_res.launches, cg.bwd.launches)
    img, t, hit = cp.fine_res(sc, cam, bound, p, *pre)
    # The residual output leaves the image as it is, bit for bit.
    assert torch.equal(img, cp.fine(sc, cam, bound, p, *pre))
    _, t_p, hit_p = cp.fine_res_plain(sc, cam, bound, p, *pre)
    assert float((hit == hit_p).float().mean()) >= 0.999
    both = (hit == 1) & (hit_p == 1)
    # A ray whose slack lands within rounding of min_dist takes one step
    # more or less in one of the two (grazing rays on the plane do): t
    # agrees within rtol 1e-4 on all but 0.1% of the rays that hit.
    rel = (t[both] - t_p[both]).abs() / t_p[both].abs()
    assert float((rel > 1e-4).float().mean()) < 1e-3
    # The backward, on the same residuals and cotangent.
    g = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (H, W, 3)).astype(np.float32), device=dev)
    got = cg.bwd(sc, cam, p, fr.layout, t, hit, g)
    ref = cg.bwd_plain(sc, cam, p, fr.layout, t, hit, g)
    assert (cp.fine_res.launches, cg.bwd.launches) == (launches[0] + 1, launches[1] + 1)
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))
    assert float(got[2][7]) == 0.0


def test_fit_step_on_card_matches_cpu(dev):
    """One SGD step of the fit on the card and on the CPU: the updates are
    lr times the gradients, held in the backward's class."""
    spec, arrays = rt.compile_scene(_smooth(rt), static=True)
    lr = 1e-3
    target = np.zeros((H, W, 3), np.float32) + 0.2
    out = {}
    for d in (dev, "cpu"):
        step = rt.make_fit_step(
            spec, W, H, None, functools.partial(torch.optim.SGD, lr=lr), CFG,
            backend="pallas_fused", device=d,
        )
        a1, _, _, loss = step(arrays, CAM, step.init_opt_state(arrays), target)
        assert a1.leaf_params.device.type == torch.device(d).type
        out[d] = (float(loss), (a1.leaf_params.cpu() - torch.tensor(arrays.leaf_params)) / lr)
    (loss_k, g_k), (loss_p, g_p) = out[dev], out["cpu"]
    assert loss_k == pytest.approx(loss_p, rel=1e-3)
    torch.testing.assert_close(g_k, g_p, rtol=0.0, atol=0.01 * float(g_p.abs().max()))


def test_fused_renderer_backpropagates_on_card(dev):
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    render = rt.make_renderer(spec, W, H, CFG, mode="implicit", backend="pallas_fused", device="cuda")
    lp = torch.tensor(arrays.leaf_params, device=dev, requires_grad=True)
    pos = torch.tensor(CAM.position, device=dev, requires_grad=True)
    img = render(dataclasses.replace(arrays, leaf_params=lp), rt.Camera(pos, torch.tensor(CAM.rotation, device=dev)))
    torch.mean(img ** 2).backward()
    assert img.device == dev and lp.grad.device == dev
    assert float(lp.grad.abs().max()) > 0 and float(pos.grad.abs().max()) > 0


def _spheres(m, n=24):
    """bench.py:357-368's random spheres (seed 7), the first n."""
    rng = np.random.default_rng(7)
    parts = []
    for _ in range(n):
        c = rng.uniform(-3, 3, 3)
        c[1] = rng.uniform(-1.0, 1.5)
        parts.append(m.sphere(center=tuple(c), radius=float(rng.uniform(0.15, 0.5))))
    scene = parts[0]
    for p in parts[1:]:
        scene = scene | p
    return scene


def _rotated_mixed(m):
    """tests/test_pallas_grad.py:362-376: a rotated pool of mixed types."""
    return (
        m.sphere(center=(-1.0, 0.1, 0.0), radius=0.6)
        | m.box(center=(0.9, 0.0, -0.1), half_extents=(0.45, 0.35, 0.4),
                rotation=(0.9238795, 0.0, 0.3826834, 0.0))
        | m.torus(center=(0.0, 0.8, 0.1), major_radius=0.55, minor_radius=0.18,
                  rotation=(0.9689124, 0.2474040, 0.0, 0.0))
        | m.capsule(center=(1.6, 0.4, 0.6), radius=0.22, half_height=0.45)
    )


def _clusters(m, n_clusters=6, seed=13):
    """tests/test_compact.py:346-372: a hard union of smooth clusters (base
    sphere, smooth-union blob, smooth-subtract dent): a stream plan."""
    rng = np.random.default_rng(seed)
    clusters = []
    for _ in range(n_clusters):
        c = rng.uniform(-2.5, 2.5, 3)
        c[1] = rng.uniform(-0.5, 1.0)
        base = m.sphere(center=tuple(c), radius=float(rng.uniform(0.3, 0.5)))
        off = rng.uniform(-0.4, 0.4, 3)
        blob = m.sphere(center=tuple(c + off), radius=float(rng.uniform(0.15, 0.3)))
        dent = m.sphere(center=tuple(c - off), radius=float(rng.uniform(0.15, 0.3)))
        clusters.append(base.union(blob, k=float(rng.uniform(0.1, 0.25))).subtract(
            dent, k=float(rng.uniform(0.1, 0.2))))
    scene = clusters[0]
    for cl in clusters[1:]:
        scene = scene | cl
    return scene


# scene -> (scene function, camera position); plans: pool, pool, seg1, stream,
# residual (the gated tape).
CULL_SCENES = {
    "spheres": (_spheres, (0.0, 2.5, 9.0)),
    "rotated_mixed": (_rotated_mixed, (0.3, 1.8, 5.0)),
    "config2": (_config2, (0.0, 2.6, 4.2)),
    "clusters": (_clusters, (0.0, 2.0, 7.0)),
    "rich": (_rich, (0.0, 2.6, 4.2)),
}
CFG64 = dataclasses.replace(CFG, relax=1.6, leaf_cull=True)


def _cull_args(name, dev):
    build, pos = CULL_SCENES[name]
    spec, arrays = rt.compile_scene(build(rt), static=True)
    rp = cp.make_pallas_image_render_aa(spec, CFG64, W, H, device=dev)
    cam_vec = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device=dev)
    sc, cam, bound = rp.scene_args(arrays, cam_vec)
    return spec, arrays, rp, sc, cam, bound, rp.cull_args(sc, cam), cam_vec


@pytest.mark.parametrize("name", sorted(CULL_SCENES))
def test_culled_kernels_match_plain(dev, name):
    """The coarse and fine kernels with per-tile lists (pool, seg1 and
    stream plans) or masks (the gated tape of `rich`), and the relaxed
    march, against their plain versions on the same lists."""
    _, _, rp, sc, cam, bound, (cc, fc), _ = _cull_args(name, dev)
    assert fc.compact == (name != "rich")
    p = rp.params
    launches = (cp.coarse.launches, cp.fine_res.launches)
    t0k, stk = cp.coarse(sc, cam, bound, p, cc)
    t0p, stp = cp.coarse_plain(sc, cam, bound, p, cc)
    assert float((stk == stp).float().mean()) >= 0.999
    both = (stk == 1) & (stp == 1)
    assert int(both.sum()) > 0
    # A centre ray whose slack lands within rounding of min_dist takes one
    # step of ~min_dist more or less in one of the two (1 pixel of 1075 on
    # the rotated pool): t0 agrees within rtol 1e-4 on all but 0.5%.
    rel0 = (t0k[both] - t0p[both]).abs() / t0p[both].abs()
    assert float((rel0 > 1e-4).float().mean()) < 5e-3 and float(rel0.max()) < 1e-2
    img, t, hit = cp.fine_res(sc, cam, bound, p, t0k, stk, cull=fc)
    img_p, t_p, hit_p = cp.fine_res_plain(sc, cam, bound, p, t0k, stk, cull=fc)
    assert (cp.coarse.launches, cp.fine_res.launches) == (launches[0] + 1, launches[1] + 1)
    assert torch.equal(img, cp.fine(sc, cam, bound, p, t0k, stk, cull=fc))
    assert float((hit == hit_p).float().mean()) >= 0.999
    assert float((img - img_p).abs().mean()) < 5e-4
    assert _neigh_frac(img, img_p) < 0.008


@pytest.mark.parametrize("name", ["spheres", "rotated_mixed"])
def test_compact_bwd_kernel_matches_plain(dev, name):
    spec, _, rp, sc, cam, bound, (cc, fc), _ = _cull_args(name, dev)
    fr = cg.make_fused_render_vjp(spec, CFG64, W, H, device=dev)
    assert fr.backward_info["kind"] == "pallas_compact"
    pre = cp.coarse(sc, cam, bound, rp.params, cc)
    _, t, hit = cp.fine_res(sc, cam, bound, rp.params, *pre, cull=fc)
    g = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (H, W, 3)).astype(np.float32), device=dev)
    clamp = fr.layout.grad_denom_clamp
    before = cg.compact_bwd.launches
    got = cg.compact_bwd(sc, fc, cam, rp.params, clamp, t, hit, g)
    ref = cg.compact_bwd_plain(sc, fc, cam, rp.params, clamp, t, hit, g)
    assert cg.compact_bwd.launches == before + 1
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    assert float(got[1].abs().max()) == 0.0
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))
    assert float(got[2][7]) == 0.0


def test_culled_fused_renderer_on_card(dev):
    spec, arrays, *_, cam_vec = _cull_args("spheres", dev)
    render = rt.make_renderer(spec, W, H, CFG64, mode="implicit", backend="pallas_fused", device="cuda")
    assert render.backward_info["kind"] == "pallas_compact"
    lp = torch.tensor(arrays.leaf_params, device=dev, requires_grad=True)
    cv = cam_vec.clone().requires_grad_(True)
    before = cg.compact_bwd.launches
    img = render.renderer(dataclasses.replace(arrays, leaf_params=lp), cv)
    torch.mean(img**2).backward()
    assert cg.compact_bwd.launches == before + 1
    assert bool(torch.isfinite(lp.grad).all()) and float(lp.grad.abs().max()) > 0
    assert float(cv.grad[:7].abs().max()) > 0 and float(cv.grad[7]) == 0.0
