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
    """aa = 3 does not pack into a warp: the renderer takes the unpacked
    fine pass K4, which renders against its plain version; K2 itself raises
    on such params."""
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    cfg3 = dataclasses.replace(CFG, aa_samples=3)
    sc, cam, bound, p = _args(spec, arrays, cfg3, dev)
    assert p.unpacked
    pre = cp.coarse(sc, cam, bound, p)
    with pytest.raises(ValueError, match="unpacked"):
        cp.fine(sc, cam, bound, p, *pre)
    render = rt.make_renderer(spec, W, H, cfg3, mode="forward", backend="pallas_prepass", device=dev)
    img = render(arrays, CAM)
    ref = render.renderer.render_plain(arrays, rt.cam_vec(CAM, device=dev))
    assert float((img - ref).abs().mean()) < 5e-4 and _neigh_frac(img, ref) < 0.008


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


def _painted(m, n=24):
    """bench.py:805-819's painted random spheres (seed 17), the first n: a
    painted pool."""
    rng = np.random.default_rng(17)
    parts = []
    for _ in range(n):
        c = rng.uniform(-3, 3, 3)
        c[1] = rng.uniform(-1.0, 1.5)
        parts.append(m.sphere(center=tuple(c), radius=float(rng.uniform(0.15, 0.5)),
                              material=tuple(rng.uniform(0.1, 0.9, 3))))
    scene = parts[0]
    for p in parts[1:]:
        scene = scene | p
    return scene


def _painted_blends(m):
    """Painted leaves under hard and smooth ops (the gated tape carries the
    colours; no compact plan)."""
    a = m.sphere(center=(-0.5, 0.0, 0.0), radius=0.7, material=(0.8, 0.2, 0.1))
    b = m.box(center=(0.4, 0.1, 0.0), half_extents=(0.5, 0.4, 0.5), rotation=Q, material=(0.1, 0.7, 0.3))
    c = m.torus(center=(0.0, 0.5, 0.0), major_radius=0.6, minor_radius=0.2, material=(0.2, 0.3, 0.9))
    return a.union(b, k=0.3).subtract(c, k=0.15) | (a & b) - c.onion(0.03)


def _chain(m):
    """tests/test_pallas_grad.py:394-417: a hard-union bulk with a smooth
    union, a subtraction and a smooth subtraction: one seg1 chain."""
    rng = np.random.default_rng(11)
    parts = [m.sphere(center=tuple(rng.uniform(-1.5, 1.5, 3) * [1, 0.5, 1]), radius=float(rng.uniform(0.3, 0.6)))
             for _ in range(5)]
    scene = parts[0]
    for p in parts[1:]:
        scene = scene | p
    scene = scene.union(m.sphere(center=(0.4, 0.3, 0.5), radius=0.45), k=0.25)
    scene = scene - m.sphere(center=(-0.3, 0.4, 0.6), radius=0.35)
    return scene.subtract(m.sphere(center=(0.8, -0.2, 0.4), radius=0.3), k=0.18)


# scene -> (scene function, camera position); plans: pool, pool, seg1, stream,
# residual (the gated tape), seg1, stream in two groups, painted pool, and a
# painted gated tape.
CULL_SCENES = {
    "spheres": (_spheres, (0.0, 2.5, 9.0)),
    "rotated_mixed": (_rotated_mixed, (0.3, 1.8, 5.0)),
    "config2": (_config2, (0.0, 2.6, 4.2)),
    "clusters": (_clusters, (0.0, 2.0, 7.0)),
    "rich": (_rich, (0.0, 2.6, 4.2)),
    "chain": (_chain, (0.3, 1.8, 5.0)),
    "clusters9": (functools.partial(_clusters, n_clusters=9), (0.0, 2.5, 8.0)),
    "painted": (_painted, (0.0, 2.5, 9.0)),
    "painted_blends": (_painted_blends, (0.0, 1.6, 4.2)),
}
GATED = ("rich", "painted_blends")
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
    assert fc.compact == (name not in GATED)
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


@pytest.mark.parametrize("name", ["spheres", "rotated_mixed", "config2", "chain", "clusters", "clusters9",
                                  "painted"])
def test_compact_bwd_kernel_matches_plain(dev, name):
    """K9 for pool, seg1 and stream plans (one and two groups) and a
    painted pool; blend radii carry gradient on the ordered plans."""
    spec, _, rp, sc, cam, bound, (cc, fc), _ = _cull_args(name, dev)
    fr = cg.make_fused_render_vjp(spec, CFG64, W, H, device=dev)
    assert fr.backward_info["kind"] == "pallas_compact"
    kind = cg.plan_kind(spec)
    assert kind == {"config2": "seg1", "chain": "seg1", "clusters": "stream", "clusters9": "stream"}.get(name, "pool")
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
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=0.01 * scale)
    if name in ("chain", "clusters", "clusters9"):
        assert float(got[1].abs().max()) > 0.0
    elif kind == "pool":
        assert float(got[1].abs().max()) == 0.0
    if name == "painted":
        assert float(got[0][:, 12:16].abs().max()) > 0.0
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))
    assert float(got[2][7]) == 0.0


@pytest.mark.parametrize("name", ["spheres", "clusters9", "painted"])
def test_culled_fused_renderer_on_card(dev, name):
    spec, arrays, *_, cam_vec = _cull_args(name, dev)
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


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("name", ["painted", "painted_blends"])
def test_painted_fine_kernel_matches_plain(dev, name, cull):
    """K2 with materials, culled (lists or masks) and un-culled, against
    fine_plain on the same planes; the albedo reaches the image."""
    build, pos = CULL_SCENES[name]
    spec, arrays = rt.compile_scene(build(rt), static=True)
    assert spec.has_materials
    cfg = dataclasses.replace(CFG64, leaf_cull=cull)
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device=dev)
    cam_vec = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device=dev)
    sc, cam, bound = rp.scene_args(arrays, cam_vec)
    cc, fc = rp.cull_args(sc, cam) if cull else (None, None)
    pre = cp.coarse(sc, cam, bound, rp.params, cc)
    img = cp.fine(sc, cam, bound, rp.params, *pre, cull=fc)
    img_p = cp.fine_plain(sc, cam, bound, rp.params, *pre, cull=fc)
    assert float((img - img_p).abs().mean()) < 5e-4
    assert _neigh_frac(img, img_p) < 0.008
    plain = dataclasses.replace(arrays, leaf_params=arrays.leaf_params.copy())
    plain.leaf_params[:, 15] = 0.0
    sc0, _, _ = rp.scene_args(plain, cam_vec)
    assert float((cp.fine(sc0, cam, bound, rp.params, *pre, cull=fc) - img).abs().max()) > 0.05


def _interval_agreement(got, ref):
    """Interval planes of kernel vs plain: the finite/+inf pattern of each
    plane agrees on >= 99.9% of blocks, and where both are finite the
    values agree within rtol 1e-4 on all but 0.5% (a centre ray whose slack
    lands within rounding of min_dist moves one step)."""
    assert len(got) == len(ref)
    n_fin = 0
    for k, p in zip(got, ref):
        fk, fp = k < 9e37, p < 9e37
        assert float((fk == fp).float().mean()) >= 0.999
        both = fk & fp
        n_fin += int(both.sum())
        if bool(both.any()):
            rel = (k[both] - p[both]).abs() / p[both].abs().clamp_min(1e-30)
            assert float((rel > 1e-4).float().mean()) < 5e-3
    assert n_fin > 0


@pytest.mark.parametrize("ni", [1, 2, 3])
def test_interval_coarse_kernel_matches_plain(dev, ni):
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    rp = cp.make_pallas_image_render_aa(spec, CFG, W, H, device=dev, n_intervals=ni)
    sc, cam, bound = rp.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    before = cp.coarse.interval_launches
    got = cp.coarse(sc, cam, bound, rp.params)
    assert cp.coarse.interval_launches == before + 1 and len(got) == 2 * ni
    _interval_agreement(got, cp.coarse_plain(sc, cam, bound, rp.params))


@pytest.mark.parametrize("relax", [1.0, 1.6])
def test_interval_fine_kernel_matches_plain(dev, relax):
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    cfg = dataclasses.replace(CFG, relax=relax)
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device=dev, n_intervals=2)
    sc, cam, bound = rp.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    pre = cp.coarse(sc, cam, bound, rp.params)
    before = cp.fine.interval_launches
    img = cp.fine(sc, cam, bound, rp.params, *pre)
    assert cp.fine.interval_launches == before + 1
    img_p = cp.fine_plain(sc, cam, bound, rp.params, *pre)
    assert float((img - img_p).abs().mean()) < 5e-4
    assert _neigh_frac(img, img_p) < 0.008


@pytest.mark.parametrize("kw", [dict(prepass_block=4), dict(prepass_block=4, n_intervals=2),
                                dict(prepass_block=4, prepass_chain=True), dict(band_rows=24)],
                         ids=["block4", "block4_intervals", "chain", "band"])
def test_block_and_chained_frames_match_plain(dev, kw):
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    rp = cp.make_pallas_image_render_aa(spec, CFG, W, H, device=dev, **kw)
    cam_vec = rt.cam_vec(CAM, 20.0 if "band_rows" in kw else 0.0, device=dev)
    cp.reset_launch_counts()
    img = rp(arrays, cam_vec)
    chain = kw.get("prepass_chain", False)
    ni = kw.get("n_intervals", 0)
    assert (cp.coarse.launches, cp.coarse.interval_launches, cp.coarse_px.launches) == (
        int(not ni), int(bool(ni)), int(chain))
    assert (cp.fine.launches, cp.fine.interval_launches) == (int(not ni), int(bool(ni)))
    assert img.shape == (kw.get("band_rows", H), W, 3)
    ref = rp.render_plain(arrays, cam_vec)
    assert float((img - ref).abs().mean()) < 5e-4
    assert _neigh_frac(img, ref) < 0.008
    if chain:
        # K3 rounds as its plain version (-fmad=false): equal at every pixel.
        sc, cam, bound = rp.scene_args(arrays, cam_vec)
        blk = cp.coarse(sc, cam, bound, rp.params)
        got = cp.coarse_px(sc, cam, bound, rp.params, *blk)
        t0p, stp = cp.coarse_px_plain(sc, cam, bound, rp.params, *blk)
        assert torch.equal(got[1], stp) and torch.equal(got[0], t0p)
        assert int(stp.sum()) > 0


def deep4(m):
    """A union over a subtraction of a union: stack depth 4."""
    return m.sphere(center=(-0.5, 0.0, 0.0), radius=0.8) | (
        m.box(center=(0.6, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5), rotation=Q)
        - (m.torus(center=(0.6, 0.4, 0.0), major_radius=0.5, minor_radius=0.2)
           | m.cylinder(center=(0.6, 0.0, 0.3), radius=0.2, half_height=0.8)))


def deep8(m):
    """Five nested binary ops over every primitive but the plane, one of
    them smooth: stack depth 8."""
    return m.sphere(center=(-0.6, 0.0, 0.0), radius=0.8) | (
        m.box(center=(0.6, 0.0, 0.0), half_extents=(0.6, 0.5, 0.5), rotation=Q)
        - (m.torus(center=(0.6, 0.4, 0.0), major_radius=0.5, minor_radius=0.2)
           & (m.cylinder(center=(0.6, 0.0, 0.3), radius=0.3, half_height=0.8)
              | (m.capsule(center=(0.4, 0.3, -0.3), radius=0.25, half_height=0.4)
                 .subtract(m.cone(center=(0.5, 0.2, -0.2), half_height=0.5, r_bottom=0.4, r_top=0.1), k=0.1)))))


# The chained pixel kernel K3 on every stack route: config 2 (depth 2, a
# register) and the deep tapes (depth 4 and 8, shared memory), static and
# dynamic.
DEEP = {"config2": (_config2, 2), "deep4": (deep4, 4), "deep8": (deep8, 8)}


@pytest.mark.parametrize("static", [True, False], ids=["static", "dyn"])
@pytest.mark.parametrize("name", sorted(DEEP))
def test_chained_pixel_pass_matches_plain_exactly(dev, name, static):
    from raymarch_tpu_torch.ops import cuda_march as cm

    fn, depth = DEEP[name]
    spec, arrays = rt.compile_scene(fn(rt), static=static)
    assert spec.stack_depth == depth
    assert cm.stack_route(spec) == (cm.REG_STACK if depth <= cm.REG_STACK else cm.STK_SMEM)
    rp = cp.make_pallas_image_render_aa(spec, CFG, W, H, device=dev, prepass_block=4, prepass_chain=True)
    cam_vec = rt.cam_vec(CAM, device=dev)
    sc, cam, bound = rp.scene_args(arrays, cam_vec)
    blk = cp.coarse(sc, cam, bound, rp.params)
    cp.reset_launch_counts()
    got = cp.coarse_px(sc, cam, bound, rp.params, *blk)
    assert (cp.coarse_px.launches, cp.coarse_px.dyn_launches) == ((1, 0) if static else (0, 1))
    t0p, stp = cp.coarse_px_plain(sc, cam, bound, rp.params, *blk)
    assert torch.equal(got[1], stp) and torch.equal(got[0], t0p)
    assert int(stp.sum()) > 0 and int((stp == 0).sum()) > 0
    img = rp(arrays, cam_vec)
    ref = rp.render_plain(arrays, cam_vec)
    assert float((img - ref).abs().mean()) < 5e-4
    assert _neigh_frac(img, ref) < 0.008


def _long_tape(m, n=64):
    """bench.py's random spheres (seed 7), the first n, intersected at the
    root with a box: a plan with residual subtrees; n = 64 gives 129
    instructions and 1,176 gradient words, past both caps of K8's
    per-thread build."""
    return _spheres(m, n) & m.box(half_extents=(3.2, 1.2, 3.2))


def _painted_chain(m):
    """_chain with every sphere painted its own colour (seed 19): a painted
    seg1 chain, which takes the legacy backward under leaf_cull."""
    rng = np.random.default_rng(19)

    def paint(node):
        return node.paint(tuple(rng.uniform(0.1, 0.9, 3)))

    scene = functools.reduce(lambda a, b: a | b, [
        paint(m.sphere(center=(-1.0 + 0.5 * k, 0.1 * k, 0.2 * (k % 2)), radius=0.45)) for k in range(5)])
    scene = scene.union(paint(m.sphere(center=(0.4, 0.3, 0.5), radius=0.45)), k=0.25)
    scene = scene - m.sphere(center=(-0.3, 0.4, 0.6), radius=0.35)
    return scene.subtract(m.sphere(center=(0.8, -0.2, 0.4), radius=0.3), k=0.18)


# scene -> (scene function, config, camera position, K8's warp-row build):
# painted scenes (the albedo words) and long tapes through the legacy
# backward, after a culled forward where cfg64 culls.
LEGACY_SCENES = {
    "painted_blends": (_painted_blends, CFG, (0.0, 1.6, 4.2), False),
    "painted": (_painted, CFG, (0.0, 2.5, 9.0), True),
    "painted33": (functools.partial(_painted, n=33), CFG, (0.0, 2.5, 9.0), True),
    "painted_chain": (_painted_chain, CFG64, (0.3, 1.8, 5.0), True),
    "long_tape": (_long_tape, CFG64, (0.0, 2.5, 9.0), True),
}


@pytest.mark.parametrize("name", sorted(LEGACY_SCENES))
def test_legacy_kernel_matches_plain(dev, name):
    """K8 with albedo words and on long tapes against bwd_plain, from the
    fused forward's residuals, and through the fused renderer."""
    build, cfg, pos, long_build = LEGACY_SCENES[name]
    spec, arrays = rt.compile_scene(build(rt), static=True)
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, device=dev)
    assert fr.backward_info["kind"] == "pallas_legacy_unrolled"
    assert fr.layout.long == long_build
    if name == "long_tape":
        assert fr.layout.n_real > cg.MAX_BWD_INSTR and fr.layout.nscal * (cg.BWD_THREADS + 1) * 4 > cg.SMEM_PER_BLOCK
    cam_vec = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device=dev)
    rp = fr.prepass
    sc, cam, bound = rp.scene_args(arrays, cam_vec)
    cc, fc = rp.cull_args(sc, cam)
    pre = cp.coarse(sc, cam, bound, fr.params, cc)
    _, t, hit = cp.fine_res(sc, cam, bound, fr.params, *pre, cull=fc)
    g = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (H, W, 3)).astype(np.float32), device=dev)
    before = cg.bwd.launches
    got = cg.bwd(sc, cam, fr.params, fr.layout, t, hit, g)
    assert cg.bwd.launches == before + 1
    ref = cg.bwd_plain(sc, cam, fr.params, fr.layout, t, hit, g, band_rows=16)
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))
    if spec.has_materials:
        assert float(got[0][:, 12:16].abs().max()) > 0
    lp = torch.tensor(arrays.leaf_params, device=dev, requires_grad=True)
    img = fr(dataclasses.replace(arrays, leaf_params=lp), cam_vec)
    torch.mean(img**2).backward()
    assert cg.bwd.launches == before + 2
    assert bool(torch.isfinite(lp.grad).all()) and float(lp.grad.abs().max()) > 0


@pytest.mark.parametrize("name", ["painted_blends", "painted"])
def test_long_build_matches_per_thread_build(dev, name):
    """On a tape that fits the per-thread build, the per-thread and the
    warp-row builds sent the same residuals give the same gradients: both
    run one interpreter, only the accumulator differs."""
    build, cfg, pos, _ = LEGACY_SCENES[name]
    spec, arrays = rt.compile_scene(build(rt), static=True)
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, device=dev)
    fields = {f.name: getattr(fr.layout, f.name) for f in dataclasses.fields(fr.layout)}

    class LongLayout(cg.GradLayout):
        long = True

    class ThreadLayout(cg.GradLayout):
        long = False

    lay, lay_l = ThreadLayout(**fields), LongLayout(**fields)
    assert lay.n_real <= cg.MAX_BWD_INSTR and not lay.long and lay_l.long
    sc, cam, bound = fr.prepass.scene_args(arrays, rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)),
                                                              device=dev))
    pre = cp.coarse(sc, cam, bound, fr.params)
    _, t, hit = cp.fine_res(sc, cam, bound, fr.params, *pre)
    g = torch.tensor(np.random.default_rng(3).uniform(-1, 1, (H, W, 3)).astype(np.float32), device=dev)
    got = cg.bwd(sc, cam, fr.params, lay_l, t, hit, g)
    ref = cg.bwd(sc, cam, fr.params, lay, t, hit, g)
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=1e-3 * scale)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=1e-3 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=1e-3 * float(ref[2].abs().max()))


def test_block_vjp_matches_plain(dev):
    """The fused VJP at prepass_block = 4: the fine kernel with residuals
    reads the block planes, and K8 runs on its residuals."""
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    fr = cg.make_fused_render_vjp(spec, CFG, W, H, device=dev, prepass_block=4)
    p = fr.params
    assert p.block == 4 and p.plane_shape == (H // 4, W // 4)
    sc, cam, bound = fr.prepass.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    pre = cp.coarse(sc, cam, bound, p)
    img, t, hit = cp.fine_res(sc, cam, bound, p, *pre)
    img_p, t_p, hit_p = cp.fine_res_plain(sc, cam, bound, p, *pre)
    assert float((img - img_p).abs().mean()) < 5e-4
    assert float((hit == hit_p).float().mean()) >= 0.999
    g = torch.tensor(np.random.default_rng(5).uniform(-1, 1, (H, W, 3)).astype(np.float32), device=dev)
    got = cg.bwd(sc, cam, p, fr.layout, t, hit, g)
    ref = cg.bwd_plain(sc, cam, p, fr.layout, t, hit, g)
    scale = float(ref[0].abs().max())
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))
    cp.reset_launch_counts()
    lp = torch.tensor(arrays.leaf_params, device=dev, requires_grad=True)
    out = fr(dataclasses.replace(arrays, leaf_params=lp), rt.cam_vec(CAM, device=dev))
    torch.mean(out**2).backward()
    assert (cp.coarse.launches, cp.fine_res.launches) == (1, 1)
    assert float(lp.grad.abs().max()) > 0


def test_aa8_frame_matches_plain(dev):
    """aa_samples = 8: a pixel's 64 samples span two warps, reduced within
    each and joined through shared memory; residuals keep their lane order."""
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    cfg = dataclasses.replace(CFG, aa_samples=8)
    render = rt.make_renderer(spec, W, H, cfg, mode="forward", backend="pallas_prepass", device="cuda")
    img = render(arrays, CAM)
    ref = render.renderer.render_plain(arrays, rt.cam_vec(CAM, device=dev))
    assert float((img - ref).abs().mean()) < 5e-4
    assert _neigh_frac(img, ref) < 0.008
    sc, cam, bound, p = _args(spec, arrays, cfg, dev)
    pre = cp.coarse(sc, cam, bound, p)
    img_r, t, hit = cp.fine_res(sc, cam, bound, p, *pre)
    assert torch.equal(img_r, cp.fine(sc, cam, bound, p, *pre))
    _, t_p, hit_p = cp.fine_res_plain(sc, cam, bound, p, *pre)
    assert t.shape == (H, W, 64) and float((hit == hit_p).float().mean()) >= 0.999


# Soft coverage: scene -> (scene function, config, camera position, the
# backward it takes, the route GradLayout.long gives K8). Soft mode needs relax 1; CFG keeps
# bound_accel and exit_check_every 4. Every camera looks down more steeply
# than half the field of view (22.5 degrees), so no frame shows the horizon:
# there the checker floor's parity is ulp-sensitive (fx runs to 1e7), and a
# sample that flips it moves a pixel by 0.23 / S in hard and soft mode alike.
SOFT_CFG64 = dataclasses.replace(CFG, leaf_cull=True)
SOFT_SCENES = {
    "config2": (_config2, CFG, (0.0, 2.6, 4.2), "pallas_legacy_unrolled", False),
    "rich": (_rich, CFG, (0.0, 2.6, 4.2), "pallas_legacy_unrolled", True),
    "painted_blends": (_painted_blends, CFG, (0.0, 2.6, 4.2), "pallas_legacy_unrolled", False),
    "painted33": (functools.partial(_painted, n=33), SOFT_CFG64, (0.0, 5.5, 8.0), "pallas_legacy_unrolled", True),
    "long_tape": (_long_tape, SOFT_CFG64, (0.0, 5.5, 8.0), "pallas_legacy_unrolled", True),
    "spheres": (_spheres, SOFT_CFG64, (0.0, 5.5, 8.0), "pallas_compact", True),
    "chain": (_chain, SOFT_CFG64, (0.3, 3.2, 4.5), "pallas_compact", True),
    "clusters9": (functools.partial(_clusters, n_clusters=9), SOFT_CFG64, (0.0, 5.0, 7.0), "pallas_compact",
                  True),
}


def _soft_args(name, dev):
    build, cfg, pos, _, _ = SOFT_SCENES[name]
    spec, arrays = rt.compile_scene(build(rt), static=True)
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, soft=True, device=dev)
    cam_vec = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device=dev)
    sc, cam, bound = fr.prepass.scene_args(arrays, cam_vec)
    _, fc = fr.prepass.cull_args(sc, cam)
    return spec, arrays, fr, sc, cam, bound, fc, cam_vec


@pytest.mark.parametrize("name", ["config2", "rich", "painted_blends", "spheres", "chain", "clusters9"])
def test_soft_fine_kernel_matches_plain(dev, name):
    """K2's soft build (un-culled, lists, masks; with materials) against
    fine_res_plain: the image within 1e-3, hit on 99.9% of the rays, and on
    99.9% of the covered rays (alpha > 0) s_min within 1e-4 |s_min| + 1e-5
    (a hit ray's s_min is its last sample's distance, under min_dist, which
    an ulp of the position moves by ~5e-7) and t_min within rtol 1e-4."""
    _, _, fr, sc, cam, bound, fc, _ = _soft_args(name, dev)
    p = fr.params
    assert p.soft and p.no_prepass
    before = cp.fine_res.soft_launches
    img, t, hit, s_min, t_min = cp.fine_res(sc, cam, bound, p, cull=fc)
    assert cp.fine_res.soft_launches == before + 1
    assert torch.equal(img, cp.fine(sc, cam, bound, p, cull=fc))
    img_p, t_p, hit_p, s_p, tm_p = cp.fine_res_plain(sc, cam, bound, p, cull=fc)
    assert float((img - img_p).abs().max()) < 1e-3
    assert float((hit == hit_p).float().mean()) >= 0.999
    covered = cp.soft_alpha(p, s_p) > 0.0
    assert int(covered.sum()) > 0 and int((hit_p == 0).logical_and(covered).sum()) > 0
    for a, b, atol in ((s_min, s_p, 1e-5), (t_min, tm_p, 0.0)):
        off = (a - b).abs()[covered] > 1e-4 * b.abs()[covered] + atol
        assert float(off.float().mean()) < 1e-3


@pytest.mark.parametrize("name", sorted(SOFT_SCENES))
def test_soft_backward_kernels_match_plain(dev, name):
    """K8's soft builds (per-thread and warp rows, with and without the
    albedo words) and K9's (pool, seg1, stream in two groups) against their plain
    versions on the soft forward's residuals, then through the renderer."""
    _, _, _, kind, long_build = SOFT_SCENES[name]
    spec, arrays, fr, sc, cam, bound, fc, cam_vec = _soft_args(name, dev)
    assert fr.backward_info["kind"] == kind and fr.backward_info["soft"]
    if spec.has_materials:
        assert fr.backward_info["reason"] == "painted materials in soft mode"
    assert fr.layout.long == long_build
    p = fr.params
    _, t, hit, s_min, t_min = cp.fine_res(sc, cam, bound, p, cull=fc)
    g = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (H, W, 3)).astype(np.float32), device=dev)
    clamp = fr.layout.grad_denom_clamp
    counter = cg.compact_bwd if fr.compact_bwd else cg.bwd
    before = counter.soft_launches
    if fr.compact_bwd:
        got = cg.compact_bwd(sc, fc, cam, p, clamp, t, hit, g, soft=(s_min, t_min))
        ref = cg.compact_bwd_plain(sc, fc, cam, p, clamp, t, hit, g, band_rows=16, soft=(s_min, t_min))
    else:
        got = cg.bwd(sc, cam, p, fr.layout, t, hit, g, soft=(s_min, t_min))
        ref = cg.bwd_plain(sc, cam, p, fr.layout, t, hit, g, band_rows=16, soft=(s_min, t_min))
    assert counter.soft_launches == before + 1
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))
    assert float(got[2][7]) == 0.0
    lp = torch.tensor(arrays.leaf_params, device=dev, requires_grad=True)
    cv = cam_vec.clone().requires_grad_(True)
    img = fr(dataclasses.replace(arrays, leaf_params=lp), cv)
    torch.mean(img**2).backward()
    assert counter.soft_launches == before + 2
    assert bool(torch.isfinite(lp.grad).all()) and float(lp.grad.abs().max()) > 0
    assert float(cv.grad[:7].abs().max()) > 0


def test_soft_renderer_defaults_to_the_card(dev):
    """make_renderer without `device` runs on the card; mode "soft" gives a
    pure translation's silhouette gradient (tests/test_soft_coverage.py)."""
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, aa_samples=2, max_iter=60, ambient=1.0, coverage_beta=0.05)
    cam = rt.Camera.looking_at(position=(0.0, -0.5, 4.0), target=(0.0, 0.2, 0.0))
    spec, arrays_t = rt.compile_scene(rt.sphere(center=(0.0, 0.2, 0.0), radius=0.8), static=True)
    render = rt.make_renderer(spec, 48, 48, cfg, mode="soft", backend="pallas_fused")
    target = render(arrays_t, cam).detach()
    assert target.device == dev
    _, arrays0 = rt.compile_scene(rt.sphere(center=(0.15, 0.2, 0.0), radius=0.8), static=True)
    lp = torch.tensor(arrays0.leaf_params, device=dev, requires_grad=True)
    torch.mean((render(dataclasses.replace(arrays0, leaf_params=lp), cam) - target) ** 2).backward()
    assert float(lp.grad[0, 4]) > 1e-7


# --- K5, K6, K7 and K2's march-only build (csrc/march.cu, fine_march.cu) ----

FLAT_CASES = {
    "config2_static": (_config2, True, CFG),
    "config2_dynamic": (_config2, False, CFG),
    "empty_dynamic": (lambda m: None, False, CFG),
    "rich_dynamic_relax": (_rich, False, dataclasses.replace(CFG, relax=1.6)),
    "painted_dynamic": (lambda m: _config2(m).paint((0.9, 0.2, 0.1)) | m.sphere(center=(0, 1.2, 0), radius=0.3),
                        False, CFG),
    # Stack depth 8: the value stack in shared memory (cuda_march.stack_route);
    # the painted one with the colour walk's four stacks there.
    "spheres_static_depth8": (_spheres, True, CFG),
    "painted_static_depth8": (lambda m: _painted16(m), True, CFG),
}


def _flat(case, dev):
    build, static, cfg = FLAT_CASES[case]
    spec, arrays = rt.compile_scene(build(rt), static=static)
    from raymarch_tpu_torch.ops import cuda_march as cm

    fm = cm.FlatMarch(spec, cfg, W, H, dev)
    sc, cam, bound = fm.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    return cm, fm.params, sc, cam, bound


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_march_kernels_match_plain(dev, case):
    """K5 and K6 against their plain versions ray for ray (-fmad=false: hit
    and steps equal, t within 1e-5 on hits), K7's image in the exact class."""
    cm, p, sc, cam, bound = _flat(case, dev)
    before = (cm.image_march.launches, cm.ray_march.launches, cm.image_render.launches)
    t, hit, steps = cm.image_march(sc, cam, bound, p)
    t_p, hit_p, steps_p = cm.image_march_plain(sc, cam, bound, p)
    torch.testing.assert_close(hit, hit_p, rtol=0, atol=0)
    torch.testing.assert_close(steps, steps_p, rtol=0, atol=0)
    m = hit_p > 0.5
    torch.testing.assert_close(t[m], t_p[m], rtol=0, atol=1e-5)
    o, d = rt.raygen_flat(torch.arange(1000 + 37, device=dev), CAM.position, CAM.rotation, W, H, p_cfg(case))
    o, d = o.contiguous(), d.contiguous()
    got = cm.ray_march(sc, bound, p, o, d)
    ref = cm.ray_march_plain(sc, bound, p, o, d)
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    rgb = cm.image_render(sc, cam, bound, p)
    rgb_p = cm.image_render_plain(sc, cam, bound, p)
    img = torch.stack(rgb, -1).reshape(H, W, -1, 3).mean(2)
    img_p = torch.stack(rgb_p, -1).reshape(H, W, -1, 3).mean(2)
    assert float((img - img_p).abs().max()) < 1e-3
    assert (cm.image_march.launches, cm.ray_march.launches, cm.image_render.launches) == tuple(
        b + 1 for b in before)


def p_cfg(case):
    return FLAT_CASES[case][2]


@pytest.mark.parametrize("n", [1, 31, 33, 4096 + 5])
@pytest.mark.parametrize("case", ["config2_dynamic", "rich_dynamic_relax", "spheres_static_depth8"])
def test_ray_march_matches_plain(dev, case, n):
    """K5 against ray_march_plain: t, hit and steps equal ray for ray, at
    counts that leave a warp or a block part-filled, on the camera's rays
    and on seeded incoherent rays (origins in [-3, 3]^3, directions on the
    sphere)."""
    cm, p, sc, cam, bound = _flat(case, dev)
    rng = np.random.default_rng(n)
    o_i = torch.tensor(rng.uniform(-3.0, 3.0, (n, 3)), dtype=torch.float32, device=dev)
    d_i = rng.normal(size=(n, 3))
    d_i = torch.tensor(d_i / np.linalg.norm(d_i, axis=1, keepdims=True), dtype=torch.float32, device=dev)
    o_c, d_c = (v.contiguous() for v in rt.raygen_flat(torch.arange(n, device=dev), CAM.position, CAM.rotation,
                                                       W, H, p_cfg(case)))
    for o, d in ((o_c, d_c), (o_i, d_i)):
        before = cm.ray_march.launches
        got = cm.ray_march(sc, bound, p, o, d)
        assert cm.ray_march.launches == before + 1
        ref = cm.ray_march_plain(sc, bound, p, o, d)
        assert got[2].dtype == torch.int32 and got[0].shape == (n,)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("aa", [2, 3, 4])
@pytest.mark.parametrize("case", ["config2_static", "config2_dynamic", "spheres_static_depth8",
                                  "painted_static_depth8"])
def test_pixel_build_matches_plain(dev, case, aa):
    """K7's pixel build (the AA mean inside the kernel: xor shuffles where
    aa^2 divides 32, shared memory at aa 3) against its plain version,
    image_render_plain's samples stacked and averaged: the exact class; and
    against the per-sample build's mean, up to the sums' order."""
    build, static, cfg = FLAT_CASES[case]
    cfg = dataclasses.replace(cfg, aa_samples=aa)
    spec, arrays = rt.compile_scene(build(rt), static=static)
    from raymarch_tpu_torch.ops import cuda_march as cm

    fm = cm.FlatMarch(spec, cfg, W, H, dev)
    sc, cam, bound = fm.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    before = cm.image_pixels.launches
    img = cm.image_pixels(sc, cam, bound, fm.params)
    assert cm.image_pixels.launches == before + 1 and img.shape == (H, W, 3)
    ref = cm.image_pixels_plain(sc, cam, bound, fm.params)
    assert float((img - ref).abs().max()) < 1e-3
    per_ray = torch.stack(cm.image_render(sc, cam, bound, fm.params), -1).reshape(H, W, -1, 3).mean(2)
    assert float((img - per_ray).abs().max()) < 1e-5


@pytest.mark.parametrize("kw", [dict(prepass_block=1), dict(prepass_block=4),
                                dict(prepass_block=1, n_intervals=2)], ids=["b1", "b4", "intervals"])
@pytest.mark.parametrize("relax", [1.0, 1.6], ids=["plain", "relax"])
def test_march_only_build_matches_fine_res(dev, kw, relax):
    """K2's march-only build writes the (t, hit) of the fine kernel with
    residuals bit for bit (both built with FMA contraction)."""
    cfg = dataclasses.replace(CFG, relax=relax)
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    rp = cp.make_pallas_image_march_fast(spec, cfg, W, H, device=dev, **kw)
    cv = rt.cam_vec(CAM, device=dev)
    before = cp.fine_march.launches
    t, hit = rp(arrays, cv)
    assert cp.fine_march.launches == before + 1 and t.shape == (W * H * 16,)
    sc, cam, bound = rp.scene_args(arrays, cv)
    pre = rp.prepass(sc, cam, bound, None)
    _, t_r, h_r = cp.fine_res(sc, cam, bound, rp.params, *pre)
    torch.testing.assert_close(t, t_r.reshape(-1), rtol=0, atol=0)
    torch.testing.assert_close(hit, h_r.reshape(-1), rtol=0, atol=0)
    t_p, h_p = rp.render_plain(arrays, cv)
    assert float((hit != h_p).float().mean()) < 1e-3


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_image", "pallas_full"])
def test_render_surfaces_on_the_card_match_cpu(dev, backend):
    """Each backend's frame on the card against the same frame on the CPU
    (the dynamic tape of compile_scene's default)."""
    spec, arrays = rt.compile_scene(_config2(rt))
    cfg = dataclasses.replace(CFG, aa_samples=2)
    img = rt.make_renderer(spec, W, H, cfg, mode="forward", backend=backend)(arrays, CAM)
    ref = rt.make_renderer(spec, W, H, cfg, mode="forward", backend=backend, device="cpu")(arrays, CAM)
    assert img.device == dev
    assert float((img.cpu() - ref).abs().max()) < 1e-3


def test_pallas_backend_gradients_on_the_card(dev):
    """make_renderer(backend="pallas", mode="implicit") on the card (K5's
    forward, the implicit VJP, chunked as bench.py's fwdbwd_jnp) against the
    same renderer on the CPU (the plain K5): the gradient class."""
    spec, arrays = rt.compile_scene(_config2(rt))
    cfg = dataclasses.replace(CFG, aa_samples=2)
    grads = []
    for device in (dev, "cpu"):
        lp = torch.tensor(arrays.leaf_params, device=device, requires_grad=True)
        render = rt.make_renderer(spec, W, H, cfg, mode="implicit", backend="pallas", chunk=2048, device=device)
        torch.mean(render(dataclasses.replace(arrays, leaf_params=lp), CAM) ** 2).backward()
        grads.append(lp.grad.cpu())
    assert bool(torch.isfinite(grads[0]).all()) and float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0.01 * float(grads[1].abs().max()))


# --- the live path: DYN builds of K1/K2, K4, the tiered runtime ------------

LIVE_CASES = {
    "config2": (_config2, CFG, {}),
    "empty": (lambda m: None, CFG, {}),
    "rich_gated_relax": (_rich, dataclasses.replace(CFG, leaf_cull=True, relax=1.6), {}),
    "painted": (_painted, CFG, {}),
    "config2_block4": (_config2, CFG, dict(prepass_block=4)),
    "config2_intervals": (_config2, dataclasses.replace(CFG, relax=1.6), dict(n_intervals=2)),
}


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_dynamic_kernels_match_plain(dev, case):
    """The DYN builds of the coarse and fine kernels (csrc/prepass_dyn.cu)
    against their plain versions on a dynamic tape, in the class of
    test_kernels_match_plain; the frame against the static tape's."""
    build, cfg, kw = LIVE_CASES[case]
    spec, arrays = rt.compile_scene(build(rt))
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device=dev, **kw)
    sc, cam, bound = rp.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    cc, fc = rp.cull_args(sc, cam)
    before = (cp.coarse.dyn_launches, cp.fine.dyn_launches)
    pre_k = rp.prepass(sc, cam, bound, cc)
    pre_p = rp.prepass(sc, cam, bound, cc, plain=True)
    if not kw.get("n_intervals"):
        assert float((pre_k[1] == pre_p[1]).float().mean()) >= 0.999
    img_k = cp.fine(sc, cam, bound, rp.params, *pre_k, cull=fc)
    img_p = cp.fine_plain(sc, cam, bound, rp.params, *pre_k, cull=fc)
    assert (cp.coarse.dyn_launches, cp.fine.dyn_launches) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(img_k).all())
    assert float((img_k - img_p).abs().mean()) < 5e-4 and _neigh_frac(img_k, img_p) < 0.008
    spec_s, arrays_s = rt.compile_scene(build(rt), static=True)
    img_s = cp.make_pallas_image_render_aa(spec_s, cfg, W, H, device=dev, **kw)(arrays_s, rt.cam_vec(CAM, device=dev))
    assert float((rp(arrays, rt.cam_vec(CAM, device=dev)) - img_s).abs().mean()) < 5e-4


# K4's lane map (csrc/fine_unpacked.cuh): aa 2 and 4 keep a pixel in one
# warp (ballot and shuffles); aa 3, 5 and 6 straddle warps (their first
# hits and taps through shared memory); aa 3 on a culled frame puts 14
# pixels in a block, so a block crosses a 16-pixel list tile's edge
# (columns 14-27) and its lanes read two tiles; aa 12 walks two samples a
# lane.
UNPACKED_CASES = {
    "aa3": (_config2, True, dict(aa_samples=3)),
    "shared": (_config2, True, dict(aa_samples=2, aa_shared_normals=True)),
    "aa3_shared_dynamic": (_config2, False, dict(aa_samples=3, aa_shared_normals=True)),
    "shared_culled": (_rich, True, dict(aa_samples=4, aa_shared_normals=True, leaf_cull=True)),
    "aa3_dynamic_gated_relax": (_rich, False, dict(aa_samples=3, leaf_cull=True, relax=1.6)),
    "aa5_shared_static": (_config2, True, dict(aa_samples=5, aa_shared_normals=True)),
    "aa5_dynamic": (_config2, False, dict(aa_samples=5)),
    "aa6_shared_dynamic_relax": (_rich, False, dict(aa_samples=6, aa_shared_normals=True, relax=1.6)),
    "aa6_spheres_depth8": (_spheres, True, dict(aa_samples=6)),  # the stack in shared memory
    "aa3_lists_straddle": (_spheres, True, dict(aa_samples=3, leaf_cull=True)),
    "aa3_shared_gated_straddle": (_rich, True, dict(aa_samples=3, aa_shared_normals=True, leaf_cull=True)),
    "aa12_shared_static": (_config2, True, dict(aa_samples=12, aa_shared_normals=True)),
}


@pytest.mark.parametrize("case", sorted(UNPACKED_CASES))
def test_unpacked_kernel_matches_plain(dev, case):
    """K4 (csrc/fine_unpacked.cuh) against `fine_unpacked_plain`, with and
    without residuals: (t, hit) equal ray for ray (every K4 source builds
    with -fmad=false), the image in the accelerated class, one launch a
    call."""
    build, static, kw = UNPACKED_CASES[case]
    cfg = dataclasses.replace(CFG, **kw)
    spec, arrays = rt.compile_scene(build(rt), static=static)
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device=dev, aa_packed=False)
    assert rp.params.unpacked and rp.params.shared_normals == cfg.aa_shared_normals
    sc, cam, bound = rp.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    cc, fc = rp.cull_args(sc, cam)
    assert (fc is not None) == cfg.leaf_cull
    pre = rp.prepass(sc, cam, bound, cc)
    img_k = cp.fine_unpacked(sc, cam, bound, rp.params, *pre, cull=fc)
    before = cp.fine_unpacked_res.launches + cp.fine_unpacked_res.dyn_launches
    img_r, t_k, hit_k = cp.fine_unpacked_res(sc, cam, bound, rp.params, *pre, cull=fc)
    assert cp.fine_unpacked_res.launches + cp.fine_unpacked_res.dyn_launches == before + 1
    assert torch.equal(img_r, img_k)
    img_p, t_p, hit_p = cp.fine_unpacked_plain(sc, cam, bound, rp.params, *pre, cull=fc)
    assert torch.equal(hit_k, hit_p) and torch.equal(t_k, t_p)
    assert float((img_k - img_p).abs().mean()) < 5e-4 and _neigh_frac(img_k, img_p) < 0.008


def test_unpacked_residuals_feed_k8(dev):
    """The fused step at aa = 3: K4 with residuals, then K8, against
    `bwd_plain` on the same residuals, in the gradient class."""
    cfg = dataclasses.replace(CFG, aa_samples=3)
    spec, arrays = rt.compile_scene(_config2(rt), static=True)
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, device=dev)
    assert fr.backward_info["aa_packed"] is False
    sc, cam, bound = fr.prepass.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    pre = fr.prepass.prepass(sc, cam, bound, None)
    img, t, hit = cp.fine_unpacked_res(sc, cam, bound, fr.params, *pre)
    g = 2.0 * img / img.numel()
    got = cg.bwd(sc, cam, fr.params, fr.layout, t, hit, g)
    ref = cg.bwd_plain(sc, cam, fr.params, fr.layout, t, hit, g)
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))


def test_tiered_renderer_on_the_card(dev):
    """TieredRenderer's default backend on the card: a dynamic frame, the
    static tier built in the background, then a static frame; numpy out."""
    from raymarch_tpu_torch.runtime import TieredRenderer

    tiered = TieredRenderer(W, H, CFG)
    assert tiered.backend == "pallas_prepass" and tiered.device == dev
    scene = _config2(rt)
    img_d = tiered.render(scene, CAM)
    assert tiered.tier == "dynamic" and isinstance(img_d, np.ndarray) and img_d.shape == (H, W, 3)
    assert tiered.wait(timeout=300.0)
    img_s = tiered.render(scene, CAM)
    assert tiered.tier == "static"
    assert float(np.abs(img_d - img_s).mean()) < 5e-4


# --- the repaired builds: K3 / march-only / soft DYN, past MAX_NI ----------


def _tori(m, n=7):
    """n thin tori on the view axis of CAM_AXIS: up to 7 near intervals per
    4 x 4 block (tests/test_torch_interval.py's layered scene)."""
    return functools.reduce(lambda a, b: a | b, [
        m.torus(center=(0.0, 0.0, 4.0 - 1.5 * k), major_radius=0.3, minor_radius=0.1,
                rotation=(0.7071068, 0.7071068, 0.0, 0.0)) for k in range(n)])


CAM_AXIS = rt.Camera.looking_at(position=(0.0, 0.0, 8.0), target=(0.0, 0.0, 0.0))


def test_dynamic_chained_pass_matches_plain(dev):
    """K3's DYN build (csrc/prepass_dyn.cu coarse_px_kernel<3>) on config
    2's dynamic tape at B = 4, against coarse_px_plain as the static K3 is
    held, and the chained dynamic frame against its plain path."""
    spec, arrays = rt.compile_scene(_config2(rt))
    rp = cp.make_pallas_image_render_aa(spec, CFG, W, H, device=dev, prepass_block=4, prepass_chain=True)
    cam_vec = rt.cam_vec(CAM, device=dev)
    sc, cam, bound = rp.scene_args(arrays, cam_vec)
    blk = cp.coarse(sc, cam, bound, rp.params)
    before = cp.coarse_px.dyn_launches
    got = cp.coarse_px(sc, cam, bound, rp.params, *blk)
    assert cp.coarse_px.dyn_launches == before + 1
    t0p, stp = cp.coarse_px_plain(sc, cam, bound, rp.params, *blk)
    assert float((got[1] == stp).float().mean()) >= 0.999
    both = (got[1] == 1) & (stp == 1)
    rel = (got[0][both] - t0p[both]).abs() / t0p[both].abs()
    assert int(both.sum()) > 0 and float((rel > 1e-4).float().mean()) < 5e-3
    img = rp(arrays, cam_vec)
    ref = rp.render_plain(arrays, cam_vec)
    assert float((img - ref).abs().mean()) < 5e-4 and _neigh_frac(img, ref) < 0.008


@pytest.mark.parametrize("kw", [dict(), dict(n_intervals=2)], ids=["b4", "b4_intervals"])
def test_dynamic_march_only_build_matches_fine_res(dev, kw):
    """K2's DYN march-only build (csrc/fine_march.cu MODE 3) writes the
    (t, hit) of the DYN fine kernel with residuals bit for bit (both built
    with FMA contraction), and those of fine_res_plain in the residual
    class, through make_pallas_image_march_fast on a dynamic tape."""
    cfg = dataclasses.replace(CFG, relax=1.6)
    spec, arrays = rt.compile_scene(_config2(rt))
    rp = cp.make_pallas_image_march_fast(spec, cfg, W, H, device=dev, **kw)
    cv = rt.cam_vec(CAM, device=dev)
    before = cp.fine_march.dyn_launches
    t, hit = rp(arrays, cv)
    assert cp.fine_march.dyn_launches == before + 1 and t.shape == (W * H * 16,)
    sc, cam, bound = rp.scene_args(arrays, cv)
    pre = rp.prepass(sc, cam, bound, None)
    _, t_r, h_r = cp.fine_res(sc, cam, bound, rp.params, *pre)
    assert torch.equal(t, t_r.reshape(-1)) and torch.equal(hit, h_r.reshape(-1))
    _, t_p, h_p = cp.fine_res_plain(sc, cam, bound, rp.params, *pre)
    assert float((hit == h_p.reshape(-1)).float().mean()) >= 0.999
    both = (hit > 0.5) & (h_p.reshape(-1) > 0.5)
    torch.testing.assert_close(t[both], t_p.reshape(-1)[both], rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("cfg_kw", [{}, dict(leaf_cull=True)], ids=["uncull", "gated"])
def test_dynamic_soft_build_matches_plain(dev, cfg_kw):
    """K2's DYN soft build (csrc/fine_soft.cu MODE 3 and 4, -fmad=false) on
    config 2's dynamic tape against fine_res_plain, in the class of
    test_soft_fine_kernel_matches_plain."""
    cfg = dataclasses.replace(CFG, **cfg_kw)
    spec, arrays = rt.compile_scene(_config2(rt))
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device=dev, no_prepass=True, soft=True)
    cam_vec = rt.cam_vec(rt.Camera.looking_at(position=(0.0, 5.5, 8.0), target=(0.0, 0.0, 0.0)), device=dev)
    sc, cam, bound = rp.scene_args(arrays, cam_vec)
    _, fc = rp.cull_args(sc, cam)
    p = rp.params
    before = cp.fine_res.dyn_soft_launches
    img, t, hit, s_min, t_min = cp.fine_res(sc, cam, bound, p, cull=fc)
    assert cp.fine_res.dyn_soft_launches == before + 1
    img_p, t_p, hit_p, s_p, tm_p = cp.fine_res_plain(sc, cam, bound, p, cull=fc)
    assert float((img - img_p).abs().max()) < 1e-3
    assert float((hit == hit_p).float().mean()) >= 0.999
    covered = cp.soft_alpha(p, s_p) > 0.0
    assert int(covered.sum()) > 0
    for a, b, atol in ((s_min, s_p, 1e-5), (t_min, tm_p, 0.0)):
        off = (a - b).abs()[covered] > 1e-4 * b.abs()[covered] + atol
        assert float(off.float().mean()) < 1e-3


@pytest.mark.parametrize(
    "ni,static,relax,aa",
    [(6, True, 1.0, 4), (5, True, 1.6, 4), (6, False, 1.6, 4), (5, True, 1.0, 3)],
    ids=["ni6", "ni5_relax", "ni6_dynamic_relax", "ni5_unpacked"],
)
def test_wide_interval_builds_match_plain(dev, ni, static, relax, aa):
    """More than MAX_NI near intervals: the coarse scan writing the planes in
    place (KIND 3), the fine pass reading them in place (PRE 4: K2, its
    march-only build, K4 at aa = 3; static and DYN), against their plain
    versions on the layered scene at B = 4, in the classes of
    test_interval_coarse_kernel_matches_plain and test_kernels_match_plain,
    at 65 x 47, where two blocks' centre rays thread the tori closely
    enough to keep more than MAX_NI intervals."""
    w, h = 65, 47
    cfg = dataclasses.replace(CFG, relax=relax, aa_samples=aa)
    spec, arrays = rt.compile_scene(_tori(rt), static=static)
    rp = cp.make_pallas_image_render_aa(spec, cfg, w, h, device=dev, prepass_block=4, n_intervals=ni)
    sc, cam, bound = rp.scene_args(arrays, rt.cam_vec(CAM_AXIS, device=dev))
    p = rp.params
    cp.reset_launch_counts()
    pre = cp.coarse(sc, cam, bound, p)
    ref = cp.coarse_plain(sc, cam, bound, p)
    _interval_agreement(pre, ref)
    assert int(sum((v < 9e37).int() for v in pre[:ni]).max()) > cp.MAX_NI
    fine = cp.fine_unpacked if p.unpacked else cp.fine
    img = fine(sc, cam, bound, p, *pre)
    img_p = (cp.fine_unpacked_plain(sc, cam, bound, p, *pre)[0] if p.unpacked
             else cp.fine_plain(sc, cam, bound, p, *pre))
    assert float((img - img_p).abs().mean()) < 5e-4 and _neigh_frac(img, img_p) < 0.008
    wide = "dyn_launches" if not static else "wide_launches"
    assert (getattr(cp.coarse, wide), getattr(fine, wide)) == (1, 1)
    if not p.unpacked:
        mo = cp.make_pallas_image_march_fast(spec, cfg, w, h, device=dev, prepass_block=4, n_intervals=ni)
        t, hit = cp.fine_march(sc, cam, bound, mo.params, *pre)
        _, t_r, h_r = cp.fine_res(sc, cam, bound, p, *pre)
        assert torch.equal(t, t_r.reshape(-1)) and torch.equal(hit, h_r.reshape(-1))


# --- K8 and K9 on the H100 design: forced routes, the largest scenes -------


@pytest.fixture
def small_smem(monkeypatch):
    """Sends every backward row and record to device memory: ROW_SMEM and
    REC_SMEM at 0, the layout caches cleared before and after."""
    def clear():
        cg._device_consts.cache_clear()
        cg.compact_layout.cache_clear()
        cg.CompactRoutes.of.cache_clear()

    clear()
    monkeypatch.setattr(cg, "ROW_SMEM", 0)
    monkeypatch.setattr(cg, "REC_SMEM", 0)
    yield
    monkeypatch.undo()
    clear()


@pytest.mark.parametrize("name", ["painted33", "long_tape", "painted_chain"])
def test_legacy_device_routes_match_plain(dev, small_smem, name):
    """K8's warp-row build with its row added into the output and its
    records in device memory (forced on small scenes) against bwd_plain,
    in the gradient class (atomics in a varying order: the sums differ in
    their last bits from run to run)."""
    build, cfg, pos, _ = LEGACY_SCENES[name]
    spec, arrays = rt.compile_scene(build(rt), static=True)
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, device=dev)
    lay = fr.layout

    class WarpLayout(cg.GradLayout):
        long = True

    lay_w = WarpLayout(**{f.name: getattr(lay, f.name) for f in dataclasses.fields(lay)})
    mats = spec.has_materials
    assert not lay_w.row_in_smem and not lay_w.rec_in_smem(mats)
    cam_vec = rt.cam_vec(rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0)), device=dev)
    sc, cam, bound = fr.prepass.scene_args(arrays, cam_vec)
    cc, fc = fr.prepass.cull_args(sc, cam)
    _, t, hit = cp.fine_res(sc, cam, bound, fr.params, *cp.coarse(sc, cam, bound, fr.params, cc), cull=fc)
    g = torch.tensor(np.random.default_rng(11).uniform(-1, 1, (H, W, 3)).astype(np.float32), device=dev)
    got = cg.bwd(sc, cam, fr.params, lay_w, t, hit, g)
    ref = cg.bwd_plain(sc, cam, fr.params, lay, t, hit, g, band_rows=16)
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))


@pytest.mark.parametrize("name", ["spheres", "chain", "clusters"])
def test_compact_device_routes_match_plain(dev, small_smem, name):
    """K9 with its row added into the output and its fold history in device
    memory (forced) against compact_bwd_plain, in the gradient class."""
    spec, arrays, rp, sc, cam, bound, (cc, fc), _ = _cull_args(name, dev)
    ro = cg.CompactRoutes.of(spec)
    assert not ro.row_smem and (ro.hist_len == 0 or not ro.hist_smem)
    _, t, hit = cp.fine_res(sc, cam, bound, rp.params, *cp.coarse(sc, cam, bound, rp.params, cc), cull=fc)
    g = torch.tensor(np.random.default_rng(13).uniform(-1, 1, (H, W, 3)).astype(np.float32), device=dev)
    clamp = float(rp.cfg.grad_denom_clamp)
    got = cg.compact_bwd(sc, fc, cam, rp.params, clamp, t, hit, g)
    ref = cg.compact_bwd_plain(sc, fc, cam, rp.params, clamp, t, hit, g, band_rows=16)
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))


def _big_pool(m, n, seed=5, span=12.0):
    """n random spheres in a balanced tree of hard unions (bench.py's
    1024-leaf scene's construction)."""
    rng = np.random.default_rng(seed)
    parts = [m.sphere(center=(float(rng.uniform(-span, span)), float(rng.uniform(-1.0, 2.5)),
                              float(rng.uniform(-span, span))), radius=float(rng.uniform(0.15, 0.45)))
             for _ in range(n)]
    while len(parts) > 1:
        parts = [parts[i] | parts[i + 1] if i + 1 < len(parts) else parts[i] for i in range(0, len(parts), 2)]
    return parts[0]


@pytest.mark.parametrize("n,cull", [(4096, True), (3600, False)], ids=["k9_pool4096", "k8_3600"])
def test_scenes_past_the_shared_row_train(dev, n, cull):
    """Scenes whose gradient row exceeds a block's shared memory (73,735 and
    64,806 words): K9 on a 4,096-sphere pool and K8 on a 7,199-
    instruction tape at 64 x 36, against their plain versions in the
    gradient class, then a training step through make_renderer."""
    w, h = 64, 36
    cfg = dataclasses.replace(CFG, relax=1.6, leaf_cull=cull)
    spec, arrays = rt.compile_scene(_big_pool(rt, n), static=True)
    fr = cg.make_fused_render_vjp(spec, cfg, w, h, device=dev)
    assert fr.compact_bwd == cull and (16 * n + spec.n_instr + 7) * 4 > cg.SMEM_PER_BLOCK
    cam_vec = rt.cam_vec(rt.Camera.looking_at(position=(0.0, 6.0, 30.0), target=(0.0, 0.0, 0.0)), device=dev)
    sc, cam, bound = fr.prepass.scene_args(arrays, cam_vec)
    cc, fc = fr.prepass.cull_args(sc, cam)
    img, t, hit = cp.fine_res(sc, cam, bound, fr.params, *cp.coarse(sc, cam, bound, fr.params, cc), cull=fc)
    assert float(hit.mean()) > 0.01
    g = 2.0 * img / img.numel()
    clamp = fr.layout.grad_denom_clamp
    if cull:
        got = cg.compact_bwd(sc, fc, cam, fr.params, clamp, t, hit, g)
        ref = cg.compact_bwd_plain(sc, fc, cam, fr.params, clamp, t, hit, g, band_rows=16)
    else:
        assert fr.layout.long and not fr.layout.row_in_smem
        got = cg.bwd(sc, cam, fr.params, fr.layout, t, hit, g)
        ref = cg.bwd_plain(sc, cam, fr.params, fr.layout, t, hit, g, band_rows=8)
    scale = float(ref[0].abs().max())
    assert scale > 0
    torch.testing.assert_close(got[0], ref[0], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[1], ref[1], rtol=0.0, atol=0.01 * scale)
    torch.testing.assert_close(got[2], ref[2], rtol=0.0, atol=0.02 * float(ref[2].abs().max()))
    lp = torch.tensor(arrays.leaf_params, device=dev, requires_grad=True)
    torch.mean(fr(dataclasses.replace(arrays, leaf_params=lp), cam_vec) ** 2).backward()
    assert bool(torch.isfinite(lp.grad).all()) and float(lp.grad.abs().max()) > 0


def _painted16(m):
    rng = np.random.default_rng(17)
    parts = [m.sphere(center=tuple(rng.uniform(-2, 2, 3)), radius=float(rng.uniform(0.2, 0.5)),
                      material=tuple(rng.uniform(0.1, 0.9, 3))) for _ in range(16)]
    while len(parts) > 1:
        parts = [parts[i] | parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


# K1/K2's value-stack routes (csrc/scene_eval.cuh, cuda_march.stack_route):
# a stack depth of 2 keeps the slot below the top in a register, a deeper
# one the slots below the top in shared memory; compile_scene's stack_depth
# puts a scene on the route of that depth. Every K1/K2 build
# rounds as its plain version (no FMA contraction), so planes, t and hit
# equal theirs on every route, static and DYN alike.
ROUTE_SCENES = {"config2": _config2, "rich": _rich, "painted16": _painted16}


@pytest.mark.parametrize("culled", [False, True], ids=["uncull", "culled"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "dyn"])
@pytest.mark.parametrize("name,depth,route", [
    ("config2", None, 2), ("config2", 4, 0), ("config2", 16, 0), ("rich", None, 0), ("rich", 32, 0),
    ("painted16", None, 0), ("painted16", 32, 0)])
def test_stack_routes_match_plain_exactly(dev, name, depth, route, static, culled):
    from raymarch_tpu_torch.ops import cuda_march as cm

    kw = {} if depth is None else {"stack_depth": depth}
    spec, arrays = rt.compile_scene(ROUTE_SCENES[name](rt), static=static, **kw)
    assert cm.stack_route(spec) == route
    cfg = dataclasses.replace(CFG, leaf_cull=culled, relax=1.6 if name == "rich" else 1.0)
    rp = cp.make_pallas_image_render_aa(spec, cfg, W, H, device=dev)
    sc, cam, bound = rp.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    cc, fc = rp.cull_args(sc, cam)
    for k, p in zip(cp.coarse(sc, cam, bound, rp.params, cc), cp.coarse_plain(sc, cam, bound, rp.params, cc)):
        assert torch.equal(k, p)
    pre = cp.coarse_plain(sc, cam, bound, rp.params, cc)
    img_k, t_k, hit_k = cp.fine_res(sc, cam, bound, rp.params, *pre, cull=fc)
    img_p, t_p, hit_p = cp.fine_res_plain(sc, cam, bound, rp.params, *pre, cull=fc)
    assert torch.equal(t_k, t_p) and torch.equal(hit_k, hit_p) and float(hit_k.sum()) > 0
    assert float((img_k - img_p).abs().max()) < 1e-5  # the AA sums' order
    t_m, hit_m = cp.fine_march(sc, cam, bound, rp.params, *pre, cull=fc)
    assert torch.equal(t_m, t_k.reshape(-1)) and torch.equal(hit_m, hit_k.reshape(-1))


@pytest.mark.parametrize("name,depth", [("config2", None), ("config2", 16), ("painted16", None), ("painted16", 32)])
def test_soft_stack_routes_match_plain_exactly(dev, name, depth):
    kw = {} if depth is None else {"stack_depth": depth}
    spec, arrays = rt.compile_scene(ROUTE_SCENES[name](rt), static=True, **kw)
    fr = cg.make_fused_render_vjp(spec, CFG, W, H, soft=True, device=dev)
    sc, cam, bound = fr.prepass.scene_args(arrays, rt.cam_vec(CAM, device=dev))
    _, fc = fr.prepass.cull_args(sc, cam)
    img_k, *res_k = cp.fine_res(sc, cam, bound, fr.prepass.params, cull=fc)
    img_p, *res_p = cp.fine_res_plain(sc, cam, bound, fr.prepass.params, cull=fc)
    for k, p in zip(res_k, res_p):
        assert torch.equal(k, p)
    assert float((img_k - img_p).abs().max()) < 1e-5
