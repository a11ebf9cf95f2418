"""The port's compact backward (K9, pool-only plans) and its dispatch.

`make_renderer(backend="pallas_fused")` with `leaf_cull=True` on a hard
union of leaves takes the compact backward: on the CPU its plain version
`compact_bwd_plain`, an autograd replay in which every scene evaluation is
the ray's fine-tile pool fold with an explicit winner. It is held against

- the JAX compact VJP (`make_fused_render_vjp`, Pallas in interpret mode)
  in the class of two f32 implementations of one backward
  (tests/test_pallas_grad.py:78-105: 0.01·max|g| for scene words,
  0.02·max|g| for the camera);
- the port's own legacy backward (leaf_cull off) at the reference's
  2e-3·max|g| (tests/test_pallas_grad.py:330-385, the same scenes);
- the f64 analytic oracle in the oracle class (277-293).

The dispatch mirrors the reference's `backward_info` (pallas_grad.py:
1279-1298, tests/test_pallas_grad.py:517-530); seg1, stream and painted
plans, which the reference sends to branches of the compact backward not
ported yet, raise. The CUDA kernel is held to `compact_bwd_plain` on the
card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import dataclasses

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
from raymarch_tpu_torch.ops.tape import from_reference

from test_compact import _cluster_scene
from test_grad_oracle import _word_map
from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)

CFG_J = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2)
W, H = 64, 32
POS = (0.3, 1.8, 5.0)  # tests/test_pallas_grad.py:310-312


def _six_spheres(m):
    """tests/test_pallas_grad.py:331-343: six random spheres (seed 5)."""
    rng = np.random.default_rng(5)
    parts = [
        m.sphere(center=tuple(rng.uniform(-2, 2, 3) * [1, 0.5, 1]), radius=float(rng.uniform(0.3, 0.6)))
        for _ in range(6)
    ]
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


POOL_SCENES = {"six_spheres": _six_spheres, "rotated_mixed": _rotated_mixed}


def _cv(pos=POS):
    cam = rm.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0))
    return np.concatenate([cam.position, cam.rotation, [0.0]]).astype(np.float32)


def _port_grads(spec, arrays, cfg, cam_vec, w=W, h=H, weights=None):
    """Image, gradients of sum(img^2) (or of sum(img * weights)) and the
    backward_info of the port's fused renderer on the CPU."""
    render = rt.make_renderer(spec, w, h, rt.RenderConfig(**dataclasses.asdict(cfg)),
                              mode="implicit", backend="pallas_fused", device="cpu")
    lp = torch.tensor(arrays.leaf_params, requires_grad=True)
    opp = torch.tensor(arrays.op_param, requires_grad=True)
    cv = torch.tensor(cam_vec, requires_grad=True)
    img = render.renderer(dataclasses.replace(arrays, leaf_params=lp, op_param=opp), cv)
    loss = torch.sum(img**2) if weights is None else torch.sum(img * torch.tensor(weights, dtype=torch.float32))
    loss.backward()
    return img.detach().numpy(), (lp.grad.numpy(), opp.grad.numpy(), cv.grad.numpy()), render.backward_info


@pytest.fixture(scope="module", params=sorted(POOL_SCENES))
def pool_case(request):
    spec_j, arrays_j = rm.compile_scene(POOL_SCENES[request.param](rm), static=True)
    spec, arrays = from_reference(spec_j, arrays_j)
    cfg_on = dataclasses.replace(CFG_J, leaf_cull=True)
    cv = _cv()
    port_c = _port_grads(spec, arrays, cfg_on, cv)
    port_l = _port_grads(spec, arrays, CFG_J, cv)
    rv = fused_vjp_j(spec_j, cfg_on, W, H, interpret=True, prepass_block=1)

    def loss(lp, opp, c):
        return jnp.sum(rv(dataclasses.replace(arrays_j, leaf_params=lp, op_param=opp), c) ** 2)

    g_j = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(arrays_j.leaf_params), jnp.asarray(arrays_j.op_param), jnp.asarray(cv)
    )
    return request.param, rv.backward_info, tuple(np.asarray(g) for g in g_j), port_c, port_l


def test_compact_takes_k9_like_the_reference(pool_case):
    _, info_j, _, (_, _, info), (_, _, info_l) = pool_case
    assert info["kind"] == info_j["kind"] == "pallas_compact"
    assert info["compact"] is True and info["reason"] is None and info_j["reason"] is None
    assert info_l["kind"] == "pallas_legacy_unrolled" and info_l["reason"] == "leaf_cull disabled"


@pytest.mark.parametrize("which", ["leaf_params", "op_param", "camera"])
def test_compact_grads_match_jax(pool_case, which):
    _, _, (gl_j, go_j, gc_j), (_, (gl, go, gc), _), _ = pool_case
    scale = np.abs(gl_j).max()
    assert scale > 0
    if which == "leaf_params":
        np.testing.assert_allclose(gl, gl_j, atol=0.01 * scale)
    elif which == "op_param":
        # Hard unions carry no blend radius: both are exactly zero.
        assert np.abs(go).max() == 0.0 and np.abs(go_j).max() == 0.0
    else:
        cscale = np.abs(gc_j[:7]).max()
        np.testing.assert_allclose(gc[:7], gc_j[:7], atol=0.02 * cscale)
        assert gc[7] == 0.0


def test_compact_grads_match_own_legacy(pool_case):
    """tests/test_pallas_grad.py:330-385 with the port on both sides."""
    _, _, _, (_, (gl_c, _, gc_c), _), (_, (gl_l, _, gc_l), _) = pool_case
    scale = np.abs(gl_l).max()
    np.testing.assert_allclose(gl_c, gl_l, rtol=2e-3, atol=2e-3 * scale)
    cs = np.abs(gc_l).max()
    np.testing.assert_allclose(gc_c[:7], gc_l[:7], rtol=2e-3, atol=2e-3 * cs)


# The rotated mixed pool is left out: one box word misses the oracle class
# by 3.3% in the JAX package's own compact and legacy VJPs as well (its
# taps straddle an edge), so it says nothing of the port.
@pytest.mark.parametrize("name", ["six_spheres"])
def test_compact_grads_match_oracle(name):
    """A pool through K9's plain version against the f64 analytic oracle:
    weighted-pixel-loss gradients of every tape word and of the camera,
    over the pixels where the JAX compact forward and the oracle agree
    (tests/test_pallas_grad.py:534-647's recipe)."""
    cfg = dataclasses.replace(CFG_J, max_iter=80, leaf_cull=True)
    scene = POOL_SCENES[name](rm)
    cam = rm.Camera.looking_at(position=POS, target=(0.0, 0.0, 0.0))
    tape = rm.encode_wire(scene)
    spec_j, arrays_j = rm.compile_scene(scene, static=True, rebalance=False)
    wmap = _word_map(tape, spec_j)
    S = cfg.aa_samples**2
    idx = jnp.arange(W * H * S, dtype=jnp.int32)
    o_dev, d_dev = rm.raygen_flat(
        idx, jnp.asarray(cam.position, jnp.float64), jnp.asarray(cam.rotation, jnp.float64), W, H, cfg
    )
    col, dcol, dcam = pixel_grads(
        tape, np.asarray(o_dev, np.float64), np.asarray(d_dev, np.float64), cfg,
        cam_rotation=np.asarray(cam.rotation),
    )
    img_o = col.reshape(H, W, S, 3).mean(2)
    rv = fused_vjp_j(spec_j, cfg, W, H, interpret=True, prepass_block=1)
    img_j = np.asarray(rv(arrays_j, jnp.asarray(_cv())))
    agree = np.abs(img_j - img_o).max(-1) < 1e-4
    G = np.random.default_rng(31).uniform(0.5, 1.5, (H, W, 3)) * agree[:, :, None]
    spec, arrays = from_reference(spec_j, arrays_j)
    img_d, (gl, go, gc), info = _port_grads(spec, arrays, cfg, _cv(), weights=G)
    assert info["kind"] == "pallas_compact"
    assert (np.abs(img_d - img_o).max(-1) < 1e-4).mean() > 0.9

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


def _gated_plane_scene(m):
    """A pool with a blended plane: plane leaves make the root operand a
    smooth union, one sensitive operand (seg1)."""
    return m.sphere(radius=0.7).union(m.plane(normal=(0, 1, 0), offset=0.5), k=0.2) | m.box(
        center=(1.2, 0.0, 0.0)
    )


def _intersect_pool(m):
    """Hard unions around one root intersection: a residual subtree."""
    return (m.sphere(center=(-1.0, 0, 0), radius=0.5) | m.sphere(center=(1.0, 0, 0), radius=0.5)
            | (m.box(half_extents=(0.4, 0.4, 0.4)) & m.sphere(radius=0.5)))


def _painted_smooth(m):
    """tests/test_pallas_grad.py:517-530: materials on smooth segments take
    the legacy backward in the reference, with a reason."""
    scene = m.sphere(center=(-0.5, 0, 0), radius=0.7, material=(0.8, 0.2, 0.1)).union(
        m.sphere(center=(0.5, 0, 0), radius=0.6), k=0.2
    )
    return scene | m.sphere(center=(0.0, 1.0, 0.0), radius=0.3)


def _painted_pool(m):
    return m.sphere(center=(-0.5, 0, 0), radius=0.5, material=(0.8, 0.2, 0.1)) | m.sphere(
        center=(0.5, 0, 0), radius=0.5
    )


@pytest.mark.parametrize(
    "name,build,expect",
    [
        ("pool", _six_spheres, ("pallas_compact", None)),
        ("residual", _intersect_pool, ("pallas_legacy_unrolled", "plan has residual (unrolled) subtrees")),
        ("residual_ops", lambda m: SCENES["ops"](m), ("pallas_legacy_unrolled", "plan has residual (unrolled) subtrees")),
        ("no_plan", lambda m: m.sphere(radius=0.5) & m.box(), ("pallas_legacy_unrolled",
                                                              "scene has no compact plan (not foldable)")),
        ("seg1", lambda m: SCENES["config2"](m), NotImplementedError),
        ("seg1_plane", _gated_plane_scene, NotImplementedError),
        ("stream", lambda m: _cluster_scene(), NotImplementedError),
        ("painted", _painted_pool, NotImplementedError),
        ("painted_seg1", _painted_smooth, "§1.8"),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_backward_dispatch_mirrors_the_reference(name, build, expect):
    """backward_info's kind and reason for leaf_cull=True, as the
    reference's eligibility chain gives them; the plans the reference sends
    to K9's ordered-fold or material branches raise here, naming ROADMAP
    §1.10, and never take the legacy backward."""
    cfg_j = dataclasses.replace(CFG_J, leaf_cull=True)
    spec_j, arrays_j = rm.compile_scene(build(rm), static=True)
    spec, _ = from_reference(spec_j, arrays_j)
    cfg = rt.RenderConfig(**dataclasses.asdict(cfg_j))
    info_j = fused_vjp_j(spec_j, cfg_j, 32, 24, interpret=True, bm=8).backward_info
    if expect == "§1.8":
        # The reference's legacy backward with albedo words; the port has
        # no materials yet, on either backward.
        assert info_j["kind"] == "pallas_legacy_unrolled" and "materials" in info_j["reason"]
        with pytest.raises(NotImplementedError, match="§1.8"):
            cg.make_fused_render_vjp(spec, cfg, 32, 24, device="cpu")
        return
    if expect is NotImplementedError:
        assert info_j["kind"] == "pallas_compact"  # the reference's K9 branch
        with pytest.raises(NotImplementedError, match="§1.10"):
            cg.make_fused_render_vjp(spec, cfg, 32, 24, device="cpu")
        with pytest.raises(NotImplementedError, match="§1.10"):
            rt.make_renderer(spec, 32, 24, cfg, mode="implicit", backend="pallas_fused", device="cpu")
        return
    fr = cg.make_fused_render_vjp(spec, cfg, 32, 24, device="cpu")
    assert (fr.backward_info["kind"], fr.backward_info["reason"]) == expect
    # aa_packed is left out: the port always packs a pixel's samples, where
    # the reference's VMEM budget may unpack the legacy kernel's layout.
    for key in ("kind", "compact", "reason", "soft"):
        assert fr.backward_info[key] == info_j[key], key
    # Culled forward either way; the legacy backward runs ungated after it.
    assert fr.prepass.cfg.leaf_cull
    if name == "residual":
        assert fr.prepass.plan is not None and not fr.prepass.compact


def test_compact_bwd_wrapper_on_cpu():
    """The wrapper on CPU tensors is the plain version (no launch); the
    gradient lands on the pushed rows only, op words stay zero, and bands
    add up to the whole frame."""
    spec, arrays = rt.compile_scene(_six_spheres(rt), static=True)
    cfg = rt.RenderConfig(**dataclasses.asdict(dataclasses.replace(CFG_J, leaf_cull=True)))
    fr = cg.make_fused_render_vjp(spec, cfg, W, H, device="cpu")
    rp = fr.prepass
    sc, cam, bound = rp.scene_args(arrays, torch.tensor(_cv()))
    cc, fc = rp.cull_args(sc, cam)
    pre = cp.coarse(sc, cam, bound, rp.params, cc)
    _, t, hit = cp.fine_res(sc, cam, bound, rp.params, *pre, cull=fc)
    g = torch.tensor(np.random.default_rng(3).uniform(-1, 1, (H, W, 3)).astype(np.float32))
    before = cg.compact_bwd.launches
    d_lp, d_opp, d_cam = cg.compact_bwd(sc, fc, cam, rp.params, fr.layout.grad_denom_clamp, t, hit, g)
    assert cg.compact_bwd.launches == before
    assert d_lp.shape == (spec.n_leaves, 16) and d_opp.shape == (spec.n_instr,) and d_cam.shape == (8,)
    assert float(d_opp.abs().max()) == 0.0 and d_cam[7] == 0.0
    unpushed = [r for r in range(spec.n_leaves) if r not in fr.layout.pushed_rows]
    assert unpushed and float(d_lp[unpushed].abs().max()) == 0.0 and float(d_lp.abs().max()) > 0.0
    whole = cg.compact_bwd_plain(sc, fc, cam, rp.params, fr.layout.grad_denom_clamp, t, hit, g, band_rows=H)
    for a, b in zip(whole, (d_lp, d_opp, d_cam)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * max(float(b.abs().max()), 1e-30))
    with pytest.raises(ValueError, match="item lists"):
        cg.compact_bwd(sc, None, cam, rp.params, fr.layout.grad_denom_clamp, t, hit, g)


def test_fit_scene_trains_a_culled_pool():
    """A 64-leaf-style fit at small size: the first sphere's centre moves
    toward the truth through the culled forward and K9's plain version."""
    rng = np.random.default_rng(7)
    parts = []
    for _ in range(12):
        c = rng.uniform(-3, 3, 3)
        c[1] = rng.uniform(-1.0, 1.5)
        parts.append(rt.sphere(center=tuple(c), radius=float(rng.uniform(0.15, 0.5))))
    scene = parts[0]
    for p in parts[1:]:
        scene = scene | p
    spec, arrays = rt.compile_scene(scene, static=True)
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, aa_samples=2, bound_accel=True, exit_check_every=4,
                              relax=1.6, leaf_cull=True)
    camera = rt.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0.0, 0.0, 0.0))
    lp = arrays.leaf_params
    row = int(np.argmax(lp[:, 7]))  # the largest sphere: on screen
    target = rt.make_renderer(spec, 48, 27, cfg, mode="forward", backend="pallas_prepass",
                              device="cpu")(arrays, camera)
    start = lp.copy()
    start[row, 4] -= 0.1
    mask = np.zeros_like(lp)
    mask[row, 4] = 1.0
    res = rt.fit_scene(spec, dataclasses.replace(arrays, leaf_params=start), camera, target,
                       width=48, height=27, cfg=cfg, steps=4, learning_rate=2e-2, leaf_mask=mask,
                       backend="pallas_fused", device="cpu", log_fn=lambda s: None)
    assert res.backward_info["kind"] == "pallas_compact"
    assert res.losses[-1] < res.losses[0]
    assert abs(float(res.arrays.leaf_params[row, 4]) - lp[row, 4]) < 0.1
