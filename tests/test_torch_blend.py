"""Training of scenes with smooth blends, subtractions and painted materials
through the port's compact backward (K9's seg1, stream and painted
branches), and the painted forward (K2 with materials), on the CPU.

- `sdf._apply_static_tape_color` against the JAX one on random points (a
  drift test), gated and un-gated.
- The painted forward, culled and un-culled, against the JAX
  `make_pallas_image_render_aa` (Pallas in interpret mode) and the NumPy
  oracle, in the accelerated-path class (bench.py:249-253).
- The compact backward's plain version (`compact_bwd_plain`, through
  `make_renderer(backend="pallas_fused")` with `leaf_cull=True`):
  - seg1 and one-group stream scenes (tests/test_pallas_grad.py:394-461)
    against the JAX compact VJP in the class of two f32 implementations
    (0.01·max|g| scene words, 0.02·max|g| camera) and against the port's
    un-culled backward; blend radii carry gradient;
  - a two-group stream scene, where the reference's history is shorter
    than the plan's span (ROADMAP §3.1), against `oracle_grad` and the
    port's un-culled backward (never the JAX compact VJP);
  - a painted pool (tests/test_pallas_grad.py:487-515) against the JAX
    compact VJP and `oracle_grad`, albedo words included;
  - random hard/smooth mixes (tests/test_pallas_grad.py:749-806) against
    the port's un-culled backward;
- `fit_scene` trains a culled cluster scene.
- `cuda_march.FoldWork`, the item record that chip_smoke.py's compact
  backward bound reads, on pool, hard, smooth and stream folds.
The CUDA kernels are held to these plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.
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
from raymarch_tpu.ops.pallas_grad import compact_bwd_history_len
from raymarch_tpu.ops.pallas_grad import make_fused_render_vjp as fused_vjp_j
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as render_aa_j
from raymarch_tpu.ops.sdf import _apply_static_tape_color as color_j
from raymarch_tpu.ops.sdf import _single_leaf_distance as leaf_j
from raymarch_tpu_torch.ops import cuda_grad as cg
from raymarch_tpu_torch.ops.culling import FAR
from raymarch_tpu_torch.ops.cuda_march import FoldWork, build_compact_plan, scene_buffers, scene_compact_plain
from raymarch_tpu_torch.ops.sdf import _apply_static_tape_color, _leaf_row_types, _single_leaf_distance
from raymarch_tpu_torch.ops.tape import from_reference

from test_grad_oracle import _word_map
from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)

CFG_J = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2)
W, H = 64, 32
POS = (0.3, 1.8, 5.0)  # tests/test_pallas_grad.py:310-312


def _cv(pos=POS):
    cam = rm.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0))
    return np.concatenate([cam.position, cam.rotation, [0.0]]).astype(np.float32)


def _seg1_mixed(m):
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


def _stream3(m):
    """tests/test_pallas_grad.py:440-464: three smooth clusters, one stream
    group."""
    rng = np.random.default_rng(13)
    clusters = []
    for _ in range(3):
        c = rng.uniform(-1.5, 1.5, 3) * [1, 0.5, 1]
        base = m.sphere(center=tuple(c), radius=float(rng.uniform(0.4, 0.6)))
        off = rng.uniform(-0.35, 0.35, 3)
        blob = m.sphere(center=tuple(c + off), radius=float(rng.uniform(0.2, 0.3)))
        dent = m.sphere(center=tuple(c - off), radius=float(rng.uniform(0.2, 0.3)))
        clusters.append(base.union(blob, k=0.2).subtract(dent, k=0.15))
    scene = clusters[0]
    for cl in clusters[1:]:
        scene = scene | cl
    return scene


def _stream9(m):
    """Nine smooth clusters and a bare sphere (the oracle scene of
    tests/test_pallas_grad.py:548-562, widened): the stream chunks into two
    groups of 8 and 1 segments."""
    rng = np.random.default_rng(29)
    clusters = []
    for _ in range(9):
        c = rng.uniform(-2.0, 2.0, 3) * [1, 0.5, 1]
        base = m.sphere(center=tuple(c), radius=0.5)
        off = rng.uniform(-0.3, 0.3, 3)
        blob = m.sphere(center=tuple(c + off), radius=0.26)
        dent = m.sphere(center=tuple(c - off), radius=0.215)
        clusters.append(base.union(blob, k=0.2).subtract(dent, k=0.15))
    scene = clusters[0]
    for cl in clusters[1:]:
        scene = scene | cl
    return scene | m.sphere(center=(0.0, 1.2, -0.5), radius=0.35)


def _painted_pool(m):
    """tests/test_pallas_grad.py:491-501."""
    return (
        m.sphere(center=(-0.8, 0.1, 0.0), radius=0.7, material=(0.9, 0.2, 0.1))
        | m.sphere(center=(0.7, 0.0, 0.2), radius=0.6, material=(0.1, 0.4, 0.8))
        | m.box(center=(0.0, -0.2, -0.8), half_extents=(0.5, 0.3, 0.4))
    )


def _fuzz_scene(m, seed):
    """tests/test_pallas_grad.py:760-777: a hard-union bulk with 2-4 random
    smooth unions and smooth subtractions."""
    rng = np.random.default_rng(seed)
    parts = [m.sphere(center=tuple(rng.uniform(-1.5, 1.5, 3) * [1, 0.5, 1]), radius=float(rng.uniform(0.25, 0.5)))
             for _ in range(5)]
    scene = parts[0]
    for p in parts[1:]:
        scene = scene | p
    for _ in range(int(rng.integers(2, 5))):
        c = tuple(rng.uniform(-1.2, 1.2, 3) * [1, 0.5, 1])
        p = m.sphere(center=c, radius=float(rng.uniform(0.2, 0.4)))
        if rng.integers(0, 2):
            scene = scene.union(p, k=float(rng.uniform(0.1, 0.25)))
        else:
            scene = scene.subtract(p, k=float(rng.uniform(0.1, 0.2)))
    return scene


def _kind(spec):
    plan = build_compact_plan(spec)
    return ("residual" if plan["residual_ops"] else "seg1" if plan["seg1"] is not None
            else "stream" if plan["stream"] else "pool")


def _port_grads(spec, arrays, cfg_j, cam_vec, w=W, h=H, weights=None):
    """Image, gradients of sum(img^2) (or of sum(img * weights)) and the
    backward_info of the port's fused renderer on the CPU."""
    render = rt.make_renderer(spec, w, h, rt.RenderConfig(**dataclasses.asdict(cfg_j)),
                              mode="implicit", backend="pallas_fused", device="cpu")
    lp = torch.tensor(arrays.leaf_params, requires_grad=True)
    opp = torch.tensor(arrays.op_param, requires_grad=True)
    cv = torch.tensor(cam_vec, requires_grad=True)
    img = render.renderer(dataclasses.replace(arrays, leaf_params=lp, op_param=opp), cv)
    loss = torch.sum(img**2) if weights is None else torch.sum(img * torch.tensor(weights, dtype=torch.float32))
    loss.backward()
    return img.detach().numpy(), (lp.grad.numpy(), opp.grad.numpy(), cv.grad.numpy()), render.backward_info


def _jax_grads(spec_j, arrays_j, cfg_j, cam_vec):
    rv = fused_vjp_j(spec_j, cfg_j, W, H, interpret=True, prepass_block=1)

    def loss(lp, opp, c):
        return jnp.sum(rv(dataclasses.replace(arrays_j, leaf_params=lp, op_param=opp), c) ** 2)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(arrays_j.leaf_params), jnp.asarray(arrays_j.op_param),
                                          jnp.asarray(cam_vec))
    return rv.backward_info, tuple(np.asarray(x) for x in g)


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
# Materials: the colour tape and the painted forward


@pytest.mark.parametrize("name", ["painted_transformed", "painted_blends"])
@pytest.mark.parametrize("gated", [False, True])
def test_static_tape_color_matches_jax(name, gated):
    """(distance, albedo) of the port's `_apply_static_tape_color` against
    the JAX one at random points. Gated: a random active set, per leaf in
    the port and per subtree in the JAX one; they agree wherever the
    distance stays below max_dist (the culling lemma: FAR loses every
    selection such a point can see)."""
    build = SCENES["painted_transformed"] if name == "painted_transformed" else _painted_blends
    spec_j, arrays_j = rm.compile_scene(build(rm), static=True)
    spec, arrays = from_reference(spec_j, arrays_j)
    rng = np.random.default_rng(3 + gated)
    pts = rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    default = tuple(float(v) for v in rm.DEFAULT_CONFIG.albedo)
    on = rng.uniform(size=spec.n_leaves) < 0.6
    lp_j = jnp.asarray(arrays_j.leaf_params)
    rows = _leaf_row_types(spec)

    def leaf_fn_j(row):
        t, rot = rows[row]
        fl = lp_j[row, 15]
        return leaf_j(jnp.asarray(pts), lp_j[row], t, rot), tuple(
            fl * lp_j[row, 12 + c] + (1.0 - fl) * default[c] for c in range(3))

    class _Reader:
        def any_active(self, rr):
            return jnp.asarray(bool(any(on[r] for r in rr)))

    d_j, rgb_j = color_j(spec_j, jnp.asarray(arrays_j.op_param), leaf_fn_j, 100.0, jnp.asarray(pts[:, 0]),
                         default, cull=_Reader() if gated else None)
    lp = torch.tensor(arrays.leaf_params)
    pts_t = torch.tensor(pts)

    def leaf_fn(row):
        t, rot = rows[row]
        fl = lp[row, 15]
        return _single_leaf_distance(pts_t, lp[row], t, rot), tuple(
            fl * lp[row, 12 + c] + (1.0 - fl) * default[c] for c in range(3))

    d, rgb = _apply_static_tape_color(spec, torch.tensor(arrays.op_param), leaf_fn, 100.0, pts_t[:, 0], default,
                                      cull=(lambda r: torch.tensor(bool(on[r]))) if gated else None)
    d_j = np.asarray(d_j)
    keep = d_j < 100.0
    assert keep.mean() > 0.5
    np.testing.assert_allclose(d.numpy()[keep], d_j[keep], rtol=1e-5, atol=1e-5)
    for c, c_j in zip(rgb, rgb_j):
        c = np.broadcast_to(c.numpy(), d_j.shape)
        c_j = np.broadcast_to(np.asarray(c_j), d_j.shape)
        np.testing.assert_allclose(c[keep], c_j[keep], rtol=1e-5, atol=1e-6)


def _painted_blends(m):
    """Painted leaves under every op, so that hard winners and smooth
    blends both mix colours."""
    a = m.sphere(center=(-0.5, 0.0, 0.0), radius=0.7, material=(0.8, 0.2, 0.1))
    b = m.box(center=(0.4, 0.1, 0.0), half_extents=(0.5, 0.4, 0.5), material=(0.1, 0.7, 0.3))
    c = m.torus(center=(0.0, 0.5, 0.0), major_radius=0.6, minor_radius=0.2, material=(0.2, 0.3, 0.9))
    d = m.cylinder(center=(0.0, -0.4, 0.2), radius=0.3, half_height=0.9)
    return (a.union(b, k=0.3).subtract(c, k=0.15).intersect(d.round(0.05), k=0.1)
            | (a & b) - c.onion(0.03) | (c | d).round(0.1))


@pytest.mark.parametrize("cull", [False, True])
def test_painted_forward_matches_jax_and_oracle(cull):
    """K2 with materials through its plain version: the painted 64-sphere
    scene's first 16 spheres (bench.py:805-820) and the painted test scene,
    culled and un-culled, against the JAX forward and the oracle."""
    cfg_j = dataclasses.replace(CFG_J, bound_accel=True, exit_check_every=4, relax=1.6, leaf_cull=cull)
    cfg = rt.RenderConfig(**dataclasses.asdict(cfg_j))
    for build, pos in ((lambda m: _painted_spheres(m, 16), (0.0, 2.5, 9.0)),
                       (SCENES["painted_transformed"], (0.0, 1.6, 4.2))):
        scene = build(rm)
        spec_j, arrays_j = rm.compile_scene(scene, static=True)
        spec, arrays = from_reference(spec_j, arrays_j)
        assert spec.has_materials
        cam = rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0))
        render = rt.make_renderer(spec, W, H, cfg, mode="forward", backend="pallas_prepass", device="cpu")
        img = render(arrays, cam).numpy()
        ref = np.asarray(render_aa_j(spec_j, cfg_j, W, H, interpret=True, prepass_block=1, aa_packed=True)(
            arrays_j, jnp.asarray(_cv(pos))))
        for other in (ref, rm.oracle.render(rm.encode_wire(scene), rm.Camera.looking_at(position=pos,
                                                                                       target=(0, 0, 0)),
                                            W, H, cfg_j)):
            d = np.abs(img - other)
            assert d.mean() < 5e-4 and _neigh_frac(img, other) < 0.008, (d.max(), d.mean())
        # The colours differ from the material-free render's on the painted
        # leaves: the albedo reached the shading.
        plain = dataclasses.replace(arrays, leaf_params=arrays.leaf_params.copy())
        plain.leaf_params[:, 15] = 0.0
        off = render(plain, cam).numpy()
        assert np.abs(img - off).max() > 0.05


def _painted_spheres(m, n=64):
    """bench.py:805-819: n painted random spheres (seed 17)."""
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


def _neigh_frac(img, ref):
    h, w, _ = img.shape
    best = np.full((h, w), np.inf, np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = slice(max(0, dy), h + min(0, dy))
            xs = slice(max(0, dx), w + min(0, dx))
            ys2 = slice(max(0, -dy), h + min(0, -dy))
            xs2 = slice(max(0, -dx), w + min(0, -dx))
            best[ys, xs] = np.minimum(best[ys, xs], np.abs(img[ys, xs] - ref[ys2, xs2]).max(-1))
    return float((best > 0.01).mean())


# --------------------------------------------------------------------------
# The compact backward of seg1, stream and painted plans


@pytest.fixture(scope="module", params=["seg1", "stream"])
def ordered_case(request):
    build = _seg1_mixed if request.param == "seg1" else _stream3
    spec_j, arrays_j = rm.compile_scene(build(rm), static=True)
    spec, arrays = from_reference(spec_j, arrays_j)
    assert _kind(spec) == request.param
    cfg_on = dataclasses.replace(CFG_J, leaf_cull=True)
    cv = _cv()
    port_c = _port_grads(spec, arrays, cfg_on, cv)
    port_l = _port_grads(spec, arrays, CFG_J, cv)
    info_j, g_j = _jax_grads(spec_j, arrays_j, cfg_on, cv)
    return info_j, g_j, port_c, port_l


def test_ordered_plans_take_k9_like_the_reference(ordered_case):
    info_j, _, (_, _, info), (_, _, info_l) = ordered_case
    assert (info["kind"], info["reason"]) == (info_j["kind"], info_j["reason"]) == ("pallas_compact", None)
    assert info_l["kind"] == "pallas_legacy_unrolled"


def test_ordered_grads_match_jax(ordered_case):
    _, g_j, (_, g, _), _ = ordered_case
    _assert_grad_class(g, g_j)
    # Blend radii carry gradient (tests/test_pallas_grad.py:433).
    assert np.abs(g[1]).max() > 0 and np.abs(g_j[1]).max() > 0


def test_ordered_grads_match_own_unculled(ordered_case):
    _, _, (_, g, _), (_, g_l, _) = ordered_case
    _assert_grad_class(g, g_l)
    assert np.abs(g_l[1]).max() > 0


def _oracle_words(scene, cfg, pos, img_d, spec_j):
    """The f64 oracle's gradients of sum(img * G) over the pixels where the
    device image agrees with the oracle's (tests/test_pallas_grad.py:
    534-647's recipe) -> (G, word map, oracle words, oracle camera)."""
    cam = rm.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0))
    tape = rm.encode_wire(scene)
    wmap = _word_map(tape, spec_j)
    S = cfg.aa_samples**2
    idx = jnp.arange(W * H * S, dtype=jnp.int32)
    o_dev, d_dev = rm.raygen_flat(idx, jnp.asarray(cam.position, jnp.float64),
                                  jnp.asarray(cam.rotation, jnp.float64), W, H, cfg)
    col, dcol, dcam = pixel_grads(tape, np.asarray(o_dev, np.float64), np.asarray(d_dev, np.float64), cfg,
                                  cam_rotation=np.asarray(cam.rotation))
    img_o = col.reshape(H, W, S, 3).mean(2)
    agree = np.abs(img_d - img_o).max(-1) < 1e-4
    assert agree.mean() > 0.9
    G = np.random.default_rng(31).uniform(0.5, 1.5, (H, W, 3)) * agree[:, :, None]
    Gray = np.repeat(G[:, :, None, :], S, axis=2).reshape(-1, 3) / S
    return G, wmap, np.einsum("nc,ncw->w", Gray, dcol), np.einsum("nc,ncw->w", Gray, dcam)


def _assert_oracle_class(gl, go, gc, wmap, oracle_words, oracle_cam):
    """tests/test_pallas_grad.py:636-647: rtol 3e-2, atol 1e-3·max|g|, the
    median relative error under 1e-2."""
    dev_words = np.zeros(len(oracle_words))
    for wd, m in wmap.items():
        dev_words[wd] = gl[m[1], m[2]] if m[0] == "leaf" else go[m[1]]
    scale = np.abs(oracle_words).max()
    np.testing.assert_allclose(dev_words, oracle_words, rtol=3e-2, atol=1e-3 * scale)
    rel = np.abs(dev_words - oracle_words) / (np.abs(oracle_words) + 1e-3 * scale)
    assert np.median(rel) < 1e-2, rel
    cscale = np.abs(oracle_cam).max()
    np.testing.assert_allclose(gc[:7], oracle_cam, rtol=3e-2, atol=1e-3 * cscale)


def test_two_stream_groups_match_oracle_and_unculled():
    """Reference fault 1 (ROADMAP §3.1): two stream groups, where the
    reference's history (the largest group) is shorter than the plan's
    span. The port sizes its history to the span; its compact backward
    meets the oracle class and its own un-culled backward's."""
    cfg = dataclasses.replace(CFG_J, max_iter=80, leaf_cull=True)
    scene = _stream9(rm)
    spec_j, arrays_j = rm.compile_scene(scene, static=True, rebalance=False)
    spec, arrays = from_reference(spec_j, arrays_j)
    plan = build_compact_plan(spec)
    assert plan["seg1"] is None and len(plan["stream"]) == 2
    hist_off, span = cg.history_layout(spec)
    assert compact_bwd_history_len(plan) < span == sum(len(plan["groups"][g]["rows"]) for g in plan["stream"])
    pos = (0.4, 2.0, 6.0)
    img_c, _, info = _port_grads(spec, arrays, cfg, _cv(pos))
    assert (info["kind"], info["reason"]) == ("pallas_compact", None)
    G, wmap, ow, oc_ = _oracle_words(scene, cfg, pos, img_c, spec_j)
    _, (gl, go, gc), _ = _port_grads(spec, arrays, cfg, _cv(pos), weights=G)
    assert np.abs(go).max() > 0
    _assert_oracle_class(gl, go, gc, wmap, ow, oc_)
    _, g_l, info_l = _port_grads(spec, arrays, dataclasses.replace(cfg, leaf_cull=False), _cv(pos), weights=G)
    assert info_l["kind"] == "pallas_legacy_unrolled"
    _assert_grad_class((gl, go, gc), g_l)


def test_painted_pool_matches_jax_and_oracle():
    """Winner-routed albedo and flag words (pallas_grad.py:978-997) against
    the JAX compact VJP and the oracle; the albedo columns carry gradient."""
    cfg = dataclasses.replace(CFG_J, max_iter=80, leaf_cull=True)
    scene = _painted_pool(rm)
    spec_j, arrays_j = rm.compile_scene(scene, static=True, rebalance=False)
    spec, arrays = from_reference(spec_j, arrays_j)
    assert spec.has_materials and _kind(spec) == "pool"
    img_c, g, info = _port_grads(spec, arrays, cfg, _cv())
    assert (info["kind"], info["reason"]) == ("pallas_compact", None)
    info_j, g_j = _jax_grads(spec_j, arrays_j, cfg, _cv())
    assert info_j["kind"] == "pallas_compact"
    _assert_grad_class(g, g_j)
    assert np.abs(g[0][:, 12:15]).max() > 1e-6 and np.abs(g_j[0][:, 12:15]).max() > 1e-6
    G, wmap, ow, oc_ = _oracle_words(scene, cfg, POS, img_c, spec_j)
    _, (gl, go, gc), _ = _port_grads(spec, arrays, cfg, _cv(), weights=G)
    _assert_oracle_class(gl, go, gc, wmap, ow, oc_)


@pytest.mark.parametrize("seed", [71, 72, 73])
def test_random_mixed_scene_fuzz(seed):
    """tests/test_pallas_grad.py:749-806 on the port: a random hard/smooth
    mix lands on the compact backward and meets the port's un-culled
    backward."""
    spec, arrays = rt.compile_scene(_fuzz_scene(rt, seed), static=True)
    assert _kind(spec) in ("seg1", "stream")
    g = {}
    for cull in (True, False):
        _, g[cull], info = _port_grads(spec, arrays, dataclasses.replace(CFG_J, leaf_cull=cull), _cv(), w=48)
        assert info["compact"] == cull
    _assert_grad_class(g[True], g[False])


def test_fit_scene_trains_a_culled_cluster_scene():
    """A cluster scene at small size: the fit lowers the loss through the
    culled forward and K9's plain version (stream plan)."""
    spec, arrays = rt.compile_scene(_clusters_t(), static=True)
    assert _kind(spec) == "stream"
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, aa_samples=2, bound_accel=True, exit_check_every=4,
                              relax=1.6, leaf_cull=True)
    camera = rt.Camera.looking_at(position=(0.0, 2.0, 7.0), target=(0.0, 0.0, 0.0))
    lp = arrays.leaf_params
    target = rt.make_renderer(spec, 48, 27, cfg, mode="forward", backend="pallas_prepass",
                              device="cpu")(arrays, camera)
    start = lp.copy()
    start[0, 4] -= 0.1
    mask = np.zeros_like(lp)
    mask[0, 4] = 1.0
    res = rt.fit_scene(spec, dataclasses.replace(arrays, leaf_params=start), camera, target,
                       width=48, height=27, cfg=cfg, steps=4, learning_rate=2e-2, leaf_mask=mask,
                       backend="pallas_fused", device="cpu", log_fn=lambda s: None)
    assert res.backward_info["kind"] == "pallas_compact" and res.backward_info["reason"] is None
    assert res.losses[-1] < res.losses[0]


def _hard_seg1(m):
    """Sphere and box, minus a torus (BASELINE config 2's topology): a seg1
    chain of hard steps."""
    return (m.sphere(center=(-0.5, 0.0, 0.0), radius=0.7)
            | m.box(center=(0.5, 0.0, 0.0), half_extents=(0.5, 0.4, 0.4))) - m.torus(
        center=(0.0, 0.0, 0.3), major_radius=0.6, minor_radius=0.2)


@pytest.mark.parametrize("name", ["pool", "hard_seg1", "seg1", "stream"])
def test_fold_work_records_what_the_reverse_reaches(name):
    """Recording leaves the distance unchanged and records every list item
    once; the distance's cotangent reaches no leaf where no item is active,
    exactly one (the winner) on hard folds, and more than one where a smooth
    step blends."""
    build = {"pool": _painted_pool, "hard_seg1": _hard_seg1, "seg1": _seg1_mixed, "stream": _stream3}[name]
    spec, arrays = rt.compile_scene(build(rt), static=True)
    assert _kind(spec) == name.split("_")[-1]
    sc = scene_buffers(spec, arrays, "cpu")
    plan = build_compact_plan(spec)
    rng = np.random.default_rng(5)
    px, py, pz = (torch.tensor(rng.uniform(-2.0, 2.0, 4096), dtype=torch.float32) for _ in range(3))
    act = {r: torch.tensor(rng.uniform(size=4096) < 0.7) for g in plan["groups"] for r in g["rows"]}
    d0 = scene_compact_plain(sc, plan, act.__getitem__, px, py, pz)
    work = FoldWork()
    d = scene_compact_plain(sc, plan, act.__getitem__, px, py, pz, work=work)
    assert torch.equal(d.detach(), d0)
    assert sorted(it[0] for it in work.items) == sorted(act)
    assert all(a is act[row] for row, _s, a, _d in work.items)
    n_reached = sum(r.long() for r in work.reached(d))
    live = d0 < FAR
    assert bool(live.any()) and bool((n_reached[~live] == 0).all()) and bool((n_reached[live] >= 1).all())
    if name in ("pool", "hard_seg1"):
        assert bool((n_reached[live] == 1).all())
    else:
        assert bool((n_reached > 1).any())


def _clusters_t(n_clusters=4, seed=13):
    """tests/test_compact.py:346-372 in the port's DSL."""
    rng = np.random.default_rng(seed)
    clusters = []
    for _ in range(n_clusters):
        c = rng.uniform(-2.5, 2.5, 3)
        c[1] = rng.uniform(-0.5, 1.0)
        base = rt.sphere(center=tuple(c), radius=float(rng.uniform(0.3, 0.5)))
        off = rng.uniform(-0.4, 0.4, 3)
        blob = rt.sphere(center=tuple(c + off), radius=float(rng.uniform(0.15, 0.3)))
        dent = rt.sphere(center=tuple(c - off), radius=float(rng.uniform(0.15, 0.3)))
        clusters.append(base.union(blob, k=float(rng.uniform(0.1, 0.25))).subtract(
            dent, k=float(rng.uniform(0.1, 0.2))))
    scene = clusters[0]
    for cl in clusters[1:]:
        scene = scene | cl
    return scene
