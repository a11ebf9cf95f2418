"""The port's per-tile leaf culling and compaction against the JAX package.

- The compact plan (`cuda_march.build_compact_plan`, copied from
  pallas_march.py:249-438) equals the JAX one, dict for dict.
- The masks and lists (`ops/culling.py`, torch) equal the JAX ones bit for
  bit at the same tile grid.
- The culled forward (`leaf_cull=True, relax=1.6`) on the CPU, through the
  plain versions, against the JAX culled forward (Pallas in interpret mode,
  in the accelerated-path class of bench.py:249-253) and against the port's
  own unculled forward (the reference's class, test_compact.py:133, or the
  looser one it states for smooth-blend scenes), for a pool plan, a seg1
  plan, a stream plan, a plan with residual subtrees (the gated tape) and
  the 64-sphere scene of bench.py:357-368 (its first 24 spheres, as
  test_compact.py:136 takes them).
- The repair of reference fault 2 (ROADMAP §3.2).
The kernels are held to these plain versions on the card by chip_smoke.py
and tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops import culling as cull_j
from raymarch_tpu.ops.pallas_march import build_compact_plan as plan_j
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as render_aa_j
from raymarch_tpu_torch.ops import cuda_prepass as cp
from raymarch_tpu_torch.ops import culling as cull_t
from raymarch_tpu_torch.ops.cuda_march import build_compact_plan, compactable_spec, plan_program
from raymarch_tpu_torch.ops.tape import from_reference

from test_compact import _cluster_scene, _mixed_ops_scene, _mixed_union_scene, _nine_segment_scene
from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)

CFG_J = dataclasses.replace(
    rm.DEFAULT_CONFIG, aa_samples=2, bound_accel=True, exit_check_every=4, relax=1.6, leaf_cull=True
)
CFG = rt.RenderConfig(**dataclasses.asdict(CFG_J))
W, H = 64, 36


def _spheres(m, n=64):
    """bench.py:357-368: n random spheres (seed 7) in one hard union."""
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


def _fuzz_scene(seed):
    """The random topologies of test_compact.py:696-744 (seeds 101-404)."""
    rng = np.random.default_rng(seed)

    def prim():
        c = tuple(rng.uniform(-2.0, 2.0, 3) * [1, 0.6, 1])
        kind = rng.integers(0, 4)
        if kind == 0:
            return rm.sphere(center=c, radius=float(rng.uniform(0.2, 0.5)))
        if kind == 1:
            return rm.box(center=c, half_extents=tuple(rng.uniform(0.15, 0.4, 3)))
        if kind == 2:
            return rm.torus(center=c, major_radius=float(rng.uniform(0.3, 0.5)),
                            minor_radius=float(rng.uniform(0.1, 0.2)))
        return rm.capsule(center=c, radius=float(rng.uniform(0.12, 0.25)),
                          half_height=float(rng.uniform(0.2, 0.4)))

    scene = prim()
    for _ in range(int(rng.integers(6, 12))):
        p = prim()
        op = rng.integers(0, 6)
        k = float(rng.uniform(0.08, 0.25))
        if op == 0:
            scene = scene | p
        elif op == 1:
            scene = scene.union(p, k=k)
        elif op == 2:
            scene = scene - p
        elif op == 3:
            scene = scene.subtract(p, k=k)
        elif op == 4:
            scene = scene & p
        else:
            scene = scene | p.round(float(rng.uniform(0.02, 0.08)))
    return scene


# Reference-built scenes (the JAX DSL; the port's compile_scene gives the
# same programs, tests/test_torch_tape.py).
PLAN_SCENES = {
    "mixed_union": _mixed_union_scene,
    "cluster": _cluster_scene,
    "mixed_ops": _mixed_ops_scene,
    "nine_segments": _nine_segment_scene,
    "spheres64": lambda: _spheres(rm),
    **{f"fuzz{s}": (lambda s=s: _fuzz_scene(s)) for s in (101, 202, 303, 404)},
    **{f"tape_{k}": (lambda k=k: SCENES[k](rm)) for k in sorted(SCENES) if k != "empty"},
}


def _both(build):
    spec_j, arrays_j = rm.compile_scene(build(), static=True)
    return (spec_j, arrays_j), from_reference(spec_j, arrays_j)


def _tensor_arrays(arrays):
    return dataclasses.replace(
        arrays, leaf_params=torch.tensor(arrays.leaf_params), op_param=torch.tensor(arrays.op_param)
    )


def _cv(pos, target=(0.0, 0.0, 0.0)):
    cam = rm.Camera.looking_at(position=pos, target=target)
    return np.concatenate([cam.position, cam.rotation, [0.0]]).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PLAN_SCENES))
def test_compact_plan_matches_jax(name):
    (spec_j, _), (spec, _) = _both(PLAN_SCENES[name])
    ref = plan_j(spec_j)
    got = build_compact_plan(spec)
    assert got == ref
    assert compactable_spec(spec) == (ref is not None)
    prog = plan_program(spec, torch.device("cpu"))
    if got is None:
        assert prog is None
    else:
        # The kernels' group table visits pool, then seg1, then stream groups.
        order = list(got["pool"]) + list(got["seg1"] or ()) + list(got["stream"])
        assert prog.tolist() == [
            [got["groups"][g]["offset"], got["groups"][g]["count_idx"],
             0 if g in got["pool"] else (1 if g in (got["seg1"] or ()) else 2),
             int(got["groups"][g]["ordered"])]
            for g in order
        ]


def test_plan_kinds_of_the_slice():
    """The plan kinds the dispatch relies on: the 64-sphere scene is one
    pool group of 64 items, config 2 a seg1 plan, the cluster scene a
    stream plan, the `ops` scene a plan with residual subtrees."""
    plan64 = build_compact_plan(_both(lambda: _spheres(rm))[1][0])
    assert plan64["pool"] == (0,) and len(plan64["groups"]) == 1 and plan64["n_items"] == 64
    assert plan64["seg1"] is None and plan64["stream"] == () and not plan64["residual_ops"]
    assert build_compact_plan(_both(lambda: SCENES["config2"](rm))[1][0])["seg1"] is not None
    assert build_compact_plan(_both(_cluster_scene)[1][0])["stream"]
    assert build_compact_plan(_both(lambda: SCENES["ops"](rm))[1][0])["residual_ops"]


BOUND_SCENES = ["mixed_union", "cluster", "mixed_ops", "spheres64", "fuzz101", "fuzz303",
                "tape_all_prims", "tape_rotated", "tape_ops"]


@pytest.mark.parametrize("name", BOUND_SCENES)
def test_bound_spheres_match_jax(name):
    (spec_j, arrays_j), (spec, arrays) = _both(PLAN_SCENES[name])
    cfg_j = dataclasses.replace(CFG_J, normal_eps=2e-4, min_dist=2e-3)
    cfg = rt.RenderConfig(**dataclasses.asdict(cfg_j))
    ref = np.asarray(cull_j.leaf_bound_spheres(spec_j, arrays_j, cfg_j))
    got = cull_t.leaf_bound_spheres(spec, _tensor_arrays(arrays), cfg).numpy()
    if name == "tape_all_prims":
        # Reference fault 2 (ROADMAP §3.2): the port's inflation is at least
        # the reference's; the plane's blend partners may gain k.
        assert (got[:, 3] >= ref[:, 3]).all()
        np.testing.assert_array_equal(got[:, [0, 1, 2, 4]], ref[:, [0, 1, 2, 4]])
        return
    # The sibling-centre einsum may sum in another order than XLA's dot:
    # one f32 rounding of an inflated radius, never more.
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0.0)


@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("name", ["cluster", "spheres64", "tape_rotated"])
def test_masks_and_lists_match_jax(name, tile):
    """tile_leaf_masks and compact_plan_rows bit for bit at the same tile
    grid, from the same bounds, with and without the coarse pass's extra
    cone angle, at two cameras and a band offset. f32 edge case: torch's and
    XLA's arccos/arcsin may differ by an ulp, which flips a bit only for a
    sphere tangent to a tile cone within 1e-7 rad; these scenes and cameras
    have none (the masks carry a 1e-4 rad margin on top)."""
    (spec_j, arrays_j), (spec, _) = _both(PLAN_SCENES[name])
    bounds = np.asarray(cull_j.leaf_bound_spheres(spec_j, arrays_j, CFG_J))
    w, h = 192, 108
    n_ty, n_tx = -(-h // tile), -(-w // tile)
    plan = build_compact_plan(spec)
    for pos, row0 in (((0.0, 2.5, 9.0), 0.0), ((0.4, 1.8, 5.0), 17.0)):
        cv = _cv(pos)
        cv[7] = row0
        for extra in (0.0, cp.cone_omega(CFG, w, h, 1)):
            ref = np.asarray(cull_j.tile_leaf_masks(
                jnp.asarray(bounds), jnp.asarray(cv), CFG_J, w, h, n_ty, n_tx,
                float(tile), float(tile), extra_angle=extra,
            ))
            got = cull_t.tile_leaf_masks(
                torch.tensor(bounds), torch.tensor(cv), CFG, w, h, n_ty, n_tx,
                float(tile), float(tile), extra_angle=extra,
            )
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref)
            if plan is not None:
                lj, cj = cull_j.compact_plan_rows(spec_j, plan_j(spec_j), jnp.asarray(ref))
                lt, ct = cull_t.compact_plan_rows(spec, plan, got)
                np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
                np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_pack_mask_bits_round_trip_and_bit31():
    rng = np.random.default_rng(0)
    spec, _ = rt.compile_scene(_spheres(rt, 70), static=True)
    L = spec.n_leaves  # 70 leaves in a bank of 128 rows
    active = rng.random((7, L)) < 0.4
    active[:, 31] = True  # bit 31 of word 0
    packed = cull_t.pack_mask_bits(torch.tensor(active))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(cull_j.pack_mask_bits(jnp.asarray(active))))
    assert packed.shape == (7, L // 32) and bool((packed[:, 0] < 0).all())
    back = cull_t._active_from_mask(spec, packed)
    np.testing.assert_array_equal(back.numpy(), active & cull_t._pushed_rows(spec)[None, :])


def _plane_blend(m):
    """ROADMAP §3.2's reproduction: a sphere at (6, 0.3, 0) smooth-united
    with the y=0 plane at k=0.3, beside a sphere at the origin."""
    return m.sphere(center=(0.0, 0.5, 0.0), radius=0.5) | m.sphere(
        center=(6.0, 0.3, 0.0), radius=0.5
    ).union(m.plane(normal=(0.0, 1.0, 0.0), offset=0.0), k=0.3)


def test_fault2_plane_sibling_keeps_its_blend_radius():
    """Reference fault 2 repaired: the sphere blended with the plane keeps
    k = 0.3 in its cull inflation (the reference's pairwise certificate
    enters the plane as a point at its centre, far from the sphere, and
    drops it), and the culled render equals the un-culled one."""
    (spec_j, arrays_j), (spec, arrays) = _both(lambda: _plane_blend(rm))
    ref = np.asarray(cull_j.leaf_bound_spheres(spec_j, arrays_j, CFG_J))
    got = cull_t.leaf_bound_spheres(spec, _tensor_arrays(arrays), CFG).numpy()
    lp = arrays.leaf_params
    row = int(np.nonzero((np.abs(lp[:, 4] - 6.0) < 1e-6) & (lp[:, 7] > 0))[0][0])
    base = 0.5 + CFG.min_dist + 8.0 * CFG.normal_eps + cull_t._RADIUS_MARGIN
    assert got[row, 3] == pytest.approx(base + 0.3, abs=1e-5)
    assert ref[row, 3] == pytest.approx(base, abs=1e-5)  # the reference's fault
    # Rendered near the blend, culled and un-culled agree in the
    # reference's own class.
    cam = rt.Camera.looking_at(position=(6.0, 1.2, 2.5), target=(6.0, 0.2, 0.0))
    on = rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")(arrays, cam)
    off = rt.make_renderer(spec, W, H, dataclasses.replace(CFG, leaf_cull=False), mode="forward",
                           backend="pallas_prepass", device="cpu")(arrays, cam)
    d = (on - off).abs()
    assert float(d.max()) < 1e-3 and float(d.mean()) < 1e-5, (float(d.max()), float(d.mean()))


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


# scene -> (scene function, camera, plan kind, the culled-vs-unculled class of the
# reference's test for that scene class: (max, mean))
IMAGE_SCENES = {
    "pool": (_mixed_union_scene, (0.3, 1.8, 5.0), "pool", (1e-3, 1e-5)),
    "seg1": (lambda: SCENES["config2"](rm), (0.0, 1.6, 4.2), "seg1", (1e-3, 1e-5)),
    # Smooth blends: the culled field differs from the true one above the
    # min_dist level by up to k/4, so a grazing sample may march another
    # sequence (test_compact.py:465-470 states 5e-3 for this class).
    "stream": (_cluster_scene, (0.0, 2.0, 7.0), "stream", (5e-3, 1e-5)),
    "residual": (lambda: SCENES["ops"](rm), (0.0, 1.6, 4.2), "residual", (5e-3, 1e-5)),
    "spheres64": (lambda: _spheres(rm, 24), (0.0, 2.5, 9.0), "pool", (1e-3, 1e-5)),
}


@pytest.mark.parametrize("name", sorted(IMAGE_SCENES))
def test_culled_forward_matches_jax_and_unculled(name):
    build, pos, kind, (max_cls, mean_cls) = IMAGE_SCENES[name]
    (spec_j, arrays_j), (spec, arrays) = _both(build)
    plan = build_compact_plan(spec)
    got_kind = ("residual" if plan["residual_ops"] else "seg1" if plan["seg1"] is not None
                else "stream" if plan["stream"] else "pool")
    assert got_kind == kind
    cam = rt.Camera.looking_at(position=pos, target=(0.0, 0.0, 0.0))
    render = rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")
    assert render.renderer.compact == (kind != "residual")
    img = render(arrays, cam).numpy()
    off = rt.make_renderer(spec, W, H, dataclasses.replace(CFG, leaf_cull=False), mode="forward",
                           backend="pallas_prepass", device="cpu")(arrays, cam).numpy()
    d = np.abs(img - off)
    assert d.max() < max_cls and d.mean() < mean_cls, (d.max(), d.mean())
    # Against the JAX culled forward (its own list tiles): the class of the
    # accelerated paths.
    ref = np.asarray(render_aa_j(spec_j, CFG_J, W, H, interpret=True, prepass_block=1, aa_packed=True)(
        arrays_j, jnp.asarray(_cv(pos))
    ))
    dj = np.abs(img - ref)
    assert dj.mean() < 5e-4 and _neigh_frac(img, ref) < 0.008, (dj.max(), dj.mean())


def test_culled_frame_is_the_kernels_inputs():
    """The renderer builds each frame's masks and lists once, on its
    device; the coarse grid's cones widen by omega, so its masks hold at
    least the fine grid's leaves of the same region."""
    (_, _), (spec, arrays) = _both(lambda: _spheres(rm, 24))
    rp = cp.make_pallas_image_render_aa(spec, CFG, W, H, device="cpu")
    sc, cam, bound = rp.scene_args(arrays, torch.tensor(_cv((0.0, 2.5, 9.0))))
    cc, fc = rp.cull_args(sc, cam)
    assert cc.compact and fc.compact and cc.tile == cp.COARSE_TILE and fc.tile == cp.FINE_TILE
    assert fc.lists.shape == (-(-H // fc.tile) * -(-W // fc.tile), 24)
    assert int(fc.counts.max()) <= 24 and int(fc.counts.sum()) > 0
    # Active entries first, in plan order, padding rows never emitted.
    pushed = set(np.nonzero(cull_t._pushed_rows(spec))[0].tolist())
    plan_rows = list(build_compact_plan(spec)["groups"][0]["rows"])
    for lst, n in zip(fc.lists.tolist(), fc.counts[:, 0].tolist()):
        act = lst[:n]
        assert set(act) <= pushed
        assert act == sorted(act, key=plan_rows.index)
    # The wrappers run the plain versions on the CPU, with the same lists.
    before = (cp.coarse.launches, cp.fine.launches)
    pre = cp.coarse(sc, cam, bound, rp.params, cc)
    img = cp.fine(sc, cam, bound, rp.params, *pre, cull=fc)
    assert (cp.coarse.launches, cp.fine.launches) == before
    assert torch.equal(img, rp(arrays, cam))
    with pytest.raises(ValueError, match="tiles per row"):
        cp.fine(sc, cam, bound, rp.params, *pre, cull=dataclasses.replace(fc, n_tx=fc.n_tx + 1))


def test_relaxed_march_matches_jax_unculled():
    """relax = 1.6 without culling: the relaxed fine march alone, on the
    headline scene, against the JAX forward."""
    cfg_j = dataclasses.replace(CFG_J, leaf_cull=False)
    (spec_j, arrays_j), (spec, arrays) = _both(lambda: SCENES["config2"](rm))
    pos = (0.0, 1.6, 4.2)
    img = rt.make_renderer(spec, W, H, rt.RenderConfig(**dataclasses.asdict(cfg_j)), mode="forward",
                           backend="pallas_prepass", device="cpu")(
        arrays, rt.Camera.looking_at(position=pos, target=(0, 0, 0))).numpy()
    ref = np.asarray(render_aa_j(spec_j, cfg_j, W, H, interpret=True, prepass_block=1, aa_packed=True)(
        arrays_j, jnp.asarray(_cv(pos))))
    d = np.abs(img - ref)
    assert d.mean() < 5e-4 and _neigh_frac(img, ref) < 0.008, (d.max(), d.mean())
