"""The packed scene words of K1/K2 and their plain evaluator against raymarch_tpu.

The coarse and fine kernels read a scene as packed words (one 16-byte word
per instruction: op | slot << 8, leaf row, row kind, a word they do not
read; the backwards' format) over float4 leaf rows, and keep the value
stack's top in a register with the slots below it on a route chosen by the
spec's stack depth (`cuda_march.stack_route`: a register up to depth
REG_STACK, else shared memory). Checked here on the CPU:

- the host packing (`pack_words`, static and per-frame dynamic words, one
  format with `GradLayout.packed`), the route by depth, the words' and leaf
  rows' alignment for 16-byte loads;
- `cuda_march.scene_words_plain`, which reads exactly those words on that
  route, held to the JAX package's `sdf._apply_static_tape` and
  `_apply_static_tape_color` (static and gated) and its dynamic-tape scene
  functions (`make_scene_fn`, `make_scene_color_fn`), over scenes with every
  primitive, op, transform and `.paint`, and balanced unions of 2-1,024
  leaves at stack depths 2 to 32, un-culled and gated by tile masks.

Tolerance: max |d| < 1e-5 on distances and albedos (f32 evaluations of the
same formulas; values of order 1-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops import culling as culling_j
from raymarch_tpu.ops import sdf as sdf_j
from raymarch_tpu_torch.ops import cuda_grad as cg
from raymarch_tpu_torch.ops import cuda_march as cm
from raymarch_tpu_torch.ops import cuda_prepass as cp
from raymarch_tpu_torch.ops import culling as culling_t
from raymarch_tpu_torch.ops import opcodes as oc

from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes.
torch.set_num_threads(1)

ATOL = 1e-5
MAX_DIST = rm.DEFAULT_CONFIG.max_dist
ALBEDO = (0.7, 0.6, 0.5)
N_PTS = 2048
N_TILES = 4


def _balanced(m, n, seed=5):
    """n random spheres in a balanced tree of hard unions (up to 256 leaves
    every eighth a rotated box, so that the words carry two row kinds; the
    reference's macro stream packs leaf rows in 10 bits, so a larger bank
    keeps one type)."""
    rng = np.random.default_rng(seed)
    parts = []
    for k in range(n):
        c = tuple(rng.uniform(-3.0, 3.0, 3))
        if k % 8 == 7 and n <= 256:
            parts.append(m.box(center=c, half_extents=(0.3, 0.2, 0.25), rotation=(0.9, 0.2, -0.3, 0.25)))
        else:
            parts.append(m.sphere(center=c, radius=float(rng.uniform(0.15, 0.45))))
    while len(parts) > 1:
        parts = [parts[i] | parts[i + 1] if i + 1 < len(parts) else parts[i] for i in range(0, len(parts), 2)]
    return parts[0]


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(0).uniform(-3.0, 3.0, (N_PTS, 3)).astype(np.float32)


def _tile_masks(spec, seed):
    """A random leaf mask per tile (about 2/3 of the rows active) and each
    point's tile -> (active bool[n_leaves, N_PTS] numpy)."""
    rng = np.random.default_rng(seed)
    act = rng.uniform(size=(N_TILES, spec.n_leaves)) < 0.67
    tid = np.arange(N_PTS) % N_TILES
    return act[tid].T


def _jax_static(spec_j, arrays_j, pts, active=None, colour=False):
    """The JAX package's static tape at pts (gated: a culled leaf reads FAR
    with the default albedo), distance or (distance, rgb[N, 3])."""
    rows = sdf_j._leaf_row_types(spec_j)
    lp = jnp.asarray(arrays_j.leaf_params)
    p = jnp.asarray(pts)
    default = jnp.asarray(ALBEDO, jnp.float32)

    def leaf_fn(row):
        t, rot = rows[row]
        d = sdf_j._single_leaf_distance(p, lp[row], t, rot)
        on = None if active is None else jnp.asarray(active[row])
        if on is not None:
            d = jnp.where(on, d, culling_j.FAR)
        if not colour:
            return d
        flag = lp[row, oc.LEAF_MAT_FLAG]
        rgb = flag * lp[row, oc.LEAF_ALBEDO:oc.LEAF_ALBEDO + 3] + (1.0 - flag) * default
        rgb = tuple(rgb[c] if on is None else jnp.where(on, rgb[c], default[c]) for c in range(3))
        return d, rgb

    opp = jnp.asarray(arrays_j.op_param)
    if not colour:
        return np.asarray(sdf_j._apply_static_tape(spec_j, opp, leaf_fn, MAX_DIST, p[:, 0]))
    d, rgb = sdf_j._apply_static_tape_color(spec_j, opp, leaf_fn, MAX_DIST, p[:, 0],
                                            (default[0], default[1], default[2]))
    return np.asarray(d), np.stack([np.broadcast_to(np.asarray(c), (N_PTS,)) for c in rgb], axis=-1)


def _words(spec, arrays, pts, active=None, colour=False):
    sb = cm.scene_buffers(spec, arrays, "cpu")
    p = torch.as_tensor(pts)
    cull = None if active is None else (lambda row: torch.as_tensor(active[row]))
    out = cm.scene_words_plain(sb, MAX_DIST, p[:, 0], p[:, 1], p[:, 2], cull=cull,
                               default_rgb=ALBEDO if colour else None)
    if not colour:
        return out.numpy()
    return out[0].numpy(), torch.stack(out[1], dim=-1).numpy()


def _close(got, ref):
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _close(g, r)
        return
    assert got.shape == ref.shape and got.dtype == np.float32
    assert float(np.abs(got - ref).max(initial=0.0)) < ATOL


# --------------------------------------------------------------------------
# Host packing, routes, alignment


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_words(name, static):
    """The words decode to the tape's opcodes, slots and pushed rows with
    the rows' kinds; a static spec's are GradLayout.packed's but for its
    gradient-slot word."""
    spec, arrays = rt.compile_scene(SCENES[name](rt), static=static)
    sb = cm.scene_buffers(spec, arrays, "cpu")
    words = sb.words.numpy()
    tape = sb.tape.numpy()
    n = sb.n_instr
    assert words.dtype == np.int32 and words.shape == (max(n, 1), 4)
    assert words.ctypes.data % 16 == 0
    if n == 0:
        return
    ops, args, slots = tape[:, :n]
    push = ops == oc.COP_PUSH
    np.testing.assert_array_equal(words[:n, 0] & 0xFF, ops)
    np.testing.assert_array_equal(words[:n, 0] >> 8, slots)
    np.testing.assert_array_equal(words[:n, 1], np.where(push, args, 0))
    np.testing.assert_array_equal(words[:n, 2], np.where(push, cm.row_kinds(spec)[args], 0))
    for r, t, rot in cm._leaf_static_rows(spec):
        assert cm.row_kinds(spec)[r] == t | (cm.ROTATED_BIT if rot else 0)
    if static:
        packed = np.asarray(cg.GradLayout.of(spec, rt.DEFAULT_CONFIG).packed, np.int32)
        np.testing.assert_array_equal(words[:n, :3], packed[:, :3])
        np.testing.assert_array_equal(words[:n, 3], 0)
    else:
        # The per-frame words from tensors (packed on their device) equal the
        # host-packed ones.
        tensors = dataclasses.replace(
            arrays, **{k: torch.as_tensor(getattr(arrays, k)) for k in ("tape_ops", "tape_arg", "out_slot")})
        np.testing.assert_array_equal(cm.scene_buffers(spec, tensors, "cpu").words.numpy(), words)


@pytest.mark.parametrize("n_leaves,stack_depth", [(2, None), (4, None), (16, None), (64, None), (256, None),
                                                  (1024, None), (16, 32)])
def test_stack_route(n_leaves, stack_depth):
    """The route by depth: <= REG_STACK -> the slot below the top in a
    register, deeper -> shared memory; every slot the words spill to or
    read lies in the route's slots."""
    kw = {} if stack_depth is None else {"stack_depth": stack_depth}
    spec, arrays = rt.compile_scene(_balanced(rt, n_leaves), static=True, **kw)
    d = spec.stack_depth
    assert d in (2, 4, 8, 16, 32)
    route = cm.stack_route(spec)
    assert cm.REG_STACK == 2 and route == (cm.REG_STACK if d <= cm.REG_STACK else cm.STK_SMEM)
    n_below = d - 1 if route == cm.STK_SMEM else cm.REG_STACK - 1
    words = cm.scene_buffers(spec, arrays, "cpu").words.numpy()
    ops, slots = words[:, 0] & 0xFF, words[:, 0] >> 8
    spill = slots[(ops == oc.COP_PUSH) & (slots > 0)] - 1
    read = slots[(ops != oc.COP_PUSH) & (ops != oc.COP_ROUND) & (ops != oc.COP_ONION)]
    assert max(spill.max(initial=0), read.max(initial=0)) < n_below
    assert cm.route_name(route) == ("shared memory" if route == cm.STK_SMEM else "a register")


@pytest.mark.parametrize("name", ["balanced8", "ops"])
def test_dynamic_tape_deeper_than_its_spec_is_refused(name):
    """A frame's dynamic tape whose slots pass its spec's depth (same
    instruction and leaf buckets, a deeper tree) is refused on the host:
    the kernels size the stack's route by the spec."""
    build = (lambda m: _balanced(m, 8)) if name == "balanced8" else SCENES[name]
    spec, arrays = rt.compile_scene(build(rt))
    assert spec.static_tape is None and spec.stack_depth > 2
    deepest = int(np.asarray(arrays.out_slot)[np.asarray(arrays.tape_ops) != oc.COP_NOP].max())
    assert deepest < spec.stack_depth
    cm.scene_buffers(spec, arrays, "cpu")  # its own spec holds it
    shallow = dataclasses.replace(spec, stack_depth=deepest)
    with pytest.raises(ValueError, match="past the spec's depth"):
        cm.scene_buffers(shallow, arrays, "cpu")


def test_leaf_rows_float4():
    """The wrappers hand the kernels 16-byte-aligned leaf rows (a row of 16
    words is four float4s): a view that is not aligned is copied, the
    scene's own rows are passed as they are."""
    spec, arrays = rt.compile_scene(SCENES["all_prims"](rt), static=True)
    sb = cm.scene_buffers(spec, arrays, "cpu")
    assert sb.leaf_params.data_ptr() % 16 == 0 and sb.leaf_params.stride() == (16, 1)
    ptrs, rows = cp._words_ptrs(sb)
    assert rows is sb.leaf_params and ptrs[0] == sb.leaf_params.data_ptr()
    assert ptrs[2:] == (sb.words.data_ptr(), sb.n_instr, sb.op_param.data_ptr(), 0, cm.stack_route(spec),
                        spec.stack_depth)
    backing = torch.zeros(spec.n_leaves * 16 + 1)
    shifted = backing[1:].view(spec.n_leaves, 16)
    shifted.copy_(sb.leaf_params)
    ptrs, rows = cp._words_ptrs(dataclasses.replace(sb, leaf_params=shifted))
    assert shifted.data_ptr() % 16 and ptrs[0] % 16 == 0 and ptrs[0] == rows.data_ptr()
    assert torch.equal(rows, sb.leaf_params)
    # The float4 view of a row: words 4k .. 4k + 3 in float4 k.
    v4 = rows.view(spec.n_leaves, 4, 4)
    assert torch.equal(v4[:, 1, 3], rows[:, 7]) and torch.equal(v4[:, 3, 3], rows[:, oc.LEAF_MAT_FLAG])


def test_words_plain_refuses_a_slot_past_its_route():
    """A tape deeper than its spec's depth has slots past the route: the
    plain evaluator raises where the kernel's route has none."""
    spec, arrays = rt.compile_scene(_balanced(rt, 8), static=True)
    sb = cm.scene_buffers(spec, arrays, "cpu")
    shallow = dataclasses.replace(sb, spec=dataclasses.replace(spec, stack_depth=2))
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="past the"):
        cm.scene_words_plain(shallow, MAX_DIST, p, p, p)


# --------------------------------------------------------------------------
# The plain evaluator against the JAX package


@pytest.mark.parametrize("gated", [False, True], ids=["uncull", "gated"])
@pytest.mark.parametrize("colour", [False, True], ids=["distance", "colour"])
@pytest.mark.parametrize("name", sorted(k for k in SCENES if k != "empty"))
def test_static_words_match_jax(name, colour, gated, points):
    spec_j, arrays_j = rm.compile_scene(SCENES[name](rm), static=True)
    spec, arrays = rt.compile_scene(SCENES[name](rt), static=True)
    active = _tile_masks(spec, seed=len(name)) if gated else None
    _close(_words(spec, arrays, points, active, colour), _jax_static(spec_j, arrays_j, points, active, colour))


@pytest.mark.parametrize("gated", [False, True], ids=["uncull", "gated"])
@pytest.mark.parametrize("colour", [False, True], ids=["distance", "colour"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_dynamic_words_match_jax(name, colour, gated, points):
    """A dynamic tape (NOP-padded bucket, top started at max_dist) against
    the JAX dynamic-tape scene functions; gated, against the JAX static
    tape gated the same way (the dynamic tape's real instructions are the
    static tape's, so the two fold the same leaves in the same order)."""
    spec, arrays = rt.compile_scene(SCENES[name](rt))
    assert spec.static_tape is None
    active = _tile_masks(spec, seed=len(name)) if gated else None
    got = _words(spec, arrays, points, active, colour)
    if gated and name == "empty":  # nothing to gate: max_dist and the default albedo
        ref = np.full(N_PTS, MAX_DIST, np.float32)
        ref = (ref, np.broadcast_to(np.asarray(ALBEDO, np.float32), (N_PTS, 3))) if colour else ref
    elif gated:
        ref = _jax_static(*rm.compile_scene(SCENES[name](rm), static=True), points, active, colour)
    else:
        spec_j, arrays_j = rm.compile_scene(SCENES[name](rm))
        cfg_j = dataclasses.replace(rm.DEFAULT_CONFIG, albedo=ALBEDO)
        if colour:
            d, rgb = jax.jit(sdf_j.make_scene_color_fn(spec_j, cfg_j))(jnp.asarray(points), arrays_j)
            ref = (np.asarray(d), np.asarray(rgb))
        else:
            ref = np.asarray(jax.jit(sdf_j.make_scene_fn(spec_j, cfg_j))(jnp.asarray(points), arrays_j))
    _close(got, ref)


@pytest.mark.parametrize("gated", [False, True], ids=["uncull", "gated"])
@pytest.mark.parametrize("n_leaves,stack_depth", [(2, None), (4, None), (16, None), (64, None), (256, None),
                                                  (1024, None), (16, 32)])
def test_balanced_words_match_jax(n_leaves, stack_depth, gated, points):
    """Balanced unions of 2-1,024 leaves: stack depths 2 to 16 by their
    trees, 32 given to compile_scene (the shared-memory route); the
    dynamic tape of each too, against the JAX static tape."""
    kw = {} if stack_depth is None else {"stack_depth": stack_depth}
    spec_j, arrays_j = rm.compile_scene(_balanced(rm, n_leaves), static=True, **kw)
    ref = None
    for static in (True, False):
        spec, arrays = rt.compile_scene(_balanced(rt, n_leaves), static=static, **kw)
        active = _tile_masks(spec, seed=n_leaves) if gated else None
        if ref is None:
            ref = _jax_static(spec_j, arrays_j, points, active)
        _close(_words(spec, arrays, points, active), ref)


def test_k12_sources_build_without_contraction():
    """Every source that instantiates a K1/K2 build or the chained pixel
    kernel K3, and every source of the unpacked fine pass K4, is compiled
    with -fmad=false (each operation rounds as the plain versions')."""
    from raymarch_tpu_torch import _build

    k12 = {src.name for src in _build.CSRC.glob("*.cu")
           if any(k in src.read_text() for k in ("launch_fine_hard<", "launch_fine_march<", "launch_coarse<",
                                                 "fine_wide<", "launch_fine_soft(", "coarse_px_kernel<"))}
    assert k12 == set(_build.K12_SOURCES)
    assert "coarse_px.cu" in k12
    k4 = {src.name for src in _build.CSRC.glob("*.cu") if "launch_unpacked<" in src.read_text()}
    assert k4 == set(_build.K4_SOURCES)
    for name in (*_build.K12_SOURCES, *_build.K4_SOURCES):
        assert "-fmad=false" in _build.SOURCE_FLAGS[name]
    assert "-fmad=false" in _build.SOURCE_FLAGS["coarse_px.cu"]


def test_far_is_the_kernels():
    """The gated words read the JAX package's FAR for a culled leaf, which
    is the kernels' CULL_FAR (csrc/scene_eval.cuh)."""
    assert culling_t.FAR == culling_j.FAR == 1.0e4
