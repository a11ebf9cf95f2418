"""Scene compilation: CSG tree -> wire tape and -> device program.

A copy of `raymarch_tpu.ops.tape` (numpy only, no JAX hooks), so the port
compiles scenes without importing the JAX package; tests/test_torch_tape.py
holds the two copies equal. Two encodings of the same postorder (RPN)
program:

1. **Wire tape** (`encode_wire`): a flat `uint32` stream of opcodes and
   bit-cast f32 params, ABI-compatible with the reference's command buffer
   (reference src/ray_marching/csg/builder.rs:41-61; postorder emission per
   operations/mod.rs:13-17).

2. **Device program** (`compile_scene` -> `TapeSpec` + `TapeArrays`): leaf
   parameter banks grouped by primitive type (`leaf_params: f32[L_pad, 16]`)
   and a combine tape (PUSH / UNION / ... / ROUND) with stack slots
   precomputed at compile time (`out_slot`).

   Everything dynamic about the scene lives in *arrays* (`TapeArrays`):
   leaf params, instruction opcodes/args/params. `TapeSpec` is only
   shape/bucketing information (plus the static tape topology when
   `static=True`). Editing the scene is a buffer upload with no rebuild as
   long as the `TapeSpec` is unchanged (reference README.md:7).

`from_reference` converts the JAX package's `TapeSpec`/`TapeArrays` into
this module's classes without importing them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..models import csg
from . import opcodes as oc

# ---------------------------------------------------------------------------
# Wire tape encoder
# ---------------------------------------------------------------------------


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


class WireTapeBuilder:
    """Appends opcodes and bit-cast f32 params to a u32 stream.

    Mirrors the reference's `CSGCommandBufferBuilder` (builder.rs:26-62):
    `cmd_count` counts commands, params follow their opcode inline.
    """

    def __init__(self) -> None:
        self.cmd_count = 0
        self.words: list[int] = []

    def push_command(self, op: int) -> "WireTapeBuilder":
        self.cmd_count += 1
        self.words.append(int(op))
        return self

    def push_param_float(self, v: float) -> "WireTapeBuilder":
        self.words.append(_f32_bits(v))
        return self

    def push_param_vec3(self, v) -> "WireTapeBuilder":
        for x in v:
            self.push_param_float(x)
        return self

    def push_param_quat(self, q) -> "WireTapeBuilder":
        for x in q:
            self.push_param_float(x)
        return self

    def tape(self) -> np.ndarray:
        return np.asarray(self.words, dtype=np.uint32)


def _is_identity(q) -> bool:
    from ..utils import math3d

    return math3d.is_identity_quat(q)


def _emit_node(node: csg.CSGNode, b: WireTapeBuilder) -> None:
    """Postorder emission; children first, then the operator
    (reference operations/mod.rs:13-17). A painted primitive is followed by a
    postfix OP_MATERIAL attribute (extension; see opcodes.OP_MATERIAL)."""
    if isinstance(node, csg.Primitive):
        _emit_primitive(node, b)
        if node.material is not None:
            b.push_command(oc.OP_MATERIAL).push_param_vec3(node.material)
    elif isinstance(node, csg.BinaryOp):
        _emit_node(node.a, b)
        _emit_node(node.b, b)
        op = {
            csg.Union: oc.OP_UNION,
            csg.Subtraction: oc.OP_SUBTRACTION,
            csg.Intersection: oc.OP_INTERSECTION,
            csg.SmoothUnion: oc.OP_SMOOTH_UNION,
            csg.SmoothSubtraction: oc.OP_SMOOTH_SUBTRACTION,
            csg.SmoothIntersection: oc.OP_SMOOTH_INTERSECTION,
        }[type(node)]
        b.push_command(op)
        if isinstance(node, csg.SmoothBinaryOp):
            b.push_param_float(node.k)
    elif isinstance(node, csg.Round):
        _emit_node(node.child, b)
        b.push_command(oc.OP_ROUND).push_param_float(node.radius)
    elif isinstance(node, csg.Onion):
        _emit_node(node.child, b)
        b.push_command(oc.OP_ONION).push_param_float(node.thickness)
    elif isinstance(node, csg.Transform):
        raise ValueError(
            "wire tape has no transform opcodes; call csg.fold_transforms first"
        )
    else:
        raise TypeError(f"unknown CSG node type: {type(node).__name__}")


def _emit_primitive(node: csg.Primitive, b: WireTapeBuilder) -> None:
    if isinstance(node, csg.Sphere):
        b.push_command(oc.OP_SPHERE).push_param_vec3(node.center).push_param_float(
            node.radius
        )
    elif isinstance(node, csg.Box):
        if _is_identity(node.rotation):
            b.push_command(oc.OP_BOX).push_param_vec3(node.center).push_param_vec3(
                node.half_extents
            )
        else:
            b.push_command(oc.OP_BOX_ROT).push_param_quat(node.rotation)
            b.push_param_vec3(node.center).push_param_vec3(node.half_extents)
    elif isinstance(node, csg.Torus):
        if _is_identity(node.rotation):
            b.push_command(oc.OP_TORUS).push_param_vec3(node.center)
        else:
            b.push_command(oc.OP_TORUS_ROT).push_param_quat(node.rotation)
            b.push_param_vec3(node.center)
        b.push_param_float(node.major_radius).push_param_float(node.minor_radius)
    elif isinstance(node, csg.Plane):
        b.push_command(oc.OP_PLANE).push_param_vec3(node.normal).push_param_float(
            node.offset
        )
    elif isinstance(node, csg.Cylinder):
        if _is_identity(node.rotation):
            b.push_command(oc.OP_CYLINDER).push_param_vec3(node.center)
        else:
            b.push_command(oc.OP_CYLINDER_ROT).push_param_quat(node.rotation)
            b.push_param_vec3(node.center)
        b.push_param_float(node.radius).push_param_float(node.half_height)
    elif isinstance(node, csg.Capsule):
        if _is_identity(node.rotation):
            b.push_command(oc.OP_CAPSULE).push_param_vec3(node.center)
        else:
            b.push_command(oc.OP_CAPSULE_ROT).push_param_quat(node.rotation)
            b.push_param_vec3(node.center)
        b.push_param_float(node.radius).push_param_float(node.half_height)
    elif isinstance(node, csg.Cone):
        if _is_identity(node.rotation):
            b.push_command(oc.OP_CONE).push_param_vec3(node.center)
        else:
            b.push_command(oc.OP_CONE_ROT).push_param_quat(node.rotation)
            b.push_param_vec3(node.center)
        b.push_param_float(node.half_height)
        b.push_param_float(node.r_bottom).push_param_float(node.r_top)
    else:
        raise TypeError(f"unknown primitive type: {type(node).__name__}")


def encode_wire(scene: Optional[csg.CSGNode]) -> np.ndarray:
    """Compile a scene to its wire tape. `None` (incomplete graph) yields an
    empty tape, matching the reference's failure semantics
    (csg_node_graph.rs evaluate -> None -> empty tape -> max_dist everywhere)."""
    b = WireTapeBuilder()
    if scene is not None:
        _emit_node(csg.fold_transforms(scene), b)
    return b.tape()


def wire_cmd_count(tape: np.ndarray) -> int:
    """Number of commands in a wire tape (walks the stream)."""
    n = 0
    i = 0
    while i < len(tape):
        op = int(tape[i])
        i += 1 + oc.WIRE_PARAM_COUNT[op]
        n += 1
    return n


# ---------------------------------------------------------------------------
# Device program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TapeSpec:
    """Static (hashable) shape/bucketing info for a compiled scene.

    Two scenes with the same TapeSpec share one renderer; all scene content
    lives in TapeArrays.
    """

    # Per-type leaf bank extents in the packed leaf_params array:
    # ((leaf_type, start, stop), ...) with stop-start = bucketed capacity.
    type_slices: tuple[tuple[int, int, int], ...]
    n_leaves: int  # padded total leaf rows
    n_instr: int  # padded combine-tape length
    stack_depth: int
    # Per-type flag: does any leaf of this type carry a non-identity rotation?
    # (static so the unrotated fast path can skip quaternion math)
    rotated_types: tuple[int, ...]
    # Optional STATIC combine tape: ((cop, arg, slot), ...) baked into the
    # compiled program. When set, evaluators unroll the combine phase into
    # straight-line code (no lax.switch, no value-stack memory) — the fastest
    # path. Numeric params (geometry, blend radii) stay dynamic, so param
    # edits still never recompile; only TOPOLOGY edits do. `None` = fully
    # dynamic tape (any edit is a buffer swap, the reference's
    # runtime-upload semantics, README.md:7).
    static_tape: Optional[tuple] = None
    # Any leaf painted with a material (reference roadmap, README.md:10)?
    # Static so material-free scenes compile zero material code; painting a
    # first material (or unpainting the last) is a topology-class edit.
    # Albedo VALUES are dynamic (differentiable) in leaf_params[:, 12:15].
    has_materials: bool = False
    # Padded MACRO tape length (see `macroize_streams`): the dynamic-tape
    # Pallas interpreter consumes a fused push/push/combine macro stream whose
    # per-entry fixed cost is what the interpreter pays per distance query,
    # so ~halving the entry count ~halves the dynamic-vs-static overhead.
    n_macro: int = 1
    # True when every real macro writes stack slot 0 (depth<=2 trees without
    # a unary applied to a right-hand leaf): the interpreter then runs a pure
    # register accumulator with ZERO stack-slot selects.
    macro_slot0: bool = False


@dataclasses.dataclass
class TapeArrays:
    """Dynamic scene content (numpy; uploaded to the device per frame).

    leaf_params: f32[n_leaves, LEAF_PARAM_WIDTH] — differentiable geometry.
    tape_ops:    i32[n_instr] — COP_* opcodes (COP_NOP padding).
    tape_arg:    i32[n_instr] — leaf row index for COP_PUSH, else 0.
    op_param:    f32[n_instr] — blend radius / round radius / onion thickness.
    out_slot:    i32[n_instr] — stack slot written by each instruction.

    Macro streams (derived from the above by `macroize_streams`; consumed by
    the Pallas dynamic-tape interpreter — op_param stays the one
    differentiable parameter array, indexed via the packed kidx):
    macro_ops:   i32[n_macro] — pushA | pushB<<1 | COP<<2.
    macro_arg:   i32[n_macro] — leaf row argA<<10 | argB.
    macro_slotk: i32[n_macro] — out slot | op_param index<<8.
    """

    leaf_params: np.ndarray
    tape_ops: np.ndarray
    tape_arg: np.ndarray
    op_param: np.ndarray
    out_slot: np.ndarray
    macro_ops: np.ndarray
    macro_arg: np.ndarray
    macro_slotk: np.ndarray


def _next_pow2(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


_COP_BINARY = (
    oc.COP_UNION,
    oc.COP_INTERSECTION,
    oc.COP_SUBTRACTION,
    oc.COP_SMOOTH_UNION,
    oc.COP_SMOOTH_INTERSECTION,
    oc.COP_SMOOTH_SUBTRACTION,
)
_COP_UNARY = (oc.COP_ROUND, oc.COP_ONION)


def macroize_streams(tape_ops, tape_arg, out_slot, n_real, n_macro=None):
    """Fuse the postorder instruction streams into MACRO entries.

    A macro is (pushA?, pushB?, cop) at stack slot s with semantics

        a = pushA ? leaf[argA] : stack[s]
        b = pushB ? leaf[argB] : stack[s+1]
        stack[s] = cop(a, b, op_param[kidx])        # COP_NOP -> a

    Greedy fusion patterns (postorder guarantees these are the only shapes):
      PUSH x@s, PUSH y@s+1, binary@s  -> (pushA, pushB, binary)@s   [3 -> 1]
      PUSH y@s+1, binary@s            -> (pushB, binary)@s          [2 -> 1]
      PUSH x@s, unary@s               -> (pushA, unary)@s           [2 -> 1]
      anything else                   -> 1:1

    The dynamic-tape interpreter pays a fixed per-entry cost per distance
    query, so the ~2x entry reduction is a direct interpreter speedup; a
    `pushB` value is always consumed by the fused cop, never stored, which
    is what keeps the depth<=2 accumulator form (macro_slot0) select-free.

    Packing (asserted in range): macro_ops = pushA | pushB<<1 | cop<<2;
    macro_arg = argA<<10 | argB; macro_slotk = slot | kidx<<8 where kidx
    indexes the ORIGINAL op_param stream (which stays the differentiable
    parameter array).

    Returns (macro_ops, macro_arg, macro_slotk, n_macro_real, slot0) with
    arrays padded to `n_macro` (or to the real count when None).
    """
    ops = np.asarray(tape_ops)
    arg = np.asarray(tape_arg)
    slot = np.asarray(out_slot)
    macros = []  # (pushA, pushB, cop, argA, argB, s, kidx)
    i = 0
    while i < n_real:
        op_i = int(ops[i])
        if op_i == oc.COP_PUSH:
            if (
                i + 2 < n_real
                and int(ops[i + 1]) == oc.COP_PUSH
                and int(ops[i + 2]) in _COP_BINARY
                and int(slot[i + 1]) == int(slot[i]) + 1
                and int(slot[i + 2]) == int(slot[i])
            ):
                macros.append(
                    (1, 1, int(ops[i + 2]), int(arg[i]), int(arg[i + 1]),
                     int(slot[i]), i + 2)
                )
                i += 3
            elif (
                i + 1 < n_real
                and int(ops[i + 1]) in _COP_BINARY
                and int(slot[i + 1]) == int(slot[i]) - 1
            ):
                macros.append(
                    (0, 1, int(ops[i + 1]), 0, int(arg[i]),
                     int(slot[i + 1]), i + 1)
                )
                i += 2
            elif (
                i + 1 < n_real
                and int(ops[i + 1]) in _COP_UNARY
                and int(slot[i + 1]) == int(slot[i])
            ):
                macros.append(
                    (1, 0, int(ops[i + 1]), int(arg[i]), 0, int(slot[i]), i + 1)
                )
                i += 2
            else:
                macros.append((1, 0, oc.COP_NOP, int(arg[i]), 0, int(slot[i]), 0))
                i += 1
        else:
            macros.append((0, 0, op_i, 0, 0, int(slot[i]), i))
            i += 1

    n_macro_real = len(macros)
    slot0 = all(m[5] == 0 for m in macros)
    if n_macro is None:
        n_macro = max(n_macro_real, 1)
    assert n_macro_real <= n_macro, (n_macro_real, n_macro)
    mops = np.zeros(n_macro, dtype=np.int32)
    marg = np.zeros(n_macro, dtype=np.int32)
    mslotk = np.zeros(n_macro, dtype=np.int32)
    if any(a_ >= 1024 or b_ >= 1024 for _, _, _, a_, b_, _, _ in macros):
        # A leaf row past macro_arg's 10-bit fields, which only the
        # reference's dynamic Pallas interpreter reads (its compile_scene
        # refuses such a scene): the port's kernels read the instruction
        # stream alone, so the stream of a bank past 1,024 rows stays empty
        # (all NOP) and the scene compiles.
        return mops, marg, mslotk, n_macro_real, slot0
    for j, (pa, pb, cop, a_, b_, s, kidx) in enumerate(macros):
        assert s < 256, "stack depth exceeds macro_slotk packing"
        assert kidx < (1 << 23), "op_param index exceeds macro_slotk packing"
        mops[j] = pa | (pb << 1) | (cop << 2)
        marg[j] = (a_ << 10) | b_
        mslotk[j] = s | (kidx << 8)
    return mops, marg, mslotk, n_macro_real, slot0


_WIRE_TO_COP = {
    oc.OP_UNION: oc.COP_UNION,
    oc.OP_SUBTRACTION: oc.COP_SUBTRACTION,
    oc.OP_INTERSECTION: oc.COP_INTERSECTION,
    oc.OP_SMOOTH_UNION: oc.COP_SMOOTH_UNION,
    oc.OP_SMOOTH_SUBTRACTION: oc.COP_SMOOTH_SUBTRACTION,
    oc.OP_SMOOTH_INTERSECTION: oc.COP_SMOOTH_INTERSECTION,
    oc.OP_ROUND: oc.COP_ROUND,
    oc.OP_ONION: oc.COP_ONION,
}

_WIRE_PRIM_TO_LEAF = {
    oc.OP_SPHERE: oc.LEAF_SPHERE,
    oc.OP_BOX: oc.LEAF_BOX,
    oc.OP_BOX_ROT: oc.LEAF_BOX,
    oc.OP_PLANE: oc.LEAF_PLANE,
    oc.OP_TORUS: oc.LEAF_TORUS,
    oc.OP_TORUS_ROT: oc.LEAF_TORUS,
    oc.OP_CYLINDER: oc.LEAF_CYLINDER,
    oc.OP_CYLINDER_ROT: oc.LEAF_CYLINDER,
    oc.OP_CAPSULE: oc.LEAF_CAPSULE,
    oc.OP_CAPSULE_ROT: oc.LEAF_CAPSULE,
    oc.OP_CONE: oc.LEAF_CONE,
    oc.OP_CONE_ROT: oc.LEAF_CONE,
}


def _decode_wire(tape: np.ndarray):
    """Walk a wire tape into (leaf list, instruction list).

    Leaves: (leaf_type, rotated, param_row f32[LEAF_PARAM_WIDTH]).
    Instructions: (cop, leaf_ordinal_or_0, op_param).
    """
    f32 = tape.view(np.float32)
    leaves: list[tuple[int, bool, np.ndarray]] = []
    instrs: list[tuple[int, int, float]] = []
    i = 0
    while i < len(tape):
        op = int(tape[i])
        i += 1
        npar = oc.WIRE_PARAM_COUNT[op]
        pars = f32[i : i + npar]
        i += npar
        if op in oc.PRIMITIVE_OPS:
            row = np.zeros(oc.LEAF_PARAM_WIDTH, dtype=np.float32)
            row[0] = 1.0  # identity quat
            rotated = op in (
                oc.OP_BOX_ROT,
                oc.OP_TORUS_ROT,
                oc.OP_CYLINDER_ROT,
                oc.OP_CAPSULE_ROT,
                oc.OP_CONE_ROT,
            )
            if rotated:
                row[0:4] = pars[0:4]
                rest = pars[4:]
            else:
                rest = pars
            if op == oc.OP_SPHERE:
                row[4:7] = rest[0:3]
                row[7] = rest[3]
            elif op in (oc.OP_BOX, oc.OP_BOX_ROT):
                row[4:7] = rest[0:3]
                row[7:10] = rest[3:6]
            elif op in (oc.OP_TORUS, oc.OP_TORUS_ROT):
                row[4:7] = rest[0:3]
                row[7] = rest[3]
                row[8] = rest[4]
            elif op in (oc.OP_CYLINDER, oc.OP_CYLINDER_ROT,
                        oc.OP_CAPSULE, oc.OP_CAPSULE_ROT):
                row[4:7] = rest[0:3]
                row[7] = rest[3]
                row[8] = rest[4]
            elif op in (oc.OP_CONE, oc.OP_CONE_ROT):
                row[4:7] = rest[0:3]
                row[7] = rest[3]
                row[8] = rest[4]
                row[9] = rest[5]
            elif op == oc.OP_PLANE:
                row[7:10] = rest[0:3]
                row[10] = rest[3]
            leaves.append((_WIRE_PRIM_TO_LEAF[op], rotated, row))
            instrs.append((oc.COP_PUSH, len(leaves) - 1, 0.0))
        elif op == oc.OP_MATERIAL:
            if not leaves:
                raise ValueError("OP_MATERIAL with no preceding primitive")
            leaves[-1][2][oc.LEAF_ALBEDO : oc.LEAF_ALBEDO + 3] = pars[0:3]
            leaves[-1][2][oc.LEAF_MAT_FLAG] = 1.0
        else:
            k = float(pars[0]) if npar else 0.0
            instrs.append((_WIRE_TO_COP[op], 0, k))
    return leaves, instrs


def _morton3(xyz: np.ndarray) -> np.ndarray:
    """Interleaved 10-bit-per-axis Morton codes for points xyz[N,3],
    quantized over their own bounding box (spatial sort key)."""
    lo = xyz.min(axis=0)
    span = np.maximum(xyz.max(axis=0) - lo, 1e-9)
    q = np.clip(((xyz - lo) / span * 1023.0), 0, 1023).astype(np.uint64)
    codes = np.zeros(len(xyz), dtype=np.uint64)
    for bit in range(10):
        for axis in range(3):
            codes |= ((q[:, axis] >> bit) & 1) << np.uint64(3 * bit + axis)
    return codes


def _rebalance_instrs(instrs, leaves):
    """Rebalance maximal chains of the associative hard ops (UNION,
    INTERSECTION) into balanced binary trees with operands in Morton order.

    Two wins, both exact (min/max are associative and commutative):
    - the combine dependency chain shrinks from O(n) to O(log n), and the
      required stack depth to ceil(log2 n) + 1;
    - operands that are spatially adjacent become TREE-adjacent, so the
      per-tile subtree cull gates (ops.sdf._apply_static_tape `cull`) skip
      coherent clusters of leaves with one scalar branch each.

    Smooth blends and subtraction are order-dependent and pass through
    untouched (their children still rebalance internally).
    """
    if not instrs:
        return instrs
    centers = np.array([row[4:7] for _t, _rot, row in leaves], dtype=np.float64)
    codes = (
        _morton3(centers) if len(centers) else np.zeros(0, dtype=np.uint64)
    )

    # RPN -> tree. Node = ("leaf", ordinal) | (cop, k, child...) tuples.
    stack: list = []
    try:
        for cop, arg, k in instrs:
            if cop == oc.COP_PUSH:
                stack.append(("leaf", arg))
            elif cop in (oc.COP_ROUND, oc.COP_ONION):
                stack.append((cop, k, stack.pop()))
            else:
                b = stack.pop()
                a = stack.pop()
                stack.append((cop, k, a, b))
    except IndexError:
        raise ValueError("malformed tape: operator on empty stack") from None
    if len(stack) != 1:
        raise ValueError(f"malformed tape: final stack size {len(stack)}")
    root = stack[0]

    def min_leaf_code(node):
        if node[0] == "leaf":
            return codes[node[1]]
        return min(min_leaf_code(c) for c in node[2:])

    def flatten_chain(node, cop):
        if node[0] == cop:
            return flatten_chain(node[2], cop) + flatten_chain(node[3], cop)
        return [rebuild(node)]

    def rebuild(node):
        if node[0] == "leaf":
            return node
        if node[0] in (oc.COP_UNION, oc.COP_INTERSECTION):
            ops = flatten_chain(node[2], node[0]) + flatten_chain(
                node[3], node[0]
            )
            if len(ops) > 2:
                ops.sort(key=min_leaf_code)
                while len(ops) > 1:
                    ops = [
                        (node[0], 0.0, ops[i], ops[i + 1])
                        if i + 1 < len(ops)
                        else ops[i]
                        for i in range(0, len(ops), 2)
                    ]
                return ops[0]
            return (node[0], node[1], *ops)
        return (node[0], node[1], *(rebuild(c) for c in node[2:]))

    out: list[tuple[int, int, float]] = []

    def emit(node):
        if node[0] == "leaf":
            out.append((oc.COP_PUSH, node[1], 0.0))
            return
        for c in node[2:]:
            emit(c)
        out.append((node[0], 0, node[1]))

    emit(rebuild(root))
    return out


def compile_wire(
    tape: np.ndarray,
    *,
    bucket: bool = True,
    min_leaf_bucket: int = 2,
    min_instr_bucket: int = 8,
    stack_depth: Optional[int] = None,
    static: bool = False,
    rebalance: bool = True,
) -> tuple[TapeSpec, TapeArrays]:
    """Lower a wire tape to the two-phase device program.

    This is the runtime-edit path: graph edit -> new wire tape -> new
    TapeArrays; as long as the resulting TapeSpec is unchanged (bucketed
    capacities), the jitted renderer is reused with zero recompilation.

    `rebalance` (default) rewrites associative union/intersection chains as
    Morton-ordered balanced trees (see _rebalance_instrs) — exact, and
    required for effective subtree culling on many-primitive scenes.
    """
    leaves, instrs = _decode_wire(np.asarray(tape, dtype=np.uint32))
    if rebalance:
        instrs = _rebalance_instrs(instrs, leaves)

    # Group leaves by type (stable order within type), remember mapping.
    order = sorted(range(len(leaves)), key=lambda j: (leaves[j][0], j))
    leaf_row_of = {}  # original leaf ordinal -> packed row index
    counts = [0] * oc.NUM_LEAF_TYPES
    for j in order:
        counts[leaves[j][0]] += 1

    if bucket:
        caps = [0 if c == 0 else _next_pow2(c, min_leaf_bucket) for c in counts]
    else:
        caps = list(counts)

    starts = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    n_leaves = int(starts[-1]) if starts[-1] > 0 else 1

    leaf_params = np.zeros((n_leaves, oc.LEAF_PARAM_WIDTH), dtype=np.float32)
    leaf_params[:, 0] = 1.0  # identity quats everywhere (incl. padding)
    # Padding rows are harmless: r=0 spheres at origin / degenerate boxes;
    # they are only evaluated, never referenced by the tape.

    type_slices = []
    rotated_types = [0] * oc.NUM_LEAF_TYPES
    cursor = {t: int(starts[t]) for t in range(oc.NUM_LEAF_TYPES)}
    for j in order:
        t, rotated, row = leaves[j]
        r = cursor[t]
        cursor[t] = r + 1
        leaf_params[r] = row
        leaf_row_of[j] = r
        if rotated:
            rotated_types[t] = 1
    for t in range(oc.NUM_LEAF_TYPES):
        if caps[t] > 0:
            type_slices.append((t, int(starts[t]), int(starts[t]) + caps[t]))

    # Combine tape with precomputed stack slots.
    n_real = len(instrs)
    n_instr = _next_pow2(max(n_real, 1), min_instr_bucket) if bucket else max(n_real, 1)
    tape_ops = np.zeros(n_instr, dtype=np.int32)  # COP_NOP padding
    tape_arg = np.zeros(n_instr, dtype=np.int32)
    op_param = np.zeros(n_instr, dtype=np.float32)
    out_slot = np.zeros(n_instr, dtype=np.int32)

    depth = 0
    max_depth = 0
    for idx, (cop, arg, k) in enumerate(instrs):
        if cop == oc.COP_PUSH:
            slot = depth
            depth += 1
        elif cop in (oc.COP_ROUND, oc.COP_ONION):
            if depth < 1:
                raise ValueError("malformed tape: unary op on empty stack")
            slot = depth - 1
        else:
            if depth < 2:
                raise ValueError("malformed tape: binary op needs two operands")
            slot = depth - 2
            depth -= 1
        max_depth = max(max_depth, depth)
        tape_ops[idx] = cop
        tape_arg[idx] = leaf_row_of[arg] if cop == oc.COP_PUSH else 0
        op_param[idx] = k
        out_slot[idx] = slot
    if n_real and depth != 1:
        raise ValueError(f"malformed tape: final stack depth {depth} != 1")

    # Bucket from 2 (not 8): the dynamic-tape interpreter's register stack
    # pays one vector select per slot per instruction, and rebalanced chains
    # need only ~log2(leaves) slots — a deep-bucket default would triple the
    # select chains for typical scenes.
    sd = stack_depth if stack_depth is not None else _next_pow2(max(max_depth, 1), 2)
    # NOP padding writes to the top scratch slot so it can never clobber live
    # values; the result always lives in slot 0.
    out_slot[n_real:] = sd - 1

    static_tape = None
    if static:
        static_tape = tuple(
            (int(tape_ops[i]), int(tape_arg[i]), int(out_slot[i]))
            for i in range(n_real)
        )

    # Macro stream for the Pallas dynamic-tape interpreter; bucketed like the
    # instruction stream so topology edits stay recompile-free. The bucket
    # floor is half the instruction floor (a macro covers >= ~2 instructions
    # for typical trees), keeping the macro bucket stable across the same
    # class of small structural edits the instruction bucket absorbs.
    _mo, _ma, _ms, n_macro_real, slot0 = macroize_streams(
        tape_ops, tape_arg, out_slot, n_real
    )
    n_macro = (
        _next_pow2(max(n_macro_real, 1), max(min_instr_bucket // 2, 1))
        if bucket
        else max(n_macro_real, 1)
    )
    macro_ops, macro_arg, macro_slotk, _, _ = macroize_streams(
        tape_ops, tape_arg, out_slot, n_real, n_macro=n_macro
    )

    spec = TapeSpec(
        type_slices=tuple(type_slices),
        n_leaves=n_leaves,
        n_instr=n_instr,
        stack_depth=sd,
        rotated_types=tuple(rotated_types),
        static_tape=static_tape,
        has_materials=bool(leaf_params[:, oc.LEAF_MAT_FLAG].any()),
        n_macro=n_macro,
        macro_slot0=slot0,
    )
    arrays = TapeArrays(
        leaf_params=leaf_params,
        tape_ops=tape_ops,
        tape_arg=tape_arg,
        op_param=op_param,
        out_slot=out_slot,
        macro_ops=macro_ops,
        macro_arg=macro_arg,
        macro_slotk=macro_slotk,
    )
    return spec, arrays


def arrays_from_streams(
    spec: TapeSpec,
    leaf_params,
    tape_ops,
    tape_arg,
    op_param,
    out_slot,
) -> TapeArrays:
    """Rebuild TapeArrays from serialized instruction streams (checkpoint
    restore): the macro streams are DERIVED state, so they are recomputed
    here rather than stored — one source of truth."""
    tape_ops = np.asarray(tape_ops)
    n_real = int(np.count_nonzero(tape_ops))  # real instrs are never COP_NOP
    macro_ops, macro_arg, macro_slotk, _, _ = macroize_streams(
        tape_ops, tape_arg, out_slot, n_real, n_macro=spec.n_macro
    )
    return TapeArrays(
        leaf_params=leaf_params,
        tape_ops=tape_ops,
        tape_arg=np.asarray(tape_arg),
        op_param=np.asarray(op_param),
        out_slot=np.asarray(out_slot),
        macro_ops=macro_ops,
        macro_arg=macro_arg,
        macro_slotk=macro_slotk,
    )


def compile_scene(
    scene: Optional[csg.CSGNode], **kwargs
) -> tuple[TapeSpec, TapeArrays]:
    """Scene DSL -> device program (via the wire tape, so both encodings
    always agree by construction)."""
    return compile_wire(encode_wire(scene), **kwargs)


def from_reference(spec, arrays) -> tuple[TapeSpec, TapeArrays]:
    """The JAX package's (`TapeSpec`, `TapeArrays`) -> this module's.

    Duck-typed: reads the fields by name and converts the arrays with
    `np.asarray`, so it never imports the JAX package. This is how one scene
    (its parameters are this system's weights) is handed to both packages.
    """
    fields = {}
    for f in dataclasses.fields(TapeSpec):
        v = getattr(spec, f.name)
        if f.name == "static_tape" and v is not None:
            v = tuple(tuple(int(x) for x in ins) for ins in v)
        elif f.name in ("type_slices",):
            v = tuple(tuple(int(x) for x in sl) for sl in v)
        elif f.name == "rotated_types":
            v = tuple(int(x) for x in v)
        fields[f.name] = v
    dtypes = {"leaf_params": np.float32, "op_param": np.float32}
    arr = {
        f.name: np.array(getattr(arrays, f.name), dtype=dtypes.get(f.name, np.int32))
        for f in dataclasses.fields(TapeArrays)
    }
    return TapeSpec(**fields), TapeArrays(**arr)
