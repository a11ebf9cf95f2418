"""Wire-tape opcode ABI and the internal combine-phase instruction set.

Wire tape = the flat u32 command stream uploaded at runtime, the direct
analogue of the reference's `CSGCommandBufferBuilder` output
(reference src/ray_marching/csg/builder.rs:2-24,41-61). Numbering is kept
ABI-compatible with the reference where the reference defines it
(Sphere=0, Box=1, Union=100, Subtraction=101) and extends the reserved
slots the same way the reference's commented-out roadmap does
(Plane=2, Intersection=102). Parameters follow their opcode in the stream
as bit-cast f32 words, exactly like the reference.

Combine-phase opcodes (COP_*) are internal to the two-phase device program
(see raymarch_tpu_torch.ops.tape): phase 1 evaluates all primitive *leaves*
vectorized by type; phase 2 runs a short data-driven tape of combine ops
over the leaf-distance matrix with compile-time-precomputed stack slots.
"""

from __future__ import annotations

# --- Wire opcodes: primitives (reference ABI + extensions) -----------------
OP_SPHERE = 0  # center vec3, radius           (reference builder.rs:6)
OP_BOX = 1  # center vec3, half_extents vec3   (reference builder.rs:7)
OP_PLANE = 2  # normal vec3, offset            (reserved, builder.rs:8)
OP_TORUS = 3  # center vec3, major_r, minor_r  (extension)
OP_CYLINDER = 4  # center vec3, radius, half_height (y-axis; extension)
OP_CAPSULE = 5  # center vec3, radius, half_height (y-axis; extension)
OP_CONE = 6  # center vec3, half_height, r_bottom, r_top (y-axis; extension)

# Rotated primitive variants (extension): quat(w,x,y,z) precedes base params;
# numbering convention: rotated = base + 10.
OP_BOX_ROT = 11  # quat vec4, center vec3, half_extents vec3
OP_TORUS_ROT = 13  # quat vec4, center vec3, major_r, minor_r
OP_CYLINDER_ROT = 14  # quat vec4, center vec3, radius, half_height
OP_CAPSULE_ROT = 15  # quat vec4, center vec3, radius, half_height
OP_CONE_ROT = 16  # quat vec4, center vec3, half_height, r_bottom, r_top

# --- Wire opcodes: binary operations ---------------------------------------
OP_UNION = 100  # min(a,b)                     (reference builder.rs:12)
OP_SUBTRACTION = 101  # max(a,-b)              (reference builder.rs:13)
OP_INTERSECTION = 102  # max(a,b)              (reserved, builder.rs:14)
OP_SMOOTH_UNION = 110  # k
OP_SMOOTH_SUBTRACTION = 111  # k
OP_SMOOTH_INTERSECTION = 112  # k

# --- Wire opcodes: unary operations ----------------------------------------
OP_ROUND = 120  # radius
OP_ONION = 121  # thickness

# --- Wire opcodes: attributes ----------------------------------------------
# Postfix attribute: attaches an albedo (r,g,b) to the most recently emitted
# primitive. The reference's README lists a material system as roadmap
# (reference README.md:10, unchecked); this extends the wire ABI in the same
# reserved-numbering style the reference uses. Scenes without materials emit
# byte-identical tapes to before.
OP_MATERIAL = 130  # albedo vec3

PRIMITIVE_OPS = (
    OP_SPHERE,
    OP_BOX,
    OP_PLANE,
    OP_TORUS,
    OP_CYLINDER,
    OP_CAPSULE,
    OP_CONE,
    OP_BOX_ROT,
    OP_TORUS_ROT,
    OP_CYLINDER_ROT,
    OP_CAPSULE_ROT,
    OP_CONE_ROT,
)
BINARY_OPS = (
    OP_UNION,
    OP_SUBTRACTION,
    OP_INTERSECTION,
    OP_SMOOTH_UNION,
    OP_SMOOTH_SUBTRACTION,
    OP_SMOOTH_INTERSECTION,
)
UNARY_OPS = (OP_ROUND, OP_ONION)

# Number of f32 params following each wire opcode.
WIRE_PARAM_COUNT = {
    OP_SPHERE: 4,
    OP_BOX: 6,
    OP_PLANE: 4,
    OP_TORUS: 5,
    OP_CYLINDER: 5,
    OP_CAPSULE: 5,
    OP_CONE: 6,
    OP_BOX_ROT: 10,
    OP_TORUS_ROT: 9,
    OP_CYLINDER_ROT: 9,
    OP_CAPSULE_ROT: 9,
    OP_CONE_ROT: 10,
    OP_UNION: 0,
    OP_SUBTRACTION: 0,
    OP_INTERSECTION: 0,
    OP_SMOOTH_UNION: 1,
    OP_SMOOTH_SUBTRACTION: 1,
    OP_SMOOTH_INTERSECTION: 1,
    OP_ROUND: 1,
    OP_ONION: 1,
    OP_MATERIAL: 3,
}

# --- Leaf type ids (phase-1 banks, grouped by type) ------------------------
LEAF_SPHERE = 0
LEAF_BOX = 1
LEAF_PLANE = 2
LEAF_TORUS = 3
LEAF_CYLINDER = 4
LEAF_CAPSULE = 5
LEAF_CONE = 6
NUM_LEAF_TYPES = 7
# Device leaf parameter row layout, f32[LEAF_PARAM_WIDTH]:
#   [0:4]   quat (w,x,y,z), identity for unrotated leaves
#   [4:7]   center / translation
#   [7:12]  primitive params:
#     sphere:   radius @7
#     box:      half_extents @7:10
#     plane:    normal @7:10, offset @10
#     torus:    major_r @7, minor_r @8
#     cylinder: radius @7, half_height @8   (y-axis)
#     capsule:  radius @7, half_height @8   (y-axis segment)
#     cone:     half_height @7, r_bottom @8, r_top @9  (y-axis, capped)
#   [12:15] material albedo (r,g,b); differentiable like the geometry
#   [15]    material flag: 1.0 = leaf carries a material, 0.0 = use the
#           config default albedo (reference wgsl:103)
LEAF_PARAM_WIDTH = 16
LEAF_ALBEDO = 12  # slice start
LEAF_MAT_FLAG = 15

# --- Combine-phase instruction set -----------------------------------------
COP_NOP = 0  # padding; writes stack[slot] back unchanged
COP_PUSH = 1  # stack[slot] = leaf_dist[arg]
COP_UNION = 2  # stack[slot] = min(stack[slot], stack[slot+1])
COP_INTERSECTION = 3  # max(a, b)
COP_SUBTRACTION = 4  # max(a, -b)
COP_SMOOTH_UNION = 5  # smin(a, b, k)
COP_SMOOTH_INTERSECTION = 6  # smax(a, b, k)
COP_SMOOTH_SUBTRACTION = 7  # smax(a, -b, k)
COP_ROUND = 8  # stack[slot] = stack[slot] - r
COP_ONION = 9  # stack[slot] = |stack[slot]| - t
NUM_COPS = 10
# (A fused PUSH+binary instruction set was prototyped to halve the dynamic
# interpreter's dispatch count and measured SLOWER on TPU — Mosaic's switch
# lowering pays per-branch, so wider dispatch tables cost more than the
# instructions they save. Kept out deliberately.)
