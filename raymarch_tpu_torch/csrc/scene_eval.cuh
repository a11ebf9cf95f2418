// Scene distance on the device: a run-time interpreter of the combine tape
// (static, or with DYN the dynamic tape of the frame's arrays) over the leaf
// parameter bank.
//
// Replaces the static branch of raymarch_tpu/ops/pallas_march.py:
// _make_scene_eval (685-707), which unrolls sdf._apply_static_tape over
// _leaf_distance_tile (63-133) at trace time, once per TapeSpec. Here one
// build serves every scene: the tape (postorder, stack slots precomputed at
// compile time, ops/tape.py) is read at run time. Every thread of a launch
// reads the same instruction, so the switch below is uniform across a warp;
// only the leaf math diverges, and it is straight-line.
//
// Numerics follow the Pallas kernels: the `+1e-20` inside every sqrt, the
// inverse-quaternion rotation q* p q, the smooth-min of ops/sdf.py:47-52 and
// the f32 op order of each formula. Build without --use_fast_math: sqrtf and
// the divisions here must be IEEE-rounded.
#pragma once

#include <cuda_runtime.h>

namespace rmt {

// Combine-phase opcodes (ops/opcodes.py COP_*).
constexpr int COP_NOP = 0;
constexpr int COP_PUSH = 1;
constexpr int COP_UNION = 2;
constexpr int COP_INTERSECTION = 3;
constexpr int COP_SUBTRACTION = 4;
constexpr int COP_SMOOTH_UNION = 5;
constexpr int COP_SMOOTH_INTERSECTION = 6;
constexpr int COP_SMOOTH_SUBTRACTION = 7;
constexpr int COP_ROUND = 8;
constexpr int COP_ONION = 9;

// Leaf types (ops/opcodes.py LEAF_*) and the bank row width.
constexpr int LEAF_SPHERE = 0;
constexpr int LEAF_BOX = 1;
constexpr int LEAF_PLANE = 2;
constexpr int LEAF_TORUS = 3;
constexpr int LEAF_CYLINDER = 4;
constexpr int LEAF_CAPSULE = 5;
constexpr int LEAF_CONE = 6;
constexpr int LEAF_PARAM_WIDTH = 16;
// row_kind = leaf_type | ROTATED_BIT when the row's type carries rotations.
constexpr int ROTATED_BIT = 256;

// The deepest value stack of a tape (RenderConfig.stack_depth, the
// reference's 32, wgsl:173): the stacks of K8's recorded passes
// (scene_grad.cuh). The Python wrapper refuses deeper tapes.
constexpr int MAX_STACK = 32;

// The scene as the compact backward K9 reads it (compact_bwd.cu,
// make_scene): the tape's three i32 arrays and the leaf rows.
struct SceneView {
  const float* leaf_params;  // f32[n_leaves, 16]
  const int* row_kind;       // i32[n_leaves]
  const int* tape_ops;       // i32[n_instr]   COP_*
  const int* tape_arg;       // i32[n_instr]   leaf row of a PUSH
  const int* out_slot;       // i32[n_instr]   stack slot written
  const float* op_param;     // f32[>= n_instr] blend / round / onion radius
  int n_instr;               // real instructions; 0 = empty scene
  float max_dist;            // the empty scene's distance
};

__device__ __forceinline__ float smooth_min(float a, float b, float k) {
  k = fmaxf(k, 1e-8f);
  const float h = fmaxf(k - fabsf(a - b), 0.0f) / k;
  return fminf(a, b) - h * h * k * 0.25f;
}

// A leaf row is 16 words in four quads: words 0-3 the quaternion (w, x, y,
// z), 4-6 the centre and 7-11 the type's parameters. leaf_distance takes a
// quad before it needs its words; the row reader decides what that costs.
// K8 and K9 (the rows of K8's packed tape and of SceneView) read each word
// where it is used...
struct RowWords {
  static constexpr bool QUADS = false;
  const float* P;
  struct Quad {
    const float* P;  // the row
    int q;           // the quad
    __device__ __forceinline__ float operator[](int k) const {
      return __ldg(P + (4 * q + k));
    }
  };
  __device__ __forceinline__ Quad quad(int q) const { return Quad{P, q}; }
};

// ...K1-K7 (SceneWords' float4 rows) read the whole quad, in
// one 16-byte load, where it is taken.
struct RowQuads {
  static constexpr bool QUADS = true;
  const float4* P;
  struct Quad {
    float4 v;
    __device__ __forceinline__ float operator[](int k) const {
      return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    }
  };
  __device__ __forceinline__ Quad quad(int q) const {
    return Quad{__ldg(P + q)};
  }
};

// The distance of a leaf row at p: every primitive's formula, once, for
// both row readers.
template <class Row>
__device__ __forceinline__ float leaf_distance(const Row& R, int kind,
                                               float px, float py, float pz) {
  const int type = kind & (ROTATED_BIT - 1);
  const auto c = R.quad(1);  // the centre, then the first parameter
  float x = px - c[0];
  float y = py - c[1];
  float z = pz - c[2];
  if (kind & ROTATED_BIT) {
    // Inverse-rotate by the unit quaternion (w,x,y,z):
    // t = 2 (u x v); v' = v + w t + u x t with u = -q.xyz.
    const auto q = R.quad(0);
    const float qw = q[0];
    const float qx = -q[1];
    const float qy = -q[2];
    const float qz = -q[3];
    const float tx = 2.0f * (qy * z - qz * y);
    const float ty = 2.0f * (qz * x - qx * z);
    const float tz = 2.0f * (qx * y - qy * x);
    const float x2 = x + qw * tx + (qy * tz - qz * ty);
    const float y2 = y + qw * ty + (qz * tx - qx * tz);
    const float z2 = z + qw * tz + (qx * ty - qy * tx);
    x = x2;
    y = y2;
    z = z2;
  }
  // A reader of whole quads skips the parameter quad of a sphere (the
  // same formula as the switch's first case).
  if constexpr (Row::QUADS) {
    if (type == LEAF_SPHERE)
      return sqrtf(x * x + y * y + z * z + 1e-20f) - c[3];
  }
  const auto e = R.quad(2);  // the next four parameters
  switch (type) {
    case LEAF_SPHERE:
      return sqrtf(x * x + y * y + z * z + 1e-20f) - c[3];
    case LEAF_BOX: {
      const float qx = fabsf(x) - c[3];
      const float qy = fabsf(y) - e[0];
      const float qz = fabsf(z) - e[1];
      const float ox = fmaxf(qx, 0.0f);
      const float oy = fmaxf(qy, 0.0f);
      const float oz = fmaxf(qz, 0.0f);
      const float outside = sqrtf(ox * ox + oy * oy + oz * oz + 1e-20f);
      const float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);
      return outside + inside;
    }
    case LEAF_PLANE: {
      // World-space plane: the center and rotation are folded at compile
      // time.
      return px * c[3] + py * e[0] + pz * e[1] + e[2];
    }
    case LEAF_TORUS: {
      const float ring = sqrtf(x * x + z * z + 1e-20f) - c[3];
      return sqrtf(ring * ring + y * y + 1e-20f) - e[0];
    }
    case LEAF_CYLINDER: {
      const float qx = sqrtf(x * x + z * z + 1e-20f) - c[3];
      const float qy = fabsf(y) - e[0];
      const float ox = fmaxf(qx, 0.0f);
      const float oy = fmaxf(qy, 0.0f);
      return sqrtf(ox * ox + oy * oy + 1e-20f) + fminf(fmaxf(qx, qy), 0.0f);
    }
    case LEAF_CAPSULE: {
      const float h = e[0];
      const float yy = y - fminf(fmaxf(y, -h), h);
      return sqrtf(x * x + yy * yy + z * z + 1e-20f) - c[3];
    }
    case LEAF_CONE: {
      const float h = c[3];
      const float r1 = e[0];
      const float r2 = e[1];
      const float qx = sqrtf(x * x + z * z + 1e-20f);
      const float k2x = r2 - r1;
      const float k2y = 2.0f * h;
      const float cax = qx - fminf(qx, y < 0.0f ? r1 : r2);
      const float cay = fabsf(y) - h;
      const float denom = fmaxf(k2x * k2x + k2y * k2y, 1e-20f);
      const float tt =
          fminf(fmaxf(((r2 - qx) * k2x + (h - y) * k2y) / denom, 0.0f), 1.0f);
      const float cbx = qx - r2 + k2x * tt;
      const float cby = y - h + k2y * tt;
      const float s = (cbx < 0.0f && cay < 0.0f) ? -1.0f : 1.0f;
      return s * sqrtf(fminf(cax * cax + cay * cay, cbx * cbx + cby * cby) +
                       1e-20f);
    }
    default:
      return __int_as_float(0x7fc00000);  // unknown type: NaN, never silent
  }
}

__device__ __forceinline__ float leaf_distance(const float* __restrict__ P,
                                               int kind, float px, float py,
                                               float pz) {
  return leaf_distance(RowWords{P}, kind, px, py, pz);
}

// Distance substituted for a culled leaf (ops/culling.py FAR).
constexpr float CULL_FAR = 1.0e4f;

// True when bit `row` of a tile's packed leaf mask is set.
__device__ __forceinline__ bool mask_bit(const int* __restrict__ mask,
                                         int row) {
  return ((__ldg(mask + (row >> 5)) >> (row & 31)) & 1) != 0;
}

// Leaf-row words of the material (ops/opcodes.py LEAF_ALBEDO, LEAF_MAT_FLAG).
constexpr int LEAF_ALBEDO = 12;
constexpr int LEAF_MAT_FLAG = 15;

// Winner weight of operand a in a smooth blend (sdf._mat_weight_smooth):
// the material field is continuous exactly where the distance blend is.
__device__ __forceinline__ float mat_weight_smooth(float da, float db,
                                                  float k) {
  k = fmaxf(k, 1e-8f);
  return fminf(fmaxf(0.5f + 0.5f * (db - da) / k, 0.0f), 1.0f);
}

// Per-tile culling of one kernel's tile grid (ops/cuda_prepass.py:TileCull,
// mirrored field by field by _CCull). mode 0: no culling; 1: the compact
// plan's per-tile item lists; 2: the gated tape (per-tile leaf masks).
struct CullView {
  const int* lists;   // i32[T, n_items]: each group's active entries first
  const int* counts;  // i32[T, n_counts]: active entries per group
  const int* masks;   // i32[T, n_words]: packed active-leaf bits
  const int* prog;    // i32[n_prog, 4]: group offset, count index, source
                      // (0 pool, 1 seg1 chain, 2 stream), ordered flag
  int mode;
  int tile;  // tile side, pixels
  int n_tx;  // tiles per row of the grid
  int n_items;
  int n_counts;
  int n_words;
  int n_prog;
};

// Tile of the pixel (band row i, column j) in a grid of `tile`-pixel tiles.
__device__ __forceinline__ int tile_of(const CullView& cv, int i, int j) {
  return (i / cv.tile) * cv.n_tx + j / cv.tile;
}

// One ordered fold step of a compact entry (pallas_march.py:571-586):
// mode 0 min(acc, d), 1 smooth_min(acc, d, k), 2 max(acc, -d),
// 3 smooth_max(acc, -d, k); entry = row | tsel<<10 | mode<<13 | sid<<15 |
// (kidx+1)<<18, k = op_param[kidx] clamped at 1e-8.
__device__ __forceinline__ float fold_step(const float* __restrict__ op_param,
                                           float acc, int e, float dv) {
  const int mode = (e >> 13) & 3;
  const int ki = e >> 18;
  const float kp = __ldg(op_param + (ki - 1 > 0 ? ki - 1 : 0));
  const float kk = fmaxf(kp, 1e-8f);
  const bool is_sub = mode >= 2;
  const float hard = is_sub ? fmaxf(acc, -dv) : fminf(acc, dv);
  if ((mode & 1) == 0) return hard;
  const float diff = is_sub ? acc + dv : acc - dv;
  const float h = fmaxf(kk - fabsf(diff), 0.0f) / kk;
  const float corr = h * h * kk * 0.25f;
  return is_sub ? hard + corr : hard - corr;
}
__device__ __forceinline__ float fold_step(const SceneView& sc, float acc,
                                           int e, float dv) {
  return fold_step(sc.op_param, acc, e, dv);
}

__device__ __forceinline__ float entry_distance(const SceneView& sc, int row,
                                                float px, float py, float pz) {
  return leaf_distance(sc.leaf_params + row * LEAF_PARAM_WIDTH,
                       __ldg(sc.row_kind + row), px, py, pz);
}

// The scene distance through a tile's compacted item lists: the free pool's
// min folds, the seg1 chain (free prefix groups, then its ordered fold), and
// each stream group (ordered folds flushed into the running min at each
// segment-id change). Replaces pallas_march.py:_make_scene_eval_compact
// (493-660) for plans with no residual subtrees (those take the gated
// tape). Loops run the tile's active counts: O(active leaves) per point.
// leaf(row) is the distance of leaf row `row` at the point.
template <class Leaf>
__device__ __forceinline__ float compact_fold(const Leaf& leaf,
                                              const float* __restrict__ op_param,
                                              const CullView& cv, int tile) {
  const int* lst = cv.lists + (size_t)tile * cv.n_items;
  const int* cnt = cv.counts + (size_t)tile * cv.n_counts;
  float d = CULL_FAR;
  float chain = CULL_FAR;
  bool has_chain = false;
  for (int g = 0; g < cv.n_prog; ++g) {
    const int off = __ldg(cv.prog + 4 * g + 0);
    const int n = __ldg(cnt + __ldg(cv.prog + 4 * g + 1));
    const int source = __ldg(cv.prog + 4 * g + 2);
    const bool ordered = __ldg(cv.prog + 4 * g + 3) != 0;
    if (source == 0) {  // free pool
      for (int j = 0; j < n; ++j) d = fminf(d, leaf(__ldg(lst + off + j)));
    } else if (source == 1) {  // the seg1 chain
      has_chain = true;
      for (int j = 0; j < n; ++j) {
        const int e = __ldg(lst + off + j);
        const float dv = leaf(e & 1023);
        chain = ordered ? fold_step(op_param, chain, e, dv) : fminf(chain, dv);
      }
    } else {  // one stream group
      float acc_out = d, acc_seg = CULL_FAR;
      int prev = -1;
      for (int j = 0; j < n; ++j) {
        const int e = __ldg(lst + off + j);
        const int sid = (e >> 15) & 7;
        if (sid != prev) {
          acc_out = fminf(acc_out, acc_seg);
          acc_seg = CULL_FAR;
        }
        acc_seg = fold_step(op_param, acc_seg, e, leaf(e & 1023));
        prev = sid;
      }
      d = fminf(acc_out, acc_seg);
    }
  }
  return has_chain ? fminf(d, chain) : d;
}

// The kernels' MODE template parameter: the culling mode (CullView::mode)
// of a static tape, 0 none, 1 the compact plan's item lists, 2 the gated
// tape; and MODE 3 and 4, the DYN builds of modes 0 and 2, which interpret
// the frame's dynamic tape (words_distance<true>), un-culled or gated by the
// tile's leaf mask. A dynamic tape has no compact plan (build_compact_plan
// returns None for it, as the reference's does: pallas_march.py:279-280),
// so no build reads item lists of one.
__host__ __device__ constexpr bool mode_dyn(int mode) { return mode >= 3; }
// The point's tile matters: the kernel reads its lists or its leaf mask.
__host__ __device__ constexpr bool mode_culled(int mode) {
  return mode == 1 || mode == 2 || mode == 4;
}

// ---------------------------------------------------------------------------
// The scene evaluator of K1, K2 (coarse_kernel, fine_kernel, every build),
// K3 (coarse_px_kernel), K4 (fine_unpacked_kernel) and K5-K7 (march.cuh
// march_kernel, every build): packed scene words and a value stack kept out
// of local memory.
//
// Each instruction is one 16-byte word, the format of the backwards' packed
// tape (scene_grad.cuh BwdTape; ops/cuda_march.py pack_words): op | slot <<
// 8, the leaf row of a PUSH, the row's kind, and a word the forward does not
// read. A leaf row is read as float4s (a row is 64 bytes, 64-byte aligned):
// only those its type uses. The tape is postorder with slot = stack depth
// (compile_wire), so the interpreter keeps the top of the value stack in a
// register and the slots below it in a store: a PUSH at slot s spills the
// old top to slot s - 1, a binary op at slot s reads slot s and the top, a
// unary op touches the top alone. Every lane reads the same word, so every
// branch on it is warp-uniform. Leaves are evaluated at their PUSH, as the
// static unroll does; the operations and their order are the plain
// versions' (sdf._apply_static_tape, _apply_dynamic_tape), so that a build
// without FMA contraction rounds as they do.

// The value stack's route (ops/cuda_march.py stack_route), the STK template
// parameter of the K1-K7 builds: a tape of stack depth <= REG_STACK keeps
// the slot below its top in a register (STK = REG_STACK), a deeper one
// (STK_SMEM) the slots below its top in shared memory, one column per
// thread: slot s of thread k at [s * threads + k], 4 * (depth - 1) *
// threads bytes a block, four times that for the colour walk's four
// stacks. Measured on the H100 (PERF.md): at depths 4 and 8 shared memory
// beat a register file selected by the warp-uniform slot (by unrolled
// compares, or shifted on every push and pop) and the local-memory stack;
// at depth 2 the register beat shared memory by 2-4% (K1 and K2 at the
// headline), and one build for every depth, slot 0 in a register and a
// warp-uniform branch on the slot, lost 7-15% to the two routes.
constexpr int REG_STACK = 2;
constexpr int STK_SMEM = 0;

struct SceneWords {
  const int4* ins;        // [n]: op | slot << 8, leaf row, row kind, unread
  const float4* leaf;     // [n_leaves * 4]: the leaf rows
  const int* row_kind;    // [n_leaves]: for the compact item lists
  const float* op_param;  // [>= n]
  int n;                  // instructions (a dynamic tape's bucket); 0 = empty
  int rows;               // STK_SMEM: stack slots below the top, per thread
  float max_dist;         // the empty scene's distance
};

// The slot below the top in a register (a stack of depth <= REG_STACK has
// one).
struct RegSlot {
  float v;
  __device__ __forceinline__ float get(int) const { return v; }
  __device__ __forceinline__ void put(int, float x) { v = x; }
};

// The slots below the top in the block's dynamic shared memory.
struct SmemSlots {
  float* base;  // this thread's slot 0
  int stride;   // the block's threads
  __device__ __forceinline__ float get(int s) const { return base[s * stride]; }
  __device__ __forceinline__ void put(int s, float x) const {
    base[s * stride] = x;
  }
};

// Stack `k` (0 the distance, 1-3 the colour walk's r, g, b) of route STK.
template <int STK>
__device__ __forceinline__ auto stack_slots(const SceneWords& sw, int k) {
  if constexpr (STK == STK_SMEM) {
    extern __shared__ float rmt_stack[];
    const int stride = blockDim.x * blockDim.y;
    return SmemSlots{rmt_stack + (size_t)k * sw.rows * stride +
                         threadIdx.y * blockDim.x + threadIdx.x,
                     stride};
  } else {
    RegSlot reg;  // written before it is read
    return reg;
  }
}

// Dynamic shared memory of route STK's stack columns for a block of
// `threads`: rows slots a thread, four stacks for the colour walk (MATS).
template <bool MATS, int STK>
__host__ __device__ inline size_t stack_smem_bytes(const SceneWords& sw,
                                                   int threads) {
  if (STK != STK_SMEM) return 0;
  return (size_t)sw.rows * threads * sizeof(float) * (MATS ? 4 : 1);
}

// The distance from p to the scene over the packed words on route STK.
// DYN reads the frame's dynamic tape (compile_scene(static=False)),
// NOP-padded to its bucket: as in the reference's interpreter
// (sdf.py:523-527) the top starts at max_dist, so that an all-NOP tape is
// the empty scene, and a NOP is skipped. With a tile mask (the gated tape
// of a culled frame) a leaf whose bit is clear reads CULL_FAR instead of
// its distance: exact for hits, shading and the escape test by the lemma
// of ops/culling.py.
template <bool DYN, int STK>
__device__ __forceinline__ float words_distance(const SceneWords& sw, float px,
                                                float py, float pz,
                                                const int* mask = nullptr) {
  auto below = stack_slots<STK>(sw, 0);
  float top = sw.max_dist;
  for (int i = 0; i < sw.n; ++i) {
    const int4 w = __ldg(sw.ins + i);
    const int op = w.x & 0xff;
    if constexpr (DYN) {
      if (op == COP_NOP) continue;
    }
    const int s = w.x >> 8;
    if (op == COP_PUSH) {
      const float d = (mask != nullptr && !mask_bit(mask, w.y))
                          ? CULL_FAR
                          : leaf_distance(RowQuads{sw.leaf + 4 * w.y}, w.z, px,
                                          py, pz);
      if (s > 0) below.put(s - 1, top);
      top = d;
      continue;
    }
    const float k = op >= COP_SMOOTH_UNION ? __ldg(sw.op_param + i) : 0.0f;
    if (op == COP_ROUND || op == COP_ONION) {
      top = (op == COP_ROUND ? top : fabsf(top)) - k;
      continue;
    }
    const float a = below.get(s);
    switch (op) {
      case COP_UNION:
        top = fminf(a, top);
        break;
      case COP_INTERSECTION:
        top = fmaxf(a, top);
        break;
      case COP_SUBTRACTION:
        top = fmaxf(a, -top);
        break;
      case COP_SMOOTH_UNION:
        top = smooth_min(a, top, k);
        break;
      case COP_SMOOTH_INTERSECTION:
        top = -smooth_min(-a, -top, k);
        break;
      case COP_SMOOTH_SUBTRACTION:
        top = -smooth_min(-a, top, k);
        break;
      default:  // COP_NOP never appears in a static tape
        break;
    }
  }
  return top;
}

// The scene distance at p, and in rgb the albedo the tape carries to it,
// over the packed words, its four stacks on route STK: the static branch of
// pallas_march.py:_make_scene_color_eval (893-909,
// sdf._apply_static_tape_color). A leaf's colour is its own albedo where
// its material flag is set, else def (the config albedo); hard ops take
// the winner's colour by the tie rule of oracle.eval_tape_color (union
// a <= b, intersection a >= b, subtraction a >= -b), smooth ops blend the
// two by mat_weight_smooth, round and onion keep their operand's. With a
// tile mask a culled leaf reads CULL_FAR with the default colour. The
// kernels call it once per hit ray, not per march step. DYN as in
// words_distance: the top starts at (max_dist, def) and a NOP is skipped
// (sdf._apply_dynamic_tape_color).
template <bool DYN, int STK>
__device__ __forceinline__ float words_color(const SceneWords& sw, float px,
                                             float py, float pz,
                                             const float* def, float rgb[3],
                                             const int* mask = nullptr) {
  auto bd = stack_slots<STK>(sw, 0);
  auto br = stack_slots<STK>(sw, 1);
  auto bg = stack_slots<STK>(sw, 2);
  auto bb = stack_slots<STK>(sw, 3);
  float td = sw.max_dist, tr = def[0], tg = def[1], tb = def[2];
  for (int i = 0; i < sw.n; ++i) {
    const int4 w = __ldg(sw.ins + i);
    const int op = w.x & 0xff;
    if constexpr (DYN) {
      if (op == COP_NOP) continue;
    }
    const int s = w.x >> 8;
    if (op == COP_PUSH) {
      float d, r = def[0], g = def[1], b = def[2];
      if (mask != nullptr && !mask_bit(mask, w.y)) {
        d = CULL_FAR;
      } else {
        const float4* P = sw.leaf + 4 * w.y;
        d = leaf_distance(RowQuads{P}, w.z, px, py, pz);
        const float4 al = __ldg(P + 3);  // albedo, material flag
        const float fl = al.w;
        r = fl * al.x + (1.0f - fl) * def[0];
        g = fl * al.y + (1.0f - fl) * def[1];
        b = fl * al.z + (1.0f - fl) * def[2];
      }
      if (s > 0) {
        bd.put(s - 1, td);
        br.put(s - 1, tr);
        bg.put(s - 1, tg);
        bb.put(s - 1, tb);
      }
      td = d;
      tr = r;
      tg = g;
      tb = b;
      continue;
    }
    const float k = op >= COP_SMOOTH_UNION ? __ldg(sw.op_param + i) : 0.0f;
    if (op == COP_ROUND || op == COP_ONION) {
      td = (op == COP_ROUND ? td : fabsf(td)) - k;
      continue;
    }
    const float a = bd.get(s), b = td;
    float r, wt;
    switch (op) {
      case COP_UNION:
        r = fminf(a, b);
        wt = a <= b ? 1.0f : 0.0f;
        break;
      case COP_INTERSECTION:
        r = fmaxf(a, b);
        wt = a >= b ? 1.0f : 0.0f;
        break;
      case COP_SUBTRACTION:
        r = fmaxf(a, -b);
        wt = a >= -b ? 1.0f : 0.0f;
        break;
      case COP_SMOOTH_UNION:
        r = smooth_min(a, b, k);
        wt = mat_weight_smooth(a, b, k);
        break;
      case COP_SMOOTH_INTERSECTION:
        r = -smooth_min(-a, -b, k);
        wt = mat_weight_smooth(b, a, k);
        break;
      case COP_SMOOTH_SUBTRACTION:
        r = -smooth_min(-a, b, k);
        wt = mat_weight_smooth(-b, a, k);
        break;
      default:  // COP_NOP never appears in a static tape
        continue;
    }
    td = r;
    tr = wt * br.get(s) + (1.0f - wt) * tr;
    tg = wt * bg.get(s) + (1.0f - wt) * tg;
    tb = wt * bb.get(s) + (1.0f - wt) * tb;
  }
  rgb[0] = tr;
  rgb[1] = tg;
  rgb[2] = tb;
  return td;
}

// The scene function of a K1/K2/K4 thread at points of pixel tile `tile`
// under MODE, on stack route STK: the compact item lists over float4 leaf
// rows (MODE 1), else the packed words, gated by the tile's leaf mask in
// MODE 2 and 4. color() is the hit point's colour walk (gated under any
// culling, as the reference's colour pass is). The flat march kernels
// K5-K7 take MODE 0 or 3 (march.cuh), which read neither cv nor tile.
template <int MODE, int STK>
struct WordScene {
  const SceneWords& sw;
  const CullView& cv;
  int tile;

  __device__ __forceinline__ const int* mask() const {
    return mode_culled(MODE) ? cv.masks + (size_t)tile * cv.n_words : nullptr;
  }
  __device__ __forceinline__ float operator()(float px, float py,
                                              float pz) const {
    if constexpr (MODE == 1) {
      return compact_fold(
          [&](int row) {
            return leaf_distance(RowQuads{sw.leaf + 4 * row},
                                 __ldg(sw.row_kind + row), px, py, pz);
          },
          sw.op_param, cv, tile);
    } else {
      return words_distance<mode_dyn(MODE), STK>(sw, px, py, pz, mask());
    }
  }
  __device__ __forceinline__ void color(float px, float py, float pz,
                                        const float* def, float rgb[3]) const {
    words_color<mode_dyn(MODE), STK>(sw, px, py, pz, def, rgb, mask());
  }
};

}  // namespace rmt
