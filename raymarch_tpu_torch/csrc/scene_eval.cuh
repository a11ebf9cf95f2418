// Scene distance on the device: a run-time interpreter of the static combine
// tape over the leaf parameter bank.
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

// Value stack of the interpreter (RenderConfig.stack_depth, the reference's
// 32, wgsl:173). The Python wrapper refuses deeper tapes.
constexpr int MAX_STACK = 32;

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

__device__ __forceinline__ float leaf_distance(const float* __restrict__ P,
                                               int kind, float px, float py,
                                               float pz) {
  const int type = kind & (ROTATED_BIT - 1);
  float x = px - __ldg(P + 4);
  float y = py - __ldg(P + 5);
  float z = pz - __ldg(P + 6);
  if (kind & ROTATED_BIT) {
    // Inverse-rotate by the unit quaternion (w,x,y,z):
    // t = 2 (u x v); v' = v + w t + u x t with u = -q.xyz.
    const float qw = __ldg(P + 0);
    const float qx = -__ldg(P + 1);
    const float qy = -__ldg(P + 2);
    const float qz = -__ldg(P + 3);
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
  switch (type) {
    case LEAF_SPHERE:
      return sqrtf(x * x + y * y + z * z + 1e-20f) - __ldg(P + 7);
    case LEAF_BOX: {
      const float qx = fabsf(x) - __ldg(P + 7);
      const float qy = fabsf(y) - __ldg(P + 8);
      const float qz = fabsf(z) - __ldg(P + 9);
      const float ox = fmaxf(qx, 0.0f);
      const float oy = fmaxf(qy, 0.0f);
      const float oz = fmaxf(qz, 0.0f);
      const float outside = sqrtf(ox * ox + oy * oy + oz * oz + 1e-20f);
      const float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);
      return outside + inside;
    }
    case LEAF_PLANE:
      // World-space plane: the center and rotation are folded at compile
      // time.
      return px * __ldg(P + 7) + py * __ldg(P + 8) + pz * __ldg(P + 9) +
             __ldg(P + 10);
    case LEAF_TORUS: {
      const float ring = sqrtf(x * x + z * z + 1e-20f) - __ldg(P + 7);
      return sqrtf(ring * ring + y * y + 1e-20f) - __ldg(P + 8);
    }
    case LEAF_CYLINDER: {
      const float qx = sqrtf(x * x + z * z + 1e-20f) - __ldg(P + 7);
      const float qy = fabsf(y) - __ldg(P + 8);
      const float ox = fmaxf(qx, 0.0f);
      const float oy = fmaxf(qy, 0.0f);
      return sqrtf(ox * ox + oy * oy + 1e-20f) + fminf(fmaxf(qx, qy), 0.0f);
    }
    case LEAF_CAPSULE: {
      const float h = __ldg(P + 8);
      const float yy = y - fminf(fmaxf(y, -h), h);
      return sqrtf(x * x + yy * yy + z * z + 1e-20f) - __ldg(P + 7);
    }
    case LEAF_CONE: {
      const float h = __ldg(P + 7);
      const float r1 = __ldg(P + 8);
      const float r2 = __ldg(P + 9);
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

// Distance substituted for a culled leaf (ops/culling.py FAR).
constexpr float CULL_FAR = 1.0e4f;

// True when bit `row` of a tile's packed leaf mask is set.
__device__ __forceinline__ bool mask_bit(const int* __restrict__ mask,
                                         int row) {
  return ((__ldg(mask + (row >> 5)) >> (row & 31)) & 1) != 0;
}

// Distance from point p to the scene. Leaves are evaluated at their PUSH, as
// the static unroll does; a binary op at slot s reads (s, s+1), writes s.
// With a tile mask (the gated tape of a culled frame), a leaf whose bit is
// clear reads CULL_FAR instead of its distance: exact for hits, shading and
// the escape test by the lemma of ops/culling.py. The plain version is
// sdf._apply_static_tape with `cull`.
__device__ __forceinline__ float scene_distance(const SceneView& sc, float px,
                                                float py, float pz,
                                                const int* mask = nullptr) {
  if (sc.n_instr == 0) return sc.max_dist;
  float stk[MAX_STACK];
  for (int i = 0; i < sc.n_instr; ++i) {
    const int op = __ldg(sc.tape_ops + i);
    const int s = __ldg(sc.out_slot + i);
    if (op == COP_PUSH) {
      const int row = __ldg(sc.tape_arg + i);
      stk[s] = (mask != nullptr && !mask_bit(mask, row))
                   ? CULL_FAR
                   : leaf_distance(sc.leaf_params + row * LEAF_PARAM_WIDTH,
                                   __ldg(sc.row_kind + row), px, py, pz);
      continue;
    }
    const float k = __ldg(sc.op_param + i);
    const float a = stk[s];
    float r;
    switch (op) {
      case COP_ROUND:
        r = a - k;
        break;
      case COP_ONION:
        r = fabsf(a) - k;
        break;
      case COP_UNION:
        r = fminf(a, stk[s + 1]);
        break;
      case COP_INTERSECTION:
        r = fmaxf(a, stk[s + 1]);
        break;
      case COP_SUBTRACTION:
        r = fmaxf(a, -stk[s + 1]);
        break;
      case COP_SMOOTH_UNION:
        r = smooth_min(a, stk[s + 1], k);
        break;
      case COP_SMOOTH_INTERSECTION:
        r = -smooth_min(-a, -stk[s + 1], k);
        break;
      case COP_SMOOTH_SUBTRACTION:
        r = -smooth_min(-a, stk[s + 1], k);
        break;
      default:  // COP_NOP never appears in the real-instruction prefix
        r = a;
        break;
    }
    stk[s] = r;
  }
  return stk[0];
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
__device__ __forceinline__ float fold_step(const SceneView& sc, float acc,
                                           int e, float dv) {
  const int mode = (e >> 13) & 3;
  const int ki = e >> 18;
  const float kp = __ldg(sc.op_param + (ki - 1 > 0 ? ki - 1 : 0));
  const float kk = fmaxf(kp, 1e-8f);
  const bool is_sub = mode >= 2;
  const float hard = is_sub ? fmaxf(acc, -dv) : fminf(acc, dv);
  if ((mode & 1) == 0) return hard;
  const float diff = is_sub ? acc + dv : acc - dv;
  const float h = fmaxf(kk - fabsf(diff), 0.0f) / kk;
  const float corr = h * h * kk * 0.25f;
  return is_sub ? hard + corr : hard - corr;
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
__device__ __forceinline__ float scene_distance_compact(const SceneView& sc,
                                                        const CullView& cv,
                                                        int tile, float px,
                                                        float py, float pz) {
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
      for (int j = 0; j < n; ++j)
        d = fminf(d, entry_distance(sc, __ldg(lst + off + j), px, py, pz));
    } else if (source == 1) {  // the seg1 chain
      has_chain = true;
      for (int j = 0; j < n; ++j) {
        const int e = __ldg(lst + off + j);
        const float dv = entry_distance(sc, e & 1023, px, py, pz);
        chain = ordered ? fold_step(sc, chain, e, dv) : fminf(chain, dv);
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
        acc_seg = fold_step(sc, acc_seg, e,
                            entry_distance(sc, e & 1023, px, py, pz));
        prev = sid;
      }
      d = fminf(acc_out, acc_seg);
    }
  }
  return has_chain ? fminf(d, chain) : d;
}

// The scene distance at a point of pixel tile `tile` under culling mode
// MODE (CullView::mode). A template parameter, so that each kernel is built
// once per mode and the unculled build carries no culling code.
template <int MODE>
__device__ __forceinline__ float scene_distance_tile(const SceneView& sc,
                                                     const CullView& cv,
                                                     int tile, float px,
                                                     float py, float pz) {
  if constexpr (MODE == 1) {
    return scene_distance_compact(sc, cv, tile, px, py, pz);
  } else if constexpr (MODE == 2) {
    return scene_distance(sc, px, py, pz,
                          cv.masks + (size_t)tile * cv.n_words);
  } else {
    return scene_distance(sc, px, py, pz);
  }
}

}  // namespace rmt
