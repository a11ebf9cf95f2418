// Reverse mode through the scene distance of scene_eval.cuh and through
// one ray's shading, written by hand: CUDA has no jax.grad inside a kernel.
//
// Replaces what `jax.grad` derives inside raymarch_tpu/ops/pallas_grad.py:
// bwd_kernel (1432) from _leaf_distance_tile (pallas_march.py:63-133) and
// the static combine tape (sdf._apply_static_tape, _combine_static and
// smooth_min, sdf.py:47-56). The closed forms are those of
// raymarch_tpu/ops/oracle_grad.py (71-290), here in the f32 op order of
// the forward.
//
// tape_forward(p) evaluates the tape at p as scene_distance does and keeps
// the reverse records of each combine instruction in a record set; then
// tape_reverse walks the tape backwards with a cotangent stack: every leaf
// adds seed * dF/dparam to its 16-word bank row, every round/onion/smooth
// op adds seed * dF/dk to its op word, and it returns seed * dF/dp. It
// skips every leaf and op whose cotangent is exactly zero (the losers of
// hard unions); where the accumulator keeps a warp converged, it skips
// those the whole warp leaves at zero.
//
// The records. A hard op's reverse reads only which operand won, or a tie
// (max_adj's three cases), and an onion only the sign of its operand: two
// bits (op_code), 16 instructions to a word. A smooth op's reverse reads
// its operands through their difference alone (smooth_min's e = a - b,
// whose sign is the comparison min_adj makes): one float. Round needs
// nothing. So a sweep over 127 hard instructions keeps 8 words, where the
// operands would take 254 floats; a thread keeps four sets (the taps,
// recorded in the primal pass so that no tap is evaluated twice) and a
// fifth for the colour walk, in shared memory (RecStore), or in device
// memory where a tape's records do not fit beside the block's other
// threads' (ops/cuda_grad.py GradLayout chooses).
//
// color_forward_rec and color_adjoint are the colour walk of scene_color
// (scene_eval.cuh) for a painted scene and its reverse: the albedo
// cotangent reaches each contributing leaf's albedo and flag words and,
// through the smooth blend weights (mat_weight_smooth), both operand
// distances and the blend radius; those distance cotangents go through the
// leaf adjoints to the leaf rows and to the point. Hard ops pick their
// colour by a comparison whose derivative is zero. The colour set keeps
// per smooth op e and the operands' colour difference (4 floats), and the
// hard ops' codes: the records of a distance sweep at the same point too,
// so the hit point's two sweeps read them.
//
// Accumulation (WarpRow): the kernels keep each warp's 32 lanes converged
// through a ray's whole backward, so every add of a leaf row is made by
// the whole warp at once: the lanes' 16-word rows are summed by a
// transposed shuffle reduction (16 shuffles for the row) and added with one
// atomic instruction whose 16 lanes hit 16 different words; an op word
// with a 5-step butterfly and one atomic; the 7 camera words stay in
// registers until the kernel's end. Where the gradient row does not fit in
// shared memory it is added to device memory instead, so no bank size caps
// the scene. The per-thread build (ThreadRows) keeps a row per thread in
// shared memory and needs no atomics.
//
// Ties follow JAX: a max/min whose two inputs are equal splits the
// cotangent in half, and |x| has derivative 0 at 0. Ties are measure-zero;
// box edges and the cone's branches reach them, and the tolerance of the
// gradient checks covers them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

constexpr unsigned FULL_MASK = 0xffffffffu;
// Record sets of a thread: the 4 taps (and, after their sweeps, the hit
// point or the soft envelope point), then on a painted scene the colour
// walk's.
constexpr int TAP_SETS = 4;

// One instruction of the backwards' packed tape (ops/cuda_grad.py
// GradLayout.packed_tape): op | out_slot << 8, leaf row, the row's kind
// and the gradient slot of the row's word 0 (16 times its rank among the
// pushed rows); one 16-byte load per instruction.
struct BwdTape {
  const int4* ins;           // [n]
  const float* op_param;     // [>= n]
  const float* leaf_params;  // [n_leaves, 16]
  int n;                     // real instructions; 0 = empty scene
  int n_smooth;              // smooth ops among them
  float max_dist;            // the empty scene's distance
};

// A thread's reverse records: slot k at base[k * stride] (shared memory,
// stride = the block's threads, or device memory, stride = the launch's
// threads), so that a warp's records of one slot are adjacent.
struct RecStore {
  uint32_t* base;
  long long stride;
  __device__ __forceinline__ uint32_t& word(int k) const {
    return base[(long long)k * stride];
  }
  __device__ __forceinline__ float flt(int k) const {
    return __uint_as_float(word(k));
  }
  __device__ __forceinline__ void put(int k, float v) const {
    word(k) = __float_as_uint(v);
  }
};

// One record set: the codes of instruction i in word code0 + i / 16 (bits
// 2 (i % 16), 2 (i % 16) + 1), smooth op f's floats from fl0 + f * fmul.
struct RecSet {
  int code0, fl0, fmul;
};

// Words of a thread's records (ops/cuda_grad.py GradLayout.rec_words): the
// codes of TAP_SETS (+ 1 painted) sets, one float per smooth op in each
// tap set, 4 per smooth op in the colour set.
__host__ __device__ __forceinline__ int code_words(int n) {
  return (n + 15) / 16;
}
__host__ __device__ __forceinline__ int rec_words(int n, int n_smooth,
                                                  bool mats) {
  return (TAP_SETS + (mats ? 1 : 0)) * code_words(n) +
         (TAP_SETS + (mats ? 4 : 0)) * n_smooth;
}
__device__ __forceinline__ RecSet tap_set(const BwdTape& tp, bool mats,
                                          int k) {
  const int sets = TAP_SETS + (mats ? 1 : 0);
  return RecSet{k * code_words(tp.n), sets * code_words(tp.n) + k * tp.n_smooth,
                1};
}
__device__ __forceinline__ RecSet colour_set(const BwdTape& tp) {
  return RecSet{TAP_SETS * code_words(tp.n),
                (TAP_SETS + 1) * code_words(tp.n) + TAP_SETS * tp.n_smooth, 4};
}

// A leaf's 16 gradient words of one lane, filled by leaf_adjoint (slot
// base 0: every index is a constant, so the row stays in registers).
struct Row16 {
  float w[16];
  __device__ __forceinline__ Row16() {
#pragma unroll
    for (int c = 0; c < 16; ++c) w[c] = 0.0f;
  }
  __device__ __forceinline__ void operator()(int k, float v) { w[k] += v; }
};

// The sum over the warp of N = 16 or 8 values per lane, transposed: after
// log2(N) halving steps and the plain steps below them, the lanes with
// lane % (32 / N) == 0 hold the sum of value (lane / (32 / N)) in v[0].
template <int N>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  int off = 16;
#pragma unroll
  for (int h = N / 2; h >= 1; h /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int c = 0; c < h; ++c) {
      const float send = upper ? v[c] : v[c + h];
      const float keep = upper ? v[c + h] : v[c];
      v[c] = keep + __shfl_xor_sync(FULL_MASK, send, off);
    }
  }
  for (; off >= 1; off /= 2) v[0] += __shfl_xor_sync(FULL_MASK, v[0], off);
  return v[0];
}

// Warp-aggregated adds into a gradient row (shared or device memory). All
// 32 lanes call each method together; `has` false adds nothing for that
// lane. Lanes are grouped by key (the row's slot base, or the word), one
// group per pass: the legacy backward's rows are the same in every lane
// (one pass), the compact backward's pool winners may differ.
struct WarpRow {
  float* row;
  __device__ __forceinline__ bool any(bool b) const {
    return __any_sync(FULL_MASK, b);
  }
  __device__ __forceinline__ void leaf(int key, bool has,
                                       const float (&w)[16]) const {
    const int lane = threadIdx.x & 31;
    unsigned todo = __ballot_sync(FULL_MASK, has);
    while (todo) {
      const int k = __shfl_sync(FULL_MASK, key, __ffs(todo) - 1);
      const bool mine = has && key == k;
      todo &= ~__ballot_sync(FULL_MASK, mine);
      float v[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) v[c] = mine ? w[c] : 0.0f;
      const float sum = warp_transpose_sum<16>(v);
      if ((lane & 1) == 0 && sum != 0.0f) atomicAdd(row + k + (lane >> 1), sum);
    }
  }
  __device__ __forceinline__ void word(int key, bool has, float x) const {
    unsigned todo = __ballot_sync(FULL_MASK, has);
    while (todo) {
      const int k = __shfl_sync(FULL_MASK, key, __ffs(todo) - 1);
      const bool mine = has && key == k;
      todo &= ~__ballot_sync(FULL_MASK, mine);
      float v = mine ? x : 0.0f;
#pragma unroll
      for (int off = 16; off >= 1; off /= 2)
        v += __shfl_xor_sync(FULL_MASK, v, off);
      if ((threadIdx.x & 31) == 0 && v != 0.0f) atomicAdd(row + k, v);
    }
  }
  // The lanes' camera sums (7 words from cam_base), once per kernel.
  __device__ __forceinline__ void camera(int cam_base,
                                         const float (&cam)[7]) const {
    float v[8];
#pragma unroll
    for (int c = 0; c < 7; ++c) v[c] = cam[c];
    v[7] = 0.0f;
    const float sum = warp_transpose_sum<8>(v);
    const int lane = threadIdx.x & 31;
    if ((lane & 3) == 0 && (lane >> 2) < 7 && sum != 0.0f)
      atomicAdd(row + cam_base + (lane >> 2), sum);
  }
};

// A thread's own running sums in shared memory (word k of thread t at
// k * (blockDim + 1) + t: no bank conflicts, no atomics): the per-thread
// build of the legacy backward. Its lanes need not stay converged.
struct ThreadRows {
  float* base;  // word 0 of this thread
  int stride;   // blockDim.x + 1
  __device__ __forceinline__ bool any(bool b) const { return b; }
  __device__ __forceinline__ void leaf(int key, bool has,
                                       const float (&w)[16]) const {
    if (!has) return;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (w[c] != 0.0f) base[(key + c) * stride] += w[c];
  }
  __device__ __forceinline__ void word(int key, bool has, float x) const {
    if (has) base[key * stride] += x;
  }
  __device__ __forceinline__ void camera(int cam_base,
                                         const float (&cam)[7]) const {
#pragma unroll
    for (int c = 0; c < 7; ++c) base[(cam_base + c) * stride] += cam[c];
  }
};

// One thread's fold history for the compact backward: slot h at
// base[(h - off) * stride], in shared or device memory, so that a warp's
// records of one slot are adjacent.
struct History {
  float* base;       // the thread's slot `off`
  long long stride;  // threads sharing the store
  int off;           // slot of the first record
  __device__ __forceinline__ float& at(int col) const {
    return base[(long long)(col - off) * stride];
  }
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Cotangents of max(a, b) and min(a, b) for the output cotangent g.
__device__ __forceinline__ void max_adj(float a, float b, float g, float& ga,
                                        float& gb) {
  if (a > b) {
    ga = g;
    gb = 0.0f;
  } else if (a < b) {
    ga = 0.0f;
    gb = g;
  } else {
    ga = 0.5f * g;
    gb = 0.5f * g;
  }
}
__device__ __forceinline__ void min_adj(float a, float b, float g, float& ga,
                                        float& gb) {
  max_adj(-a, -b, g, ga, gb);
}

// Adjoint of the rotation v' = v + w T + u x T with T = 2 u x v (the
// quaternion (w, u) applied to v): the cotangent g of v' gives those of v,
// w and u.
__device__ __forceinline__ void qrot_adj(float w, V3 u, V3 v, V3 g, V3& gv,
                                         float& gw, V3& gu) {
  const V3 T = scale(cross(u, v), 2.0f);
  gw = dot(T, g);
  const V3 gT = add(scale(g, w), cross(g, u));
  gu = add(cross(T, g), scale(cross(v, gT), 2.0f));
  gv = add(g, scale(cross(gT, u), 2.0f));
}

// d/da, d/db, d/dk of smooth_min(a, b, k) (scene_eval.cuh) times g, from
// e = a - b alone: min(a, b)'s comparison is e's sign (a - b is 0 exactly
// when a == b, and NaN where a == b == inf: a tie either way).
__device__ __forceinline__ void smooth_min_adj(float e, float k, float g,
                                               float& ga, float& gb,
                                               float& gk) {
  const float kc = fmaxf(k, 1e-8f);
  const float m = fmaxf(kc - fabsf(e), 0.0f);
  const float h = m / kc;
  // r = min(a, b) - h * h * kc / 4
  const float gh = -0.5f * g * h * kc;
  float gkc = -0.25f * g * h * h;
  const float gm = gh / kc;
  gkc -= gh * h / kc;
  float gdiff, unused;
  max_adj(kc - fabsf(e), 0.0f, gm, gdiff, unused);
  gkc += gdiff;
  const float ge = -gdiff * sgn(e);
  float gma, gmb;
  max_adj(-e, 0.0f, g, gma, gmb);  // min_adj(a, b): -a > -b iff -e > 0
  ga = gma + ge;
  gb = gmb - ge;
  float gk_, unused2;
  max_adj(k, 1e-8f, gkc, gk_, unused2);
  gk = gk_;
}

__device__ __forceinline__ bool is_smooth(int op) {
  return op == COP_SMOOTH_UNION || op == COP_SMOOTH_INTERSECTION ||
         op == COP_SMOOTH_SUBTRACTION;
}

// The reverse record of a hard op or an onion: 0 where its result took
// the first operand (ga = g; an onion's a > 0), 1 the second (a hard op's
// b, by its sign; an onion's a < 0), 2 a tie (both halves; an onion at 0).
// The comparisons are max_adj's, on the operands its callers give it.
__device__ __forceinline__ uint32_t cmp_code(float x, float y) {
  return x > y ? 0u : (x < y ? 1u : 2u);
}
__device__ __forceinline__ uint32_t op_code(int op, float a, float b) {
  switch (op) {
    case COP_ONION:
      return cmp_code(a, 0.0f);
    case COP_UNION:
      return cmp_code(-a, -b);
    case COP_INTERSECTION:
      return cmp_code(a, b);
    case COP_SUBTRACTION:
      return cmp_code(a, -b);
    default:
      return 0u;
  }
}
// A smooth op's reverse record: the difference smooth_min reads, on the
// operands that smooth_min is called with (combine).
__device__ __forceinline__ float smooth_e(int op, float a, float b) {
  switch (op) {
    case COP_SMOOTH_UNION:
      return a - b;
    case COP_SMOOTH_INTERSECTION:
      return -a - -b;
    default:  // COP_SMOOTH_SUBTRACTION
      return -a - b;
  }
}

// Cotangents of a combine instruction's operands and op word from that of
// its result, g, and its record (code, or e for a smooth op); round and
// onion read a alone, and gb is then 0.
__device__ __forceinline__ void op_adjoint(int op, uint32_t code, float e,
                                           float k, float g, float& ga,
                                           float& gb, float& gk) {
  ga = 0.0f;
  gb = 0.0f;
  gk = 0.0f;
  const float half = 0.5f * g;
  switch (op) {
    case COP_ROUND:
      ga = g;
      gk = -g;
      break;
    case COP_ONION:
      ga = code == 0u ? g : (code == 1u ? -g : 0.0f);
      gk = -g;
      break;
    case COP_UNION:
    case COP_INTERSECTION:
      ga = code == 0u ? g : (code == 1u ? 0.0f : half);
      gb = code == 1u ? g : (code == 0u ? 0.0f : half);
      break;
    case COP_SUBTRACTION:  // max(a, -b)
      ga = code == 0u ? g : (code == 1u ? 0.0f : half);
      gb = code == 1u ? -g : (code == 0u ? 0.0f : -half);
      break;
    case COP_SMOOTH_UNION:
      smooth_min_adj(e, k, g, ga, gb, gk);
      break;
    case COP_SMOOTH_INTERSECTION: {
      float gna, gnb;
      smooth_min_adj(e, k, -g, gna, gnb, gk);
      ga = -gna;
      gb = -gnb;
      break;
    }
    case COP_SMOOTH_SUBTRACTION: {
      float gna;
      smooth_min_adj(e, k, -g, gna, gb, gk);
      ga = -gna;
      break;
    }
    default:
      ga = g;
      break;
  }
}

// Reverse mode of leaf_distance for the leaf bank row P at point p: adds
// g * dd/dP[c] to acc(base + c) when ACC, and returns g * dd/dp.
template <bool ACC, class Acc>
__device__ __forceinline__ V3 leaf_adjoint(const float* __restrict__ P,
                                           int kind, V3 p, float g, int base,
                                           Acc& acc) {
  const int type = kind & (ROTATED_BIT - 1);
  if (type == LEAF_PLANE) {
    if (ACC) {
      acc(base + 7, g * p.x);
      acc(base + 8, g * p.y);
      acc(base + 9, g * p.z);
      acc(base + 10, g);
    }
    return v3(g * __ldg(P + 7), g * __ldg(P + 8), g * __ldg(P + 9));
  }
  const V3 v = v3(p.x - __ldg(P + 4), p.y - __ldg(P + 5), p.z - __ldg(P + 6));
  const bool rotated = (kind & ROTATED_BIT) != 0;
  const float qw = __ldg(P + 0);
  const V3 u = v3(-__ldg(P + 1), -__ldg(P + 2), -__ldg(P + 3));
  float x = v.x, y = v.y, z = v.z;
  if (rotated) {
    // The forward's op order (scene_eval.cuh leaf_distance).
    const float tx = 2.0f * (u.y * z - u.z * y);
    const float ty = 2.0f * (u.z * x - u.x * z);
    const float tz = 2.0f * (u.x * y - u.y * x);
    const float x2 = x + qw * tx + (u.y * tz - u.z * ty);
    const float y2 = y + qw * ty + (u.z * tx - u.x * tz);
    const float z2 = z + qw * tz + (u.x * ty - u.y * tx);
    x = x2;
    y = y2;
    z = z2;
  }
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;  // cotangent of the local point
  float g7 = 0.0f, g8 = 0.0f, g9 = 0.0f;  // of the shape words
  switch (type) {
    case LEAF_SPHERE: {
      const float L = sqrtf(x * x + y * y + z * z + 1e-20f);
      const float a = g / L;
      gx = a * x;
      gy = a * y;
      gz = a * z;
      g7 = -g;
      break;
    }
    case LEAF_BOX: {
      const float qx = fabsf(x) - __ldg(P + 7);
      const float qy = fabsf(y) - __ldg(P + 8);
      const float qz = fabsf(z) - __ldg(P + 9);
      const float ox = fmaxf(qx, 0.0f);
      const float oy = fmaxf(qy, 0.0f);
      const float oz = fmaxf(qz, 0.0f);
      const float O = sqrtf(ox * ox + oy * oy + oz * oz + 1e-20f);
      const float go = g / O;
      float gqx = go * ox, gqy = go * oy, gqz = go * oz;
      const float myz = fmaxf(qy, qz);
      const float m = fmaxf(qx, myz);
      float gm, g0, gqx2, gmyz, gqy2, gqz2;
      min_adj(m, 0.0f, g, gm, g0);
      max_adj(qx, myz, gm, gqx2, gmyz);
      max_adj(qy, qz, gmyz, gqy2, gqz2);
      gqx += gqx2;
      gqy += gqy2;
      gqz += gqz2;
      gx = gqx * sgn(x);
      gy = gqy * sgn(y);
      gz = gqz * sgn(z);
      g7 = -gqx;
      g8 = -gqy;
      g9 = -gqz;
      break;
    }
    case LEAF_TORUS: {
      const float A = sqrtf(x * x + z * z + 1e-20f);
      const float ring = A - __ldg(P + 7);
      const float B = sqrtf(ring * ring + y * y + 1e-20f);
      const float gring = g * ring / B;
      gy = g * y / B;
      g8 = -g;
      g7 = -gring;
      gx = gring * x / A;
      gz = gring * z / A;
      break;
    }
    case LEAF_CYLINDER: {
      const float A = sqrtf(x * x + z * z + 1e-20f);
      const float qx = A - __ldg(P + 7);
      const float qy = fabsf(y) - __ldg(P + 8);
      const float ox = fmaxf(qx, 0.0f);
      const float oy = fmaxf(qy, 0.0f);
      const float O = sqrtf(ox * ox + oy * oy + 1e-20f);
      float gqx = g * ox / O, gqy = g * oy / O;
      const float m = fmaxf(qx, qy);
      float gm, g0, ga, gb;
      min_adj(m, 0.0f, g, gm, g0);
      max_adj(qx, qy, gm, ga, gb);
      gqx += ga;
      gqy += gb;
      g7 = -gqx;
      gx = gqx * x / A;
      gz = gqx * z / A;
      g8 = -gqy;
      gy = gqy * sgn(y);
      break;
    }
    case LEAF_CAPSULE: {
      const float h = __ldg(P + 8);
      const float mx = fmaxf(y, -h);
      const float cl = fminf(mx, h);
      const float yy = y - cl;
      const float L = sqrtf(x * x + yy * yy + z * z + 1e-20f);
      const float a = g / L;
      g7 = -g;
      gx = a * x;
      gz = a * z;
      const float gyy = a * yy;
      float gmx, gh1, gy2, gnh;
      min_adj(mx, h, -gyy, gmx, gh1);
      max_adj(y, -h, gmx, gy2, gnh);
      gy = gyy + gy2;
      g8 = gh1 - gnh;
      break;
    }
    case LEAF_CONE: {
      const float h = __ldg(P + 7);
      const float r1 = __ldg(P + 8);
      const float r2 = __ldg(P + 9);
      const float A = sqrtf(x * x + z * z + 1e-20f);
      const float k2x = r2 - r1;
      const float k2y = 2.0f * h;
      const float sel = y < 0.0f ? r1 : r2;
      const float mn = fminf(A, sel);
      const float cax = A - mn;
      const float cay = fabsf(y) - h;
      const float S2 = k2x * k2x + k2y * k2y;
      const float denom = fmaxf(S2, 1e-20f);
      const float num = (r2 - A) * k2x + (h - y) * k2y;
      const float traw = num / denom;
      const float tmx = fmaxf(traw, 0.0f);
      const float tt = fminf(tmx, 1.0f);
      const float cbx = A - r2 + k2x * tt;
      const float cby = y - h + k2y * tt;
      const float s = (cbx < 0.0f && cay < 0.0f) ? -1.0f : 1.0f;
      const float da = cax * cax + cay * cay;
      const float db = cbx * cbx + cby * cby;
      const float D = sqrtf(fminf(da, db) + 1e-20f);
      const float gmm = g * s * 0.5f / D;
      float gda, gdb;
      min_adj(da, db, gmm, gda, gdb);
      const float gcax = 2.0f * cax * gda;
      const float gcay = 2.0f * cay * gda;
      const float gcbx = 2.0f * cbx * gdb;
      const float gcby = 2.0f * cby * gdb;
      float gA = 0.0f, gr1 = 0.0f, gr2 = 0.0f, gh = 0.0f;
      float gk2x = 0.0f, gk2y = 0.0f, gtt = 0.0f;
      // cbx = A - r2 + k2x tt; cby = y - h + k2y tt
      gA += gcbx;
      gr2 -= gcbx;
      gk2x += gcbx * tt;
      gtt += gcbx * k2x;
      gy += gcby;
      gh -= gcby;
      gk2y += gcby * tt;
      gtt += gcby * k2y;
      // tt = min(max(traw, 0), 1)
      float gtmx, gone, gtraw, gzero;
      min_adj(tmx, 1.0f, gtt, gtmx, gone);
      max_adj(traw, 0.0f, gtmx, gtraw, gzero);
      // traw = num / denom, denom = max(k2x^2 + k2y^2, 1e-20)
      const float gnum = gtraw / denom;
      const float gden = -gtraw * traw / denom;
      float gS2, gfloor;
      max_adj(S2, 1e-20f, gden, gS2, gfloor);
      gk2x += 2.0f * k2x * gS2;
      gk2y += 2.0f * k2y * gS2;
      // num = (r2 - A) k2x + (h - y) k2y
      gr2 += gnum * k2x;
      gA -= gnum * k2x;
      gk2x += gnum * (r2 - A);
      gh += gnum * k2y;
      gy -= gnum * k2y;
      gk2y += gnum * (h - y);
      // cay = |y| - h
      gy += gcay * sgn(y);
      gh -= gcay;
      // cax = A - min(A, sel)
      float gmA, gsel;
      min_adj(A, sel, -gcax, gmA, gsel);
      gA += gcax + gmA;
      if (y < 0.0f) {
        gr1 += gsel;
      } else {
        gr2 += gsel;
      }
      // k2x = r2 - r1, k2y = 2 h
      gr2 += gk2x;
      gr1 -= gk2x;
      gh += 2.0f * gk2y;
      gx = gA * x / A;
      gz = gA * z / A;
      g7 = gh;
      g8 = gr1;
      g9 = gr2;
      break;
    }
    default:
      break;
  }
  V3 gv = v3(gx, gy, gz);
  if (rotated) {
    float gw;
    V3 gu;
    qrot_adj(qw, u, v, v3(gx, gy, gz), gv, gw, gu);
    if (ACC) {
      acc(base + 0, gw);
      acc(base + 1, -gu.x);
      acc(base + 2, -gu.y);
      acc(base + 3, -gu.z);
    }
  }
  if (ACC) {
    acc(base + 4, -gv.x);
    acc(base + 5, -gv.y);
    acc(base + 6, -gv.z);
    acc(base + 7, g7);
    acc(base + 8, g8);
    acc(base + 9, g9);
  }
  return gv;
}

// The result of combine instruction op on operands a, b (round and onion
// read a alone) and op word k, in scene_distance's operation order.
__device__ __forceinline__ float combine(int op, float a, float b, float k) {
  switch (op) {
    case COP_ROUND:
      return a - k;
    case COP_ONION:
      return fabsf(a) - k;
    case COP_UNION:
      return fminf(a, b);
    case COP_INTERSECTION:
      return fmaxf(a, b);
    case COP_SUBTRACTION:
      return fmaxf(a, -b);
    case COP_SMOOTH_UNION:
      return smooth_min(a, b, k);
    case COP_SMOOTH_INTERSECTION:
      return -smooth_min(-a, -b, k);
    case COP_SMOOTH_SUBTRACTION:
      return -smooth_min(-a, b, k);
    default:
      return a;
  }
}

// The scene distance at p as scene_distance computes it, keeping the
// records of every combine instruction in set `rs` of rec: each code in a
// register until its word of 16 is full, each smooth op's e as it comes.
__device__ __forceinline__ float tape_forward(const BwdTape& tp, V3 p,
                                              const RecStore& rec, RecSet rs) {
  if (tp.n == 0) return tp.max_dist;
  float stk[MAX_STACK];
  uint32_t cur = 0u;
  int f = 0;
  for (int i = 0; i < tp.n; ++i) {
    const int4 in = tp.ins[i];
    const int op = in.x & 255, s = in.x >> 8;
    if (op == COP_PUSH) {
      stk[s] = leaf_distance(tp.leaf_params + in.y * LEAF_PARAM_WIDTH, in.z,
                             p.x, p.y, p.z);
    } else {
      const float a = stk[s];
      const float b = (op == COP_ROUND || op == COP_ONION) ? 0.0f : stk[s + 1];
      if (is_smooth(op)) {
        rec.put(rs.fl0 + f * rs.fmul, smooth_e(op, a, b));
        ++f;
      } else {
        cur |= op_code(op, a, b) << (2 * (i & 15));
      }
      stk[s] = combine(op, a, b, __ldg(tp.op_param + i));
    }
    if ((i & 15) == 15 || i == tp.n - 1) {
      rec.word(rs.code0 + (i >> 4)) = cur;
      cur = 0u;
    }
  }
  return stk[0];
}

// seed * dF/dp at p from the records of set rs (tape_forward at p); with
// ACC, also adds seed * dF/dtheta to the leaf rows (word 0 at the PUSH's
// gradient slot) and to the op words (slot op_base + i) through acc.
// Skips every leaf and op whose cotangent is exactly zero (in acc's unit:
// a lane, or a converged warp).
template <bool ACC, class Acc>
__device__ V3 tape_reverse(const BwdTape& tp, const RecStore& rec, RecSet rs,
                           int op_base, V3 p, float seed, const Acc& acc) {
  V3 gp = v3(0.0f, 0.0f, 0.0f);
  if (tp.n == 0) return gp;  // the empty scene is a constant
  float gs[MAX_STACK];
  gs[0] = seed;
  uint32_t cur = 0u;
  int f = tp.n_smooth;
  for (int i = tp.n - 1; i >= 0; --i) {
    const int4 in = tp.ins[i];
    const int op = in.x & 255, s = in.x >> 8;
    if ((i & 15) == 15 || i == tp.n - 1) cur = rec.word(rs.code0 + (i >> 4));
    const bool smooth = is_smooth(op);
    if (smooth) --f;
    const float g = gs[s];
    if (op == COP_PUSH) {
      if (!acc.any(g != 0.0f)) continue;
      Row16 r;
      gp = add(gp, leaf_adjoint<ACC>(tp.leaf_params + in.y * LEAF_PARAM_WIDTH,
                                     in.z, p, g, 0, r));
      if (ACC) acc.leaf(in.w, g != 0.0f, r.w);
      continue;
    }
    const bool unary = op == COP_ROUND || op == COP_ONION;
    if (!acc.any(g != 0.0f)) {
      if (!unary) gs[s + 1] = 0.0f;
      continue;
    }
    float ga, gb, gk;
    op_adjoint(op, (cur >> (2 * (i & 15))) & 3u,
               smooth ? rec.flt(rs.fl0 + f * rs.fmul) : 0.0f,
               __ldg(tp.op_param + i), g, ga, gb, gk);
    gs[s] = ga;
    if (!unary) gs[s + 1] = gb;
    if (ACC && acc.any(gk != 0.0f)) acc.word(op_base + i, gk != 0.0f, gk);
  }
  return gp;
}

// mat_weight_smooth(u, v, k) (scene_eval.cuh) from d = v - u, its operation
// order; and its cotangents from gw, with the derivative rules of its
// plain version (sdf._mat_weight_smooth under torch autograd): the clip
// passes the cotangent on [0, 1], ends included, and the floor of k
// passes it where k >= 1e-8.
__device__ __forceinline__ float mat_weight_d(float d, float k) {
  k = fmaxf(k, 1e-8f);
  return fminf(fmaxf(0.5f + 0.5f * d / k, 0.0f), 1.0f);
}
__device__ __forceinline__ void mat_weight_adj(float d, float k, float gw,
                                               float& gu, float& gv,
                                               float& gk) {
  const float kc = fmaxf(k, 1e-8f);
  const float q = 0.5f * d;
  const float x = 0.5f + q / kc;
  gu = 0.0f;
  gv = 0.0f;
  gk = 0.0f;
  if (!(x >= 0.0f && x <= 1.0f)) return;
  const float gq = gw / kc;
  gu = -0.5f * gq;
  gv = 0.5f * gq;
  if (k >= 1e-8f) gk = -gw * q / (kc * kc);
}

// The colour walk of scene_color (no tile mask) at p, keeping in set rs
// (colour_set) every combine instruction's code and, for a smooth op, e
// and the difference of its operands' colours (4 floats): the weight of a
// hard op is its code's winner, that of a smooth op mat_weight_smooth of
// -e (the difference of its weight's operands: b - a, a - b, a + b for the
// smooth union, intersection, subtraction). Writes the albedo at p to rgb.
__device__ __forceinline__ void color_forward_rec(const BwdTape& tp, V3 p,
                                                  const float* def,
                                                  float rgb[3],
                                                  const RecStore& rec,
                                                  RecSet rs) {
  if (tp.n == 0) {
    rgb[0] = def[0];
    rgb[1] = def[1];
    rgb[2] = def[2];
    return;
  }
  float stk[MAX_STACK], cr[MAX_STACK], cg[MAX_STACK], cb[MAX_STACK];
  uint32_t cur = 0u;
  int f = 0;
  for (int i = 0; i < tp.n; ++i) {
    const int4 in = tp.ins[i];
    const int op = in.x & 255, s = in.x >> 8;
    if (op == COP_PUSH) {
      const float* P = tp.leaf_params + in.y * LEAF_PARAM_WIDTH;
      stk[s] = leaf_distance(P, in.z, p.x, p.y, p.z);
      const float fl = __ldg(P + LEAF_MAT_FLAG);
      cr[s] = fl * __ldg(P + LEAF_ALBEDO + 0) + (1.0f - fl) * def[0];
      cg[s] = fl * __ldg(P + LEAF_ALBEDO + 1) + (1.0f - fl) * def[1];
      cb[s] = fl * __ldg(P + LEAF_ALBEDO + 2) + (1.0f - fl) * def[2];
    } else {
      const float k = __ldg(tp.op_param + i);
      const float a = stk[s];
      if (op == COP_ROUND || op == COP_ONION) {
        cur |= op_code(op, a, 0.0f) << (2 * (i & 15));
        stk[s] = combine(op, a, 0.0f, k);
      } else {
        const float b = stk[s + 1];
        float w;
        if (is_smooth(op)) {
          const float e = smooth_e(op, a, b);
          const int o = rs.fl0 + f * rs.fmul;
          rec.put(o, e);
          rec.put(o + 1, cr[s] - cr[s + 1]);
          rec.put(o + 2, cg[s] - cg[s + 1]);
          rec.put(o + 3, cb[s] - cb[s + 1]);
          ++f;
          w = mat_weight_d(-e, k);
        } else {
          const uint32_t code = op_code(op, a, b);
          cur |= code << (2 * (i & 15));
          w = code != 1u ? 1.0f : 0.0f;
        }
        stk[s] = combine(op, a, b, k);
        cr[s] = w * cr[s] + (1.0f - w) * cr[s + 1];
        cg[s] = w * cg[s] + (1.0f - w) * cg[s + 1];
        cb[s] = w * cb[s] + (1.0f - w) * cb[s + 1];
      }
    }
    if ((i & 15) == 15 || i == tp.n - 1) {
      rec.word(rs.code0 + (i >> 4)) = cur;
      cur = 0u;
    }
  }
  rgb[0] = cr[0];
  rgb[1] = cg[0];
  rgb[2] = cb[0];
}

// The reverse of color_forward_rec's walk at p for the albedo cotangent
// grgb (ACC throughout): adds each contributing leaf's albedo and flag
// words (a leaf's colour is flag * albedo + (1 - flag) * def), the blend
// radii's words of the smooth weights, and the leaf adjoints of the
// weights' distance cotangents; returns the position cotangent. A slot
// whose colour and distance cotangents are both exactly zero (the far side
// of a hard op) costs no leaf work or accumulation.
template <class Acc>
__device__ V3 color_adjoint(const BwdTape& tp, const RecStore& rec, RecSet rs,
                            int op_base, V3 p, const float* def,
                            const float grgb[3], const Acc& acc) {
  V3 gp = v3(0.0f, 0.0f, 0.0f);
  if (tp.n == 0) return gp;
  float gd[MAX_STACK], gr[MAX_STACK], gg[MAX_STACK], gb[MAX_STACK];
  gd[0] = 0.0f;
  gr[0] = grgb[0];
  gg[0] = grgb[1];
  gb[0] = grgb[2];
  uint32_t cur = 0u;
  int f = tp.n_smooth;
  for (int i = tp.n - 1; i >= 0; --i) {
    const int4 in = tp.ins[i];
    const int op = in.x & 255, s = in.x >> 8;
    if ((i & 15) == 15 || i == tp.n - 1) cur = rec.word(rs.code0 + (i >> 4));
    const bool smooth = is_smooth(op);
    if (smooth) --f;
    const float g = gd[s], cR = gr[s], cG = gg[s], cB = gb[s];
    const bool colour = cR != 0.0f || cG != 0.0f || cB != 0.0f;
    if (op == COP_PUSH) {
      if (!acc.any(colour || g != 0.0f)) continue;
      const float* P = tp.leaf_params + in.y * LEAF_PARAM_WIDTH;
      Row16 r;
      if (colour) {
        const float fl = __ldg(P + LEAF_MAT_FLAG);
        r(LEAF_ALBEDO + 0, fl * cR);
        r(LEAF_ALBEDO + 1, fl * cG);
        r(LEAF_ALBEDO + 2, fl * cB);
        r(LEAF_MAT_FLAG, (__ldg(P + LEAF_ALBEDO + 0) - def[0]) * cR +
                             (__ldg(P + LEAF_ALBEDO + 1) - def[1]) * cG +
                             (__ldg(P + LEAF_ALBEDO + 2) - def[2]) * cB);
      }
      if (g != 0.0f) gp = add(gp, leaf_adjoint<true>(P, in.z, p, g, 0, r));
      acc.leaf(in.w, colour || g != 0.0f, r.w);
      continue;
    }
    const bool unary = op == COP_ROUND || op == COP_ONION;
    if (!acc.any(g != 0.0f || colour)) {
      if (!unary) {
        gd[s + 1] = 0.0f;
        gr[s + 1] = 0.0f;
        gg[s + 1] = 0.0f;
        gb[s + 1] = 0.0f;
      }
      continue;
    }
    const float k = __ldg(tp.op_param + i);
    const uint32_t code = (cur >> (2 * (i & 15))) & 3u;
    const int o = rs.fl0 + f * rs.fmul;
    const float e = smooth ? rec.flt(o) : 0.0f;
    float ga, gbd, gk;
    op_adjoint(op, code, e, k, g, ga, gbd, gk);
    if (unary) {  // the colour passes through unchanged
      gd[s] = ga;
      if (acc.any(gk != 0.0f)) acc.word(op_base + i, gk != 0.0f, gk);
      continue;
    }
    float w = code != 1u ? 1.0f : 0.0f;
    if (smooth) {
      w = mat_weight_d(-e, k);
      const float gw = cR * rec.flt(o + 1) + cG * rec.flt(o + 2) +
                       cB * rec.flt(o + 3);
      if (gw != 0.0f) {
        float gu, gv, gkw;
        mat_weight_adj(-e, k, gw, gu, gv, gkw);
        switch (op) {
          case COP_SMOOTH_UNION:  // w = W(a, b, k)
            ga += gu;
            gbd += gv;
            break;
          case COP_SMOOTH_INTERSECTION:  // w = W(b, a, k)
            gbd += gu;
            ga += gv;
            break;
          default:  // COP_SMOOTH_SUBTRACTION: w = W(-b, a, k)
            gbd -= gu;
            ga += gv;
            break;
        }
        gk += gkw;
      }
    }
    gd[s] = ga;
    gd[s + 1] = gbd;
    gr[s] = w * cR;
    gg[s] = w * cG;
    gb[s] = w * cB;
    gr[s + 1] = (1.0f - w) * cR;
    gg[s + 1] = (1.0f - w) * cG;
    gb[s + 1] = (1.0f - w) * cB;
    if (acc.any(gk != 0.0f)) acc.word(op_base + i, gk != 0.0f, gk);
  }
  return gp;
}

// The soft forward's residuals beside (t, hit), and the soft backward's
// constants: the backwards' soft argument (null pointers in a hard run).
struct SoftRes {
  const float* s_min;  // f32[rows, width, S]: each ray's closest approach
  const float* t_min;  // its parameter (frozen: no cotangent)
  float beta_inv;      // f32(1 / coverage_beta)
  float gate;          // f32(1e-4 * min(1, coverage_beta))
};

// The adjoint of a ray's gamma-corrected colour c = sqrt(max(v, 0) + 1e-12)
// for the colour cotangent gcol: hard, v = alb * diff (a hit ray); SOFT, the
// coverage blend v = alpha * (alb * diff) + (1 - alpha) * fc over the floor
// colour fc. Adds d/d diff to gdiff, writes d/d alb to galb and returns d/d
// alpha (0 when hard). The backwards' shared shading adjoint.
template <bool SOFT>
__device__ __forceinline__ float colour_adj(const float gcol[3],
                                            const float alb[3], float diff,
                                            float alpha, const float fc[3],
                                            float& gdiff, float galb[3]) {
  float galpha = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float v =
        SOFT ? alpha * (alb[c] * diff) + (1.0f - alpha) * fc[c] : alb[c] * diff;
    const float col = sqrtf(fmaxf(v, 0.0f) + 1e-12f);
    float gv, unused;
    max_adj(v, 0.0f, gcol[c] * 0.5f / col, gv, unused);
    if constexpr (SOFT) {
      const float ga = gv * alpha;
      gdiff += ga * alb[c];
      galb[c] = ga * diff;
      galpha += gv * (alb[c] * diff - fc[c]);
    } else {
      gdiff += gv * alb[c];
      galb[c] = gv * diff;
    }
  }
  return galpha;
}

// The cotangent of s_min from that of alpha = exp(-max(s_min - min_dist, 0)
// * beta_inv): -alpha * beta_inv where s_min > min_dist (a tie of the max
// splits in half, as JAX's), else 0.
__device__ __forceinline__ float alpha_adj(float s_min, float min_dist,
                                           float beta_inv, float alpha,
                                           float galpha) {
  const float m = s_min - min_dist;
  const float gm = galpha * alpha * -beta_inv;
  return m > 0.0f ? gm : (m == 0.0f ? 0.5f * gm : 0.0f);
}

// One soft ray's residuals, as ray_backward reads them; a hard ray passes
// the empty NoSoft, so that the hard builds carry nothing of soft mode.
struct SoftRay {
  float hit, s_min, t_min, beta_inv;
};
struct NoSoft {};

// The per-ray work gate of the soft backwards: a ray that hit, or whose
// coverage exceeds 1e-4 * min(1, beta). The reference gates per 128-lane
// tile (pallas_grad.py:1730-1743); per ray the bound is the same: a skipped
// ray's dropped coverage gradient, alpha / beta times its colour
// cotangent, is at most 1e-4 of that cotangent.
__device__ __forceinline__ bool soft_work(float hit, float alpha, float gate) {
  return hit > 0.0f || alpha > gate;
}

// The gradient of one ray (the per-ray body of the legacy backward, see
// fused_bwd.cu): adds its leaf and op words to acc and its 7 camera words
// to gcam. (i, j, s) are the band row, the pixel column and the AA sample,
// t the march end, and (gr, gg, gb) the pixel's cotangent over S; a lane
// with no work passes a zero cotangent (and, soft, no hit), which makes
// every seed of its sweeps zero. MATS shades with the albedo of the colour
// walk at the surface point and runs its adjoint (color_adjoint) before
// g_t is formed, so that the albedo's dependence on the hit point enters
// the implicit-function term too.
//
// The tape is evaluated forward 5 times per ray: at the 4 taps in the
// primal pass, each into its own record set, whose reverse sweeps then
// need no replay; and at the surface point (on a painted scene the colour
// walk, whose records serve the distance sweeps there too), whose records
// serve both sweeps of the implicit term. Soft rays take one more at the
// envelope point. Every branch that holds a sweep is taken by the whole
// warp when acc is a WarpRow (acc.any).
//
// SOFT (shade_loss_soft and the envelope term, pallas_grad.py:1536-1597,
// 1683-1696; the jnp twin march.py:209-232): the coverage alpha of the
// ray's closest approach takes the place of the hit mask; the surface term
// sits at the hit point, at o + d t_min on a miss, or at the origin where
// alpha <= 1e-4; the floor is blended by 1 - alpha. Its adjoint adds
// d alpha / d s_min = -alpha / beta where s_min > min_dist, and the
// envelope (Danskin) term: the cotangent g_s of s_min times F_theta at the
// frozen point o + d t_min, one more scene adjoint, whose position
// cotangent reaches o and, times t_min, d. t_min itself takes no
// cotangent, and the implicit term stays on hit rays.
template <bool MATS, class Soft, class Acc>
__device__ __forceinline__ void ray_backward(
    const BwdTape& tp, const float* __restrict__ cam, const RenderParams& p,
    float clamp, int op_base, int i, int j, int s, float t, const Soft sr,
    float gr, float gg, float gb, const RecStore& rec, const Acc& acc,
    float (&gcam)[7]) {
  constexpr bool SOFT = std::is_same<Soft, SoftRay>::value;
  float x, y;
  aa_screen_xy(cam, p, i, j, s, x, y);
  // The unrotated view direction, then the ray (view_ray).
  float vx = x * p.tan_aspect;
  float vy = y * p.tanf;
  float vz = -1.0f;
  const float inv_norm = 1.0f / sqrtf(vx * vx + vy * vy + vz * vz);
  const V3 vn = v3(vx * inv_norm, vy * inv_norm, vz * inv_norm);
  const Ray r = view_ray(cam, p, x, y);
  const V3 d = v3(r.dx, r.dy, r.dz);
  // The surface point: o + d t on a hit; soft, o + d t_min on a miss and o
  // where alpha <= 1e-4 (shade_soft's guard).
  float alpha = 1.0f, te = t;
  bool live = true;
  if constexpr (SOFT) {
    alpha = soft_alpha(sr.s_min, p.min_dist, sr.beta_inv);
    live = alpha > 1e-4f;
    te = sr.hit > 0.5f ? t : sr.t_min;
  }
  V3 pt = v3(r.ox, r.oy, r.oz);
  if (live) pt = v3(r.ox + r.dx * te, r.oy + r.dy * te, r.oz + r.dz * te);

  // --- primal: taps (recorded), normal, Lambert ----------------------------
  const float e = p.eps;
  const V3 taps[4] = {v3(1.0f, -1.0f, -1.0f), v3(-1.0f, -1.0f, 1.0f),
                      v3(-1.0f, 1.0f, -1.0f), v3(1.0f, 1.0f, 1.0f)};
  V3 n = v3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 4; ++k) {
    const V3 q = v3(pt.x + taps[k].x * e, pt.y + taps[k].y * e,
                    pt.z + taps[k].z * e);
    n = add(n, scale(taps[k], tape_forward(tp, q, rec, tap_set(tp, MATS, k))));
  }
  const float ninv = 1.0f / sqrtf(n.x * n.x + n.y * n.y + n.z * n.z + 1e-20f);
  const V3 tl = v3(pt.x - p.light[0], pt.y - p.light[1], pt.z - p.light[2]);
  const float linv =
      1.0f / sqrtf(tl.x * tl.x + tl.y * tl.y + tl.z * tl.z + 1e-20f);
  const float dotv = dot(n, tl);
  const float sn = ninv * linv;
  const float diff0 = dotv * sn;
  const float diff = fmaxf(diff0, p.ambient);

  // --- adjoint of the shading ----------------------------------------------
  const float gcol[3] = {gr, gg, gb};
  float gdiff = 0.0f;
  float alb[3] = {p.albedo[0], p.albedo[1], p.albedo[2]};
  float galb[3];
  // The albedo at the surface point (the forward's scene_color, un-gated as
  // the reference's backward is), recorded in the colour set.
  if constexpr (MATS) color_forward_rec(tp, pt, p.albedo, alb, rec, colour_set(tp));
  float fc[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (SOFT) floor_colour(r, p, fc);
  const float galpha = colour_adj<SOFT>(gcol, alb, diff, alpha, fc, gdiff, galb);
  float gsm = 0.0f;  // the cotangent of s_min
  if constexpr (SOFT)
    gsm = alpha_adj(sr.s_min, p.min_dist, sr.beta_inv, alpha, galpha);
  V3 gp = v3(0.0f, 0.0f, 0.0f);
  if constexpr (MATS)  // through the painted albedo
    gp = color_adjoint(tp, rec, colour_set(tp), op_base, pt, p.albedo, galb, acc);
  float gdiff0, gamb;
  max_adj(diff0, p.ambient, gdiff, gdiff0, gamb);
  const float gdot = gdiff0 * sn;
  const float gsn = gdiff0 * dotv;
  const float gN2 = -0.5f * ninv * ninv * ninv * (gsn * linv);
  const float gL2 = -0.5f * linv * linv * linv * (gsn * ninv);
  const V3 gn = add(scale(tl, gdot), scale(n, 2.0f * gN2));
  gp = add(gp, add(scale(n, gdot), scale(tl, 2.0f * gL2)));  // the light
  for (int k = 0; k < 4; ++k) {
    const V3 q = v3(pt.x + taps[k].x * e, pt.y + taps[k].y * e,
                    pt.z + taps[k].z * e);
    gp = add(gp, tape_reverse<true>(tp, rec, tap_set(tp, MATS, k), op_base, q,
                                    dot(taps[k], gn), acc));
  }
  const float gt = dot(gp, d);
  V3 go = gp;
  V3 gd = live ? scale(gp, te) : v3(0.0f, 0.0f, 0.0f);

  // --- implicit-function term (hit rays; their surface point is o + d t) ---
  bool implicit = true;
  if constexpr (SOFT) implicit = sr.hit > 0.0f;
  if (acc.any(implicit)) {
    // The records at the surface point: the colour walk's, or one pass.
    RecSet hs;
    if constexpr (MATS) {
      hs = colour_set(tp);
    } else {
      hs = tap_set(tp, MATS, 0);
      tape_forward(tp, pt, rec, hs);
    }
    const V3 gradF = tape_reverse<false>(tp, rec, hs, op_base, pt,
                                         implicit ? 1.0f : 0.0f, acc);
    const float fdot = dot(gradF, d);
    const float denom =
        fabsf(fdot) > clamp ? fdot : (fdot >= 0.0f ? clamp : -clamp);
    const float w = implicit ? -gt / denom : 0.0f;
    const V3 gq = tape_reverse<true>(tp, rec, hs, op_base, pt, w, acc);
    go = add(go, gq);
    gd = add(gd, scale(gq, t));
  }

  // --- envelope term at the frozen closest approach (soft) ----------------
  if constexpr (SOFT) {
    if (acc.any(gsm != 0.0f)) {
      const V3 pe = v3(r.ox + r.dx * sr.t_min, r.oy + r.dy * sr.t_min,
                       r.oz + r.dz * sr.t_min);
      const RecSet es = tap_set(tp, MATS, 1);
      tape_forward(tp, pe, rec, es);
      const V3 gq = tape_reverse<true>(tp, rec, es, op_base, pe, gsm, acc);
      go = add(go, gq);
      gd = add(gd, scale(gq, sr.t_min));
    }
  }

  // --- camera: o = cam[0:3], d = rotate(cam[3:7], vn) ----------------------
  const float qw = __ldg(cam + 3);
  const V3 qu = v3(__ldg(cam + 4), __ldg(cam + 5), __ldg(cam + 6));
  V3 gvn, gu;
  float gw;
  qrot_adj(qw, qu, vn, gd, gvn, gw, gu);
  gcam[0] += go.x;
  gcam[1] += go.y;
  gcam[2] += go.z;
  gcam[3] += gw;
  gcam[4] += gu.x;
  gcam[5] += gu.y;
  gcam[6] += gu.z;
}

}  // namespace rmt
