// Backward of the fused render: the gradient of sum(img * g_img) with
// respect to the leaf bank, the op words and the camera, from the forward's
// per-ray residuals (t, hit). Plain C interface for ctypes.
//
// fused_bwd_kernel replaces raymarch_tpu/ops/pallas_grad.py:
// make_fused_render_vjp.bwd_kernel (1432, launched at 1809) in its legacy
// (unrolled, hard) form, for any static tape, painted or not. Per AA ray
// that hit, with g the pixel's cotangent over S:
//   1. replay raygen from cam[0:7] (the raw quaternion, 1404-1421), the hit
//      point p = o + d t, the 4 tetrahedron taps, the normal and Lambert
//      term, c = sqrt(albedo * diff + 1e-12) (shade_loss, 1600-1651); on a
//      painted scene (MATS) the albedo is the colour walk's at p
//      (_albedo_tile, 1386-1402);
//   2. run its adjoint: g_c -> g_diff -> g_n; tap k's value gets k . g_n
//      and goes through the scene adjoint at p + eps k; the light vector
//      adds g_p directly; with MATS the albedo's cotangent goes through the
//      colour walk's adjoint to the albedo and flag words and, through the
//      smooth blend weights, to the geometry, the blend radii and g_p;
//      g_t = g_p . d; the camera gets g_p through o and through d t;
//   3. the implicit-function term (1662-1696): fdot = grad_x F(p) . d, its
//      denominator clamped to +-grad_denom_clamp, w = -g_t / denom, and one
//      more scene adjoint at p with seed w feeds theta and the camera.
// A ray that missed contributes exactly zero: its colour is the checker
// floor, piecewise constant in the camera (1701-1730); the Pallas kernel's
// per-tile skip is a coarser form of the same.
//
// The SOFT builds (soft-coverage mode, pallas_grad.py:1510-1597, 1683-1743)
// read the closest-approach residuals (s_min, t_min) too and run every ray
// that hit or whose coverage exceeds 1e-4 * min(1, beta) (soft_work, a
// per-ray form of the reference's per-tile gate): the coverage blend's
// adjoint, the implicit term on hit rays and the envelope term at o + d
// t_min, one more scene adjoint per ray (ray_backward, scene_grad.cuh).
//
// The design (scene_grad.cuh). Each warp takes 32 consecutive AA rays at a
// time, in the fine kernel's lane order (row i, then q = j * S + s: two
// pixels' 16 samples, which mostly reach the same leaves), and keeps its
// lanes converged through the ray's backward: a lane whose ray does no
// work runs with a zero cotangent. The tape is read packed, one 16-byte
// word per instruction; each ray evaluates it forward 5 times (the taps,
// recorded in the primal pass, and the surface point, whose records serve
// its two sweeps) and backward 6 times; the reverse records are 2 bits per
// hard op and one float per smooth op (4 in the colour walk), in a slice
// of shared memory per thread, or in device memory where a tape's records
// would crowd the block out of shared memory (ops/cuda_grad.py GradLayout
// .rec_in_smem). The gradient is a sum over 33 M rays of nscal = 16 n_rows +
// n_real + 7 words:
// - ROWS (the per-thread build): every thread keeps its own running sum of
//   every word in shared memory (word k of thread t at k * (blockDim + 1) +
//   t: no bank conflicts, no atomics), for tapes of at most 64 instructions
//   and rows of at most 126 words (ops/cuda_grad.py GradLayout.long), where
//   it beats the warp-row build (measured in PERF.md);
// - otherwise warp-aggregated adds (WarpRow) into one row per block in
//   shared memory, or, where nscal exceeds a block's shared memory, into
//   the output in device memory: the row has no size cap.
// At the end each block writes its partial row, and bwd_finalize_kernel
// sums the partial rows in a fixed order (not when the row is the output).
//
// What bounds it on an H100: instruction issue in the interpreted tape, 5
// forward and 6 reverse passes per hit ray (with every tap replayed before
// its sweep, 11 forward passes were its time: PERF.md); it reads 8 bytes of
// residuals and 12 of cotangent per ray and writes nothing per ray.
#include <cuda_runtime.h>

#include "render_common.cuh"
#include "scene_grad.cuh"

namespace rmt {

constexpr int BWD_THREADS = 64;        // the per-thread build
constexpr int BWD_WARP_THREADS = 128;  // the warp-row build

// What ray_backward reads of a ray beyond t: nothing (hard), or its soft
// residuals.
template <bool SOFT>
using RayIn = std::conditional_t<SOFT, SoftRay, NoSoft>;

// Reads ray g's residuals beyond t; false when the ray does no work (a
// miss; soft: soft_work fails).
__device__ __forceinline__ bool ray_residuals(const float* __restrict__ hit_in,
                                              const SoftRes&,
                                              const RenderParams&, long long g,
                                              NoSoft&) {
  return __ldg(hit_in + g) > 0.0f;
}
__device__ __forceinline__ bool ray_residuals(const float* __restrict__ hit_in,
                                              const SoftRes& sr,
                                              const RenderParams& p,
                                              long long g, SoftRay& ray) {
  ray.hit = __ldg(hit_in + g);
  ray.s_min = __ldg(sr.s_min + g);
  ray.t_min = __ldg(sr.t_min + g);
  ray.beta_inv = sr.beta_inv;
  return soft_work(ray.hit, soft_alpha(ray.s_min, p.min_dist, sr.beta_inv),
                   sr.gate);
}

// Each warp walks 32 consecutive AA rays of the band at a time (grid-stride
// over warps) and keeps its lanes converged. ROWS: per-thread rows in
// shared memory; else one row per block, in shared memory or, with
// row_out, the output in device memory. rec null: the records sit in
// shared memory after the rows (rec_words per thread), else in rec (a
// slice per thread of the launch). Writes one partial row of nscal words
// per block unless row_out is given. MATS: the scene is painted (the
// albedo words); SOFT: soft coverage.
template <bool MATS, bool SOFT, bool ROWS>
__global__ void fused_bwd_kernel(BwdTape tp, const float* __restrict__ cam,
                                 RenderParams p, float clamp,
                                 const float* __restrict__ t_in,
                                 const float* __restrict__ hit_in,
                                 const float* __restrict__ g_img, int nscal,
                                 int op_base, int cam_base, uint32_t* rec_g,
                                 float* row_out,
                                 float* __restrict__ partials, SoftRes soft) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  // The rows: a row per thread, one per block, or none (row_out).
  const int row_floats = ROWS ? nscal * (T + 1) : (row_out ? 0 : nscal);
  for (int k = tid; k < row_floats; k += T) smem[k] = 0.0f;
  __syncthreads();
  const long long me = (long long)blockIdx.x * T + tid;
  const RecStore rec =
      rec_g != nullptr
          ? RecStore{rec_g + me, (long long)gridDim.x * T}
          : RecStore{reinterpret_cast<uint32_t*>(smem + row_floats) + tid, T};
  using Acc = std::conditional_t<ROWS, ThreadRows, WarpRow>;
  Acc acc;
  if constexpr (ROWS) {
    acc = ThreadRows{smem + tid, T + 1};
  } else {
    acc = WarpRow{row_out ? row_out : smem};
  }

  float gcam[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int S = p.naa * p.naa;
  const long long row_lanes = (long long)p.width * S;
  const long long total = row_lanes * p.rows;
  const int lane = tid & 31;
  const long long warps = (long long)gridDim.x * (T >> 5);
  for (long long base = (me >> 5) << 5; base < total; base += warps << 5) {
    const long long g = base + lane < total ? base + lane : total - 1;
    RayIn<SOFT> ray;
    const bool work =
        ray_residuals(hit_in, soft, p, g, ray) && base + lane < total;
    if (!__any_sync(FULL_MASK, work)) continue;
    if constexpr (SOFT) {
      if (!work) ray.hit = 0.0f;  // no implicit term either
    }
    const int i = (int)(g / row_lanes);
    const int q = (int)(g - (long long)i * row_lanes);
    const int j = q / S;
    const int s = q - j * S;
    const float* gi = g_img + ((size_t)i * p.width + j) * 3;
    const float sc = work ? p.inv_s : 0.0f;
    ray_backward<MATS>(tp, cam, p, clamp, op_base, i, j, s, __ldg(t_in + g),
                       ray, __ldg(gi + 0) * sc, __ldg(gi + 1) * sc,
                       __ldg(gi + 2) * sc, rec, acc, gcam);
  }
  acc.camera(cam_base, gcam);
  if (row_out) return;
  __syncthreads();
  for (int k = tid; k < nscal; k += T) {
    float sum = 0.0f;
    if constexpr (ROWS) {
      for (int m = 0; m < T; ++m) sum += smem[k * (T + 1) + m];
    } else {
      sum = smem[k];
    }
    partials[(size_t)blockIdx.x * nscal + k] = sum;
  }
}

// out[k] = sum over blocks of partials[b, k], in block order.
__global__ void bwd_finalize_kernel(const float* __restrict__ partials,
                                    int n_blocks, int nscal,
                                    float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nscal) return;
  float sum = 0.0f;
  for (int b = 0; b < n_blocks; ++b) sum += partials[(size_t)b * nscal + k];
  out[k] = sum;
}

// The gradient row and record words of one legacy backward launch.
struct BwdShape {
  int nscal, op_base, cam_base;
  int n_smooth;   // smooth ops of the tape
  int rows;       // 1: per-thread rows (the per-thread build)
  int row_smem;   // 1: the block's row in shared memory; 0: the output
  int rec_smem;   // 1: the records in shared memory; 0: in rec
};

template <bool MATS, bool SOFT, bool ROWS>
cudaError_t launch_fused_bwd(const BwdTape& tp, const float* cam,
                             const RenderParams& p, float clamp,
                             const float* t_in, const float* hit_in,
                             const float* g_img, const BwdShape& sh,
                             uint32_t* rec, float* partials, int max_blocks,
                             float* out, const SoftRes& sr, cudaStream_t st,
                             long long* grid) {
  const int threads = ROWS ? BWD_THREADS : BWD_WARP_THREADS;
  const int words = rec_words(tp.n, tp.n_smooth, MATS);
  const size_t row_floats = ROWS ? (size_t)sh.nscal * (threads + 1)
                                 : (sh.row_smem ? (size_t)sh.nscal : 0);
  const size_t smem =
      (row_floats + (sh.rec_smem ? (size_t)words * threads : 0)) * 4;
  return launch_resident(fused_bwd_kernel<MATS, SOFT, ROWS>, threads, smem, p,
                         max_blocks, st, grid, tp, cam, p, clamp, t_in, hit_in,
                         g_img, sh.nscal, sh.op_base, sh.cam_base,
                         sh.rec_smem ? nullptr : rec,
                         sh.row_smem ? nullptr : out, partials, sr);
}

}  // namespace rmt

extern "C" {

// Launches the legacy backward into out f32[nscal]. ins is the packed tape
// i32[n_instr, 4] (op | slot << 8, leaf row, row kind, gradient slot);
// shape gives the gradient row's layout and the routes: rows != 0 the
// per-thread build (BWD_THREADS threads), else the warp-row build
// (BWD_WARP_THREADS) with the block's row in shared memory (row_smem) or
// added straight into out (which the launcher zeroes first); rec_smem == 0
// keeps each thread's records in rec, rec_words(n_instr, n_smooth, mats)
// words per thread of max_blocks blocks. mats != 0 routes the albedo words
// of a painted scene; a soft argument with non-null residuals (s_min,
// t_min) runs the soft builds. partials holds max_blocks * nscal floats;
// bwd_finalize_kernel then sums them into out. Returns the first failing
// cudaError_t (0 = success).
int rmt_fused_bwd_launch(const float* leaf_params, const int* ins, int n_instr,
                         const float* op_param, const int* shape,
                         const float* cam, const rmt::RenderParams* params,
                         float clamp, const float* t_in, const float* hit_in,
                         const float* g_img, int mats,
                         const rmt::SoftRes* soft, unsigned int* rec,
                         float* partials, int max_blocks, float* out,
                         void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::BwdShape sh{shape[0], shape[1], shape[2], shape[3],
                         shape[4], shape[5], shape[6]};
  const rmt::BwdTape tp{reinterpret_cast<const int4*>(ins), op_param,
                        leaf_params, n_instr, sh.n_smooth, p.max_dist};
  cudaStream_t st = (cudaStream_t)stream;
  const rmt::SoftRes sr = *soft;
  const bool is_soft = sr.s_min != nullptr;
  if (is_soft != (sr.t_min != nullptr) || (sh.rows && !sh.row_smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (!sh.row_smem &&
      (err = cudaMemsetAsync(out, 0, (size_t)sh.nscal * 4, st)) != cudaSuccess)
    return (int)err;
  long long grid = 0;
#define RMT_BWD(MATS, SOFT, ROWS)                                             \
  rmt::launch_fused_bwd<MATS, SOFT, ROWS>(tp, cam, p, clamp, t_in, hit_in,    \
                                          g_img, sh, rec, partials,           \
                                          max_blocks, out, sr, st, &grid)
  switch ((sh.rows ? 4 : 0) + (is_soft ? 2 : 0) + (mats ? 1 : 0)) {
    case 0: err = RMT_BWD(false, false, false); break;
    case 1: err = RMT_BWD(true, false, false); break;
    case 2: err = RMT_BWD(false, true, false); break;
    case 3: err = RMT_BWD(true, true, false); break;
    case 4: err = RMT_BWD(false, false, true); break;
    case 5: err = RMT_BWD(true, false, true); break;
    case 6: err = RMT_BWD(false, true, true); break;
    default: err = RMT_BWD(true, true, true); break;
  }
#undef RMT_BWD
  if (err != cudaSuccess || !sh.row_smem) return (int)err;
  rmt::bwd_finalize_kernel<<<(sh.nscal + 127) / 128, 128, 0, st>>>(
      partials, (int)grid, sh.nscal, out);
  return (int)cudaGetLastError();
}

// Launches bwd_finalize_kernel alone: out[k] = the sum of partials[b, k]
// over n_blocks rows, in block order (the compact backward's reduction).
int rmt_bwd_finalize_launch(const float* partials, int n_blocks, int nscal,
                            float* out, void* stream) {
  rmt::bwd_finalize_kernel<<<(nscal + 127) / 128, 128, 0,
                             (cudaStream_t)stream>>>(partials, n_blocks,
                                                     nscal, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
