// Backward of the fused render: the gradient of sum(img * g_img) with
// respect to the leaf bank, the op words and the camera, from the forward's
// per-ray residuals (t, hit). Plain C interface for ctypes.
//
// fused_bwd_kernel and fused_bwd_long_kernel replace raymarch_tpu/ops/
// pallas_grad.py: make_fused_render_vjp.bwd_kernel (1432, launched at 1809)
// in its legacy (unrolled, hard) form, for any static tape, painted or not.
// Per AA ray that hit, with g the pixel's cotangent over S:
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
// floor, piecewise constant in the camera (1701-1730), so it returns at
// once; the Pallas kernel's per-tile skip is a coarser form of the same.
//
// The SOFT builds (soft-coverage mode, pallas_grad.py:1510-1597, 1683-1743)
// read the closest-approach residuals (s_min, t_min) too and run every ray
// that hit or whose coverage exceeds 1e-4 * min(1, beta) (soft_work, a
// per-ray form of the reference's per-tile gate): the coverage blend's
// adjoint, the implicit term on hit rays and the envelope term at o + d
// t_min, one more scene adjoint per ray (ray_backward, scene_grad.cuh).
//
// The gradient is a sum over 33 M rays of NSCAL = 16 n_rows + n_real + 7
// words, in one of two builds (ops/cuda_grad.py GradLayout.long chooses):
// - fused_bwd_kernel (tapes of at most MAX_BWD_INSTR instructions whose
//   rows fit): each thread keeps its own running sum of every word in
//   shared memory (word k of thread t at k * (blockDim + 1) + t: no bank
//   conflicts, no atomics) and its reverse records in a local array;
// - fused_bwd_long_kernel (any length; nscal up to a block's shared
//   memory, ~58k words): the reverse records sit in the thread's slice of a
//   device-memory History, the sums in one shared row per block filled with
//   atomics.
// Both run one body (ray_backward, scene_grad.cuh), whose sweeps skip every
// leaf and op whose cotangent is exactly zero (the losers of hard unions).
// At the end each block writes one partial row, and bwd_finalize_kernel
// sums the partial rows in a fixed order.
//
// What bounds it on an H100: instruction issue in the interpreted tape,
// run 4 + 6 times forward and 6 times backward per hit ray (the colour walk
// once more on a painted scene), and the reverse records: local memory in
// the per-thread build; in the long build 8 bytes per instruction per
// sweep written to device memory (6 KB per hit ray at 127 instructions, 8.6
// KB with the colour walk's 20), read back only where the cotangent is not
// zero; it reads 8 bytes of residuals and 12 of cotangent per ray and
// writes nothing per ray.
#include <cuda_runtime.h>

#include "render_common.cuh"
#include "scene_grad.cuh"

namespace rmt {

constexpr int BWD_THREADS = 64;
constexpr int BWD_LONG_THREADS = 128;

// Adds to a thread's running sums in shared memory.
struct SharedAcc {
  float* base;  // word 0 of this thread
  int stride;   // blockDim.x + 1
  __device__ __forceinline__ void operator()(int k, float v) const {
    base[k * stride] += v;
  }
};

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

// Grid-stride over the AA rays of the band, in the fine kernel's lane order
// (row i, then q = j * S + s). Writes one partial row of nscal words per
// block. MATS: the scene is painted (the albedo words); SOFT: soft coverage.
template <bool MATS, bool SOFT>
__global__ void fused_bwd_kernel(SceneView sc, const int* __restrict__ push_slot,
                                 const float* __restrict__ cam, RenderParams p,
                                 float clamp, const float* __restrict__ t_in,
                                 const float* __restrict__ hit_in,
                                 const float* __restrict__ g_img, int nscal,
                                 int op_base, int cam_base,
                                 float* __restrict__ partials, SoftRes soft) {
  extern __shared__ float acc_s[];
  const int tid = threadIdx.x;
  const int stride = blockDim.x + 1;
  for (int k = 0; k < nscal; ++k) acc_s[k * stride + tid] = 0.0f;
  SharedAcc acc{acc_s + tid, stride};
  float rec_v[(MATS ? REC_PER_INSTR_MATS : REC_PER_INSTR) * MAX_BWD_INSTR];
  const LocalBuf rec{rec_v};

  const int S = p.naa * p.naa;
  const long long row_lanes = (long long)p.width * S;
  const long long total = row_lanes * p.rows;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + tid; g < total;
       g += step) {
    RayIn<SOFT> ray;
    if (!ray_residuals(hit_in, soft, p, g, ray)) continue;
    const int i = (int)(g / row_lanes);
    const int q = (int)(g - (long long)i * row_lanes);
    const int j = q / S;
    const int s = q - j * S;
    const float* gi = g_img + ((size_t)i * p.width + j) * 3;
    ray_backward<MATS>(sc, push_slot, cam, p, clamp, op_base, cam_base,
                             i, j, s, __ldg(t_in + g), ray,
                             __ldg(gi + 0) * p.inv_s, __ldg(gi + 1) * p.inv_s,
                             __ldg(gi + 2) * p.inv_s, rec, acc);
  }
  __syncthreads();
  for (int k = tid; k < nscal; k += blockDim.x) {
    float sum = 0.0f;
    for (int m = 0; m < blockDim.x; ++m) sum += acc_s[k * stride + m];
    partials[(size_t)blockIdx.x * nscal + k] = sum;
  }
}

// The long form: the same rays, the reverse records in the thread's slice
// of hist (hist_len floats: item h at hist[h * n_threads + thread]), and
// one partial row of nscal words per block, filled with shared-memory
// atomics (compact_bwd.cu's scheme), so neither the tape's length nor
// nscal meets the per-thread caps of fused_bwd_kernel.
template <bool MATS, bool SOFT>
__global__ void fused_bwd_long_kernel(SceneView sc,
                                      const int* __restrict__ push_slot,
                                      const float* __restrict__ cam,
                                      RenderParams p, float clamp,
                                      const float* __restrict__ t_in,
                                      const float* __restrict__ hit_in,
                                      const float* __restrict__ g_img,
                                      int nscal, int op_base, int cam_base,
                                      float* __restrict__ hist,
                                      float* __restrict__ partials,
                                      SoftRes soft) {
  extern __shared__ float acc_s[];
  for (int k = threadIdx.x; k < nscal; k += blockDim.x) acc_s[k] = 0.0f;
  __syncthreads();
  BlockAcc acc{acc_s};

  const long long step = (long long)gridDim.x * blockDim.x;
  const long long me = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const History h{hist + me, step, 0};
  const int S = p.naa * p.naa;
  const long long row_lanes = (long long)p.width * S;
  const long long total = row_lanes * p.rows;
  for (long long g = me; g < total; g += step) {
    RayIn<SOFT> ray;
    if (!ray_residuals(hit_in, soft, p, g, ray)) continue;
    const int i = (int)(g / row_lanes);
    const int q = (int)(g - (long long)i * row_lanes);
    const int j = q / S;
    const int s = q - j * S;
    const float* gi = g_img + ((size_t)i * p.width + j) * 3;
    ray_backward<MATS>(sc, push_slot, cam, p, clamp, op_base, cam_base,
                             i, j, s, __ldg(t_in + g), ray,
                             __ldg(gi + 0) * p.inv_s, __ldg(gi + 1) * p.inv_s,
                             __ldg(gi + 2) * p.inv_s, h, acc);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nscal; k += blockDim.x)
    partials[(size_t)blockIdx.x * nscal + k] = acc_s[k];
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

}  // namespace rmt

extern "C" {

// Launches the legacy backward, then bwd_finalize_kernel into out
// f32[nscal]. hist null: fused_bwd_kernel (BWD_THREADS threads, a shared
// row of nscal words per thread, the tape within MAX_BWD_INSTR); else
// fused_bwd_long_kernel (BWD_LONG_THREADS threads, hist_len floats of hist
// per thread, hist holding max_blocks * BWD_LONG_THREADS * hist_len).
// mats != 0 routes the albedo words of a painted scene; a soft argument
// with non-null residuals (s_min, t_min) runs the soft builds. partials
// must hold max_blocks * nscal floats. Returns the first failing
// cudaError_t (0 = success).
int rmt_fused_bwd_launch(const float* leaf_params, const int* row_kind,
                         const int* tape, int n_instr, const float* op_param,
                         const int* push_slot, const float* cam,
                         const rmt::RenderParams* params, float clamp,
                         const float* t_in, const float* hit_in,
                         const float* g_img, int nscal, int op_base,
                         int cam_base, int mats, const rmt::SoftRes* soft,
                         float* hist, float* partials, int max_blocks,
                         float* out, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  cudaStream_t st = (cudaStream_t)stream;
  const rmt::SoftRes sr = *soft;
  const bool is_soft = sr.s_min != nullptr;
  if (is_soft != (sr.t_min != nullptr)) return (int)cudaErrorInvalidValue;
  long long grid = 0;
  cudaError_t err;
  if (hist == nullptr) {
    const int threads = rmt::BWD_THREADS;
    const size_t smem = (size_t)nscal * (threads + 1) * sizeof(float);
    const auto kernel =
        is_soft ? (mats ? rmt::fused_bwd_kernel<true, true>
                        : rmt::fused_bwd_kernel<false, true>)
                : (mats ? rmt::fused_bwd_kernel<true, false>
                        : rmt::fused_bwd_kernel<false, false>);
    err = rmt::launch_resident(kernel, threads, smem, p, max_blocks, st, &grid,
                               sc, push_slot, cam, p, clamp, t_in, hit_in,
                               g_img, nscal, op_base, cam_base, partials, sr);
  } else {
    const int threads = rmt::BWD_LONG_THREADS;
    const size_t smem = (size_t)nscal * sizeof(float);
    const auto kernel =
        is_soft ? (mats ? rmt::fused_bwd_long_kernel<true, true>
                        : rmt::fused_bwd_long_kernel<false, true>)
                : (mats ? rmt::fused_bwd_long_kernel<true, false>
                        : rmt::fused_bwd_long_kernel<false, false>);
    err = rmt::launch_resident(kernel, threads, smem, p, max_blocks, st, &grid,
                               sc, push_slot, cam, p, clamp, t_in, hit_in,
                               g_img, nscal, op_base, cam_base, hist,
                               partials, sr);
  }
  if (err != cudaSuccess) return (int)err;
  rmt::bwd_finalize_kernel<<<(nscal + 127) / 128, 128, 0, st>>>(
      partials, (int)grid, nscal, out);
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
