// Backward of the fused render: the gradient of sum(img * g_img) with
// respect to the leaf bank, the op words and the camera, from the forward's
// per-ray residuals (t, hit). Plain C interface for ctypes.
//
// fused_bwd_kernel replaces raymarch_tpu/ops/pallas_grad.py:
// make_fused_render_vjp.bwd_kernel (1432, launched at 1809) in its legacy
// (unrolled, hard, material-free) form. Per AA ray that hit, with g the
// pixel's cotangent over S:
//   1. replay raygen from cam[0:7] (the raw quaternion, 1404-1421), the hit
//      point p = o + d t, the 4 tetrahedron taps, the normal and Lambert
//      term, c = sqrt(albedo * diff + 1e-12) (shade_loss, 1600-1651);
//   2. run its adjoint: g_c -> g_diff -> g_n; tap k's value gets k . g_n
//      and goes through the scene adjoint at p + eps k; the light vector
//      adds g_p directly; g_t = g_p . d; the camera gets g_p through o and
//      through d t;
//   3. the implicit-function term (1662-1696): fdot = grad_x F(p) . d, its
//      denominator clamped to +-grad_denom_clamp, w = -g_t / denom, and one
//      more scene adjoint at p with seed w feeds theta and the camera.
// A ray that missed contributes exactly zero: its colour is the checker
// floor, piecewise constant in the camera (1701-1730), so it returns at
// once; the Pallas kernel's per-tile skip is a coarser form of the same.
//
// The gradient is a sum over 33 M rays of NSCAL = 16 n_rows + n_real + 7
// words. Each thread keeps its own running sum of every word in shared
// memory (word k of thread t at k * (blockDim + 1) + t: no bank conflicts,
// no atomics) while a grid-stride loop hands it rays; at the end the block
// sums its threads into one partial row, and bwd_finalize_kernel sums the
// partial rows in a fixed order.
//
// What bounds it on an H100: instruction issue in the interpreted tape,
// run 4 + 2 times forward and backward per hit ray, and the per-thread
// local records of the reverse sweep; it reads 8 bytes of residuals and 12
// of cotangent per ray and writes nothing per ray.
#include <cuda_runtime.h>

#include "render_common.cuh"
#include "scene_grad.cuh"

namespace rmt {

constexpr int BWD_THREADS = 64;

// Adds to a thread's running sums in shared memory.
struct SharedAcc {
  float* base;  // word 0 of this thread
  int stride;   // blockDim.x + 1
  __device__ __forceinline__ void operator()(int k, float v) const {
    base[k * stride] += v;
  }
};

// Grid-stride over the AA rays of the band, in the fine kernel's lane order
// (row i, then q = j * S + s). Writes one partial row of nscal words per
// block.
__global__ void fused_bwd_kernel(SceneView sc, const int* __restrict__ push_slot,
                                 const float* __restrict__ cam, RenderParams p,
                                 float clamp, const float* __restrict__ t_in,
                                 const float* __restrict__ hit_in,
                                 const float* __restrict__ g_img, int nscal,
                                 int op_base, int cam_base,
                                 float* __restrict__ partials) {
  extern __shared__ float acc_s[];
  const int tid = threadIdx.x;
  const int stride = blockDim.x + 1;
  for (int k = 0; k < nscal; ++k) acc_s[k * stride + tid] = 0.0f;
  SharedAcc acc{acc_s + tid, stride};

  const int S = p.naa * p.naa;
  const long long row_lanes = (long long)p.width * S;
  const long long total = row_lanes * p.rows;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + tid; g < total;
       g += step) {
    if (!(__ldg(hit_in + g) > 0.0f)) continue;
    const int i = (int)(g / row_lanes);
    const int q = (int)(g - (long long)i * row_lanes);
    const int j = q / S;
    const int s = q - j * S;
    const float* gi = g_img + ((size_t)i * p.width + j) * 3;
    ray_backward(sc, push_slot, cam, p, clamp, op_base, cam_base, i, j, s,
                 __ldg(t_in + g), __ldg(gi + 0) * p.inv_s,
                 __ldg(gi + 1) * p.inv_s, __ldg(gi + 2) * p.inv_s, acc);
  }
  __syncthreads();
  for (int k = tid; k < nscal; k += blockDim.x) {
    float sum = 0.0f;
    for (int m = 0; m < blockDim.x; ++m) sum += acc_s[k * stride + m];
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

}  // namespace rmt

extern "C" {

// Launches fused_bwd_kernel, then bwd_finalize_kernel into out f32[nscal].
// partials must hold max_blocks * nscal floats. Returns the first failing
// cudaError_t (0 = success).
int rmt_fused_bwd_launch(const float* leaf_params, const int* row_kind,
                         const int* tape, int n_instr, const float* op_param,
                         const int* push_slot, const float* cam,
                         const rmt::RenderParams* params, float clamp,
                         const float* t_in, const float* hit_in,
                         const float* g_img, int nscal, int op_base,
                         int cam_base, float* partials, int max_blocks,
                         float* out, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  const int threads = rmt::BWD_THREADS;
  const size_t smem = (size_t)nscal * (threads + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rmt::fused_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, rmt::fused_bwd_kernel, threads, smem)) != cudaSuccess)
    return (int)err;
  const long long total = (long long)p.width * p.naa * p.naa * p.rows;
  const long long chunks = (total + threads - 1) / threads;
  long long grid = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  if (grid > max_blocks) grid = max_blocks;
  if (grid > chunks) grid = chunks;
  if (grid < 1) grid = 1;
  rmt::fused_bwd_kernel<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(
      sc, push_slot, cam, p, clamp, t_in, hit_in, g_img, nscal, op_base,
      cam_base, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rmt::bwd_finalize_kernel<<<(nscal + 127) / 128, 128, 0,
                             (cudaStream_t)stream>>>(partials, (int)grid,
                                                     nscal, out);
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
