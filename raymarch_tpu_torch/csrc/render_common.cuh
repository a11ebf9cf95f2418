// What the render kernels share: the renderer's host constants, ray
// generation from the camera vector, and the device view of a scene.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "scene_eval.cuh"

namespace rmt {

// Host constants of one renderer; the layout is mirrored by
// raymarch_tpu_torch/ops/cuda_prepass.py:_CParams (ctypes), field by field.
struct RenderParams {
  int32_t width;       // image width in pixels
  int32_t height;      // full image height (screen y scale)
  int32_t rows;        // rows rendered: the band starts at cam[7]
  int32_t naa;         // AA samples per axis; S = naa * naa per pixel
  int32_t max_iter;    // march step budget
  int32_t use_bound;   // cfg.bound_accel
  int32_t no_prepass;  // fine pass: t0 = 0, every ray live
  float min_dist;
  float max_dist;
  float omega;       // coarse cone half-angle bound (cone_omega, block B)
  float inv1w;       // f32(1 / (1 + omega))
  float tan_aspect;  // f32(tan(fovy/2) * W/H)
  float tanf;        // f32(tan(fovy/2))
  float c2w;         // f32(2 / width)
  float c2h;         // f32(2 / height)
  float eps;         // normal tap offset
  float light[3];
  float albedo[3];
  float floor_base[3];
  float floor_y;
  float floor_checker;
  float ambient;
  float inv_s;  // f32(1 / S)
  float relax;       // f32(cfg.relax); > 1 takes the relaxed fine march
  float relax_back;  // f32(1 - cfg.relax): the step back after an overshoot
};

// The prepass geometry beyond the per-pixel first-near prepass, the last
// argument of the prepass kernels. It is kept out of RenderParams, the
// argument of every kernel (the backward ones too): ptxas allocated 5 fewer
// or 2 more registers in untouched builds when that struct grew. Mirrored
// by cuda_prepass.py:_CBlockParams.
struct BlockParams {
  int32_t block;   // B: the coarse pass marches one cone per B x B block
  int32_t ni;      // near intervals per block (0: the first-near prepass)
  int32_t chain;   // the chained pixel pass refines the block planes
  int32_t brows;   // ceil(rows / B): the block grid of the coarse planes
  int32_t bcols;   // ceil(width / B)
  float omega_px;  // the pixel cone's half-angle (cone_omega, block 1)
  float inv1w_px;  // f32(1 / (1 + omega_px))
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Screen point (x, y) -> world ray from the camera (pallas_prepass.py
// _view_dirs, 696-711). cam = (pos3, quat wxyz, row_offset).
__device__ __forceinline__ Ray view_ray(const float* __restrict__ cam,
                                        const RenderParams& p, float x,
                                        float y) {
  float vx = x * p.tan_aspect;
  float vy = y * p.tanf;
  float vz = -1.0f;
  const float inv_norm = 1.0f / sqrtf(vx * vx + vy * vy + vz * vz);
  vx = vx * inv_norm;
  vy = vy * inv_norm;
  vz = vz * inv_norm;
  const float qw = __ldg(cam + 3), qx = __ldg(cam + 4), qy = __ldg(cam + 5),
              qz = __ldg(cam + 6);
  const float tx = 2.0f * (qy * vz - qz * vy);
  const float ty = 2.0f * (qz * vx - qx * vz);
  const float tz = 2.0f * (qx * vy - qy * vx);
  Ray r;
  r.dx = vx + qw * tx + (qy * tz - qz * ty);
  r.dy = vy + qw * ty + (qz * tx - qx * tz);
  r.dz = vz + qw * tz + (qx * ty - qy * tx);
  r.ox = __ldg(cam + 0);
  r.oy = __ldg(cam + 1);
  r.oz = __ldg(cam + 2);
  return r;
}

inline SceneView make_scene(const float* leaf_params, const int* row_kind,
                            const int* tape, int n_instr,
                            const float* op_param, float max_dist) {
  // tape = i32[3, n_instr]: opcodes, leaf rows, stack slots.
  SceneView sc;
  sc.leaf_params = leaf_params;
  sc.row_kind = row_kind;
  sc.tape_ops = tape;
  sc.tape_arg = tape + n_instr;
  sc.out_slot = tape + 2 * n_instr;
  sc.op_param = op_param;
  sc.n_instr = n_instr;
  sc.max_dist = max_dist;
  return sc;
}

// Launches `kernel` (a grid-stride loop over the AA rays of the band of p)
// with `threads` threads and `smem` bytes of dynamic shared memory on as
// many blocks as the card keeps resident (at most max_blocks, at most one
// per `threads` rays); the grid goes to *grid. The backward kernels' launch.
template <class Kernel, class... Args>
cudaError_t launch_resident(Kernel kernel, int threads, size_t smem,
                            const RenderParams& p, int max_blocks,
                            cudaStream_t stream, long long* grid,
                            Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  const long long total = (long long)p.width * p.naa * p.naa * p.rows;
  const long long chunks = (total + threads - 1) / threads;
  long long g = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  if (g > max_blocks) g = max_blocks;
  if (g > chunks) g = chunks;
  if (g < 1) g = 1;
  kernel<<<(unsigned)g, threads, smem, stream>>>(args...);
  *grid = g;
  return cudaGetLastError();
}

}  // namespace rmt
