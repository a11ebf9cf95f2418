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

// The ray setup below rounds every product and sum on its own
// (__fmul_rn/__fadd_rn never contract into an FMA), as the plain torch
// versions do: a ray direction or a floor point one ulp off flips the
// checker's parity near its edges (0.23 of a sample's colour) and moves a
// grazing ray's march. The march contracts only in the source built with
// nvcc's default (K3).

// Screen point (x, y) -> world ray from the camera (pallas_prepass.py
// _view_dirs, 696-711). cam = (pos3, quat wxyz, row_offset).
__device__ __forceinline__ Ray view_ray(const float* __restrict__ cam,
                                        const RenderParams& p, float x,
                                        float y) {
  float vx = x * p.tan_aspect;
  float vy = y * p.tanf;
  float vz = -1.0f;
  const float inv_norm =
      1.0f / sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)),
                             __fmul_rn(vz, vz)));
  vx = vx * inv_norm;
  vy = vy * inv_norm;
  vz = vz * inv_norm;
  const float qw = __ldg(cam + 3), qx = __ldg(cam + 4), qy = __ldg(cam + 5),
              qz = __ldg(cam + 6);
  const float tx = 2.0f * __fsub_rn(__fmul_rn(qy, vz), __fmul_rn(qz, vy));
  const float ty = 2.0f * __fsub_rn(__fmul_rn(qz, vx), __fmul_rn(qx, vz));
  const float tz = 2.0f * __fsub_rn(__fmul_rn(qx, vy), __fmul_rn(qy, vx));
  Ray r;
  r.dx = __fadd_rn(__fadd_rn(vx, __fmul_rn(qw, tx)),
                   __fsub_rn(__fmul_rn(qy, tz), __fmul_rn(qz, ty)));
  r.dy = __fadd_rn(__fadd_rn(vy, __fmul_rn(qw, ty)),
                   __fsub_rn(__fmul_rn(qz, tx), __fmul_rn(qx, tz)));
  r.dz = __fadd_rn(__fadd_rn(vz, __fmul_rn(qw, tz)),
                   __fsub_rn(__fmul_rn(qx, ty), __fmul_rn(qy, tx)));
  r.ox = __ldg(cam + 0);
  r.oy = __ldg(cam + 1);
  r.oz = __ldg(cam + 2);
  return r;
}

// Screen coordinates (x, y) of AA sample s of pixel (band row i, column j),
// in the f32 op order of pallas_prepass.py:1553-1562 (cuda_prepass.
// aa_screen): the fine kernel's and the backwards' rays.
__device__ __forceinline__ void aa_screen_xy(const float* __restrict__ cam,
                                             const RenderParams& p, int i,
                                             int j, int s, float& x,
                                             float& y) {
  const int a = s / p.naa;
  const int b = s - a * p.naa;
  const float fa = ((float)a + 0.5f) / (float)p.naa - 0.5f;
  const float fb = ((float)b + 0.5f) / (float)p.naa - 0.5f;
  x = __fadd_rn(2.0f * ((float)j + 0.5f) / (float)p.width - 1.0f,
                __fmul_rn(fa, p.c2w));
  y = __fadd_rn(
      1.0f - 2.0f * ((float)i + 0.5f + __ldg(cam + 7)) / (float)p.height,
      __fmul_rn(fb, p.c2h));
}

// The analytic checkerboard floor's colour of ray r (wgsl:117-128,
// pallas_prepass.py:1729-1742): the base colour plus the checker where the
// ray meets the plane y = floor_y ahead of it, else black. The checker
// rounds half to even with rintf, as jnp.round does. Piecewise constant in
// the camera: its derivative is zero.
__device__ __forceinline__ void floor_colour(const Ray& r, const RenderParams& p,
                                             float fc[3]) {
  const bool dy_ok = fabsf(r.dy) > 1e-8f;
  const float dy_safe = dy_ok ? r.dy : 1e-8f;
  const float ft = (p.floor_y - r.oy) / dy_safe;
  const float fx = fminf(fmaxf(__fadd_rn(r.ox, __fmul_rn(r.dx, ft)), -1e7f), 1e7f);
  const float fz = fminf(fmaxf(__fadd_rn(r.oz, __fmul_rn(r.dz, ft)), -1e7f), 1e7f);
  const int ipx = (int)rintf(fx + 0.5f);
  const int ipz = (int)rintf(fz + 0.5f);
  const float parity = (float)((ipx ^ ipz) & 1);
  const float on_floor = (ft > 0.0f && dy_ok) ? 1.0f : 0.0f;
  for (int c = 0; c < 3; ++c)
    fc[c] = (p.floor_base[c] + p.floor_checker * parity) * on_floor;
}

// The coverage of a soft-mode ray (shade_soft, march.py:250):
// exp(-max(s_min - min_dist, 0) / beta), 1 on a hit, 0.0 in f32 past ~104
// beta.
__device__ __forceinline__ float soft_alpha(float s_min, float min_dist,
                                            float beta_inv) {
  return expf(-fmaxf(s_min - min_dist, 0.0f) * beta_inv);
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

// The K1/K2 view of a scene: its packed words (int4-aligned) and leaf rows
// (float4-aligned, as the wrappers check), on stack route stk (REG_STACK or
// STK_SMEM) for a tape of stack depth stack_depth. False when the route
// does not hold the depth.
inline bool make_words(const float* leaf_params, const int* row_kind,
                       const int* words, int n_instr, const float* op_param,
                       float max_dist, int stk, int stack_depth,
                       SceneWords* sw) {
  if (stk == STK_SMEM ? stack_depth < 1
                      : stk != REG_STACK || stack_depth > REG_STACK)
    return false;
  sw->ins = reinterpret_cast<const int4*>(words);
  sw->leaf = reinterpret_cast<const float4*>(leaf_params);
  sw->row_kind = row_kind;
  sw->op_param = op_param;
  sw->n = n_instr;
  sw->rows = stack_depth - 1;
  sw->max_dist = max_dist;
  return true;
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
