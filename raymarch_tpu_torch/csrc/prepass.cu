// Cone-prepass forward render: the coarse (cone) kernel, the chained pixel
// cone kernel and the fine (march + shade + AA mean) kernel, with a plain C
// interface for ctypes.
//
// coarse_kernel replaces raymarch_tpu/ops/pallas_prepass.py:
// make_pallas_image_render_aa.coarse_kernel (885): one cone ray per pixel
// centre (KIND 0: B = 1, no intervals) or per B x B block (KIND 1, its centre
// at pixel coordinate (b + 0.5) * B), stopped at d < min_dist + omega*t,
// stepped by (d - omega*t)/(1+omega), clipped by the scene's bounding sphere
// (_cone_march_tile 130, _bound_clip 107); or (KIND 2) the centre ray's scan
// of the whole scene that records up to ni near intervals per block
// (_cone_interval_march_tile 191).
//
// coarse_px_kernel replaces coarse_px_kernel (969): with prepass_chain and
// B > 1, one cone ray per pixel at the pixel cone angle, from its block's
// stop distance (_cone_march_tile with t_in/live_in, 152-154), through the
// whole tape: un-culled, as the reference's.
//
// fine_kernel replaces fine_packed_kernel (1521) in its forward forms, hard
// and soft, and its march-only form (fine_march.cu): every AA ray sphere-
// traces from its pixel's t0 (_fine_march_tile 477, plain or, with
// relax > 1, over-relaxed), or (PRE 2) through its block's near intervals,
// jumping the gaps (_fine_march_interval_tile 296); hit rays
// take 4-tap tetrahedron normals (pallas_march._tet_taps 1049), Lambert
// shading, the analytic checker floor on a miss, sqrt gamma, and the AA mean.
// PRE 3 is the soft-coverage build (no prepass, relax 1): each ray marches
// from t = 0 keeping its closest approach (s_min, t_min)
// (_fine_march_tile_soft 380), and the coverage alpha =
// exp(-max(s_min - min_dist, 0) / beta) takes the place of the hit mask: the
// surface term sits at the march end on a hit, at t_min on a miss, at the
// ray's origin where alpha <= 1e-4, and the floor is blended by 1 - alpha
// (1696-1760). A ray of alpha exactly 0 skips the taps, exactly: its
// surface term enters multiplied by alpha.
// Block planes (PRE 1 and 2) are read at block (i / B, j / B): the
// reference's repeat of the planes to pixel resolution (1397-1406) as an
// index map. fine_kernel's body is in fine.cuh, coarse_kernel's in
// coarse.cuh: this file instantiates their static-tape hard builds,
// fine_soft.cu (compiled with -fmad=false) the soft ones and prepass_dyn.cu
// the DYN builds of both, which interpret the frame's dynamic tape.
//
// With leaf culling (cfg.leaf_cull) both kernels evaluate the scene of a
// point through its pixel's tile (scene_distance_tile): the compact plan's
// item lists of the tile (O(active leaves) per point) or, for a scene
// without a residual-free plan, the gated tape with the tile's leaf mask.
// Each kernel has its own tile grid; every ray (and tap) is evaluated with
// the list of the tile whose cone holds it.
// Given residual pointers it also writes each AA ray's march end t and hit
// flag (emit_th=True, 1850-1862), which the fused backward replays; the
// image does not depend on whether they are written. A painted scene
// (spec.has_materials) takes each hit ray's albedo from one more walk of
// the static tape at its hit point (scene_color, pallas_prepass.py:
// 1669-1681), gated by its tile's leaf mask under culling in either mode,
// as the reference's colour pass is; a material-free build carries none of
// it (the MATS template flag).
//
// What bounds them on an H100: neither reads or writes much memory (the
// fine kernel writes 12 bytes per pixel, the coarse kernel 8), so both are
// bound by f32 instruction issue in the scene interpreter and by warp
// divergence: a warp runs until its slowest ray exits. The Pallas kernels
// blocked that exit check over 128x128-ray tiles; here the unit is a warp
// of 32 rays, and the fine kernel puts a pixel's S AA samples in S adjacent
// lanes so a warp holds 32/S neighbouring pixels whose rays end together.
// Per ray the results do not depend on the tiling: the Pallas loops mask
// every step with `k < max_iter` (the interval scan runs 2 * max_iter
// steps unblocked), so a per-thread loop that stops when its ray stops
// gives the same (t, hit, status) and the same intervals. The AA mean is reduced in
// registers with warp shuffles (S = 64, aa_samples = 8: one shuffle tree
// per warp, then the two warps' sums through shared memory); nothing
// per-sample reaches device memory.
//
// Rounding notes: 1.0f / sqrtf(x) stands in for jax.lax.rsqrt (the
// correctly-rounded quotient of a correctly-rounded root, closer to the
// reference's f32 result than the approximate rsqrtf). The checker floor
// rounds half to even with rintf, as jnp.round does. nvcc's default FMA
// contraction is left on in the march of the hard builds; the ray setup
// rounds every operation (render_common.cuh), and so does all of the soft
// builds (fine.cuh). "No interval" is the reference's finite 3.0e38,
// tested with < 9.0e37, never INFINITY.
#include <cstdint>

#include <cuda_runtime.h>

#include "coarse.cuh"
#include "fine.cuh"
#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

// One thread per pixel of the band (prepass_chain, B > 1): the pixel's cone
// ray at omega_px over the whole tape, started at max(its bound-clip start,
// its block's t0) and dead where its block's status is 0
// (_cone_march_tile 152-154). Writes t0 and status f32[rows, width].
__global__ void coarse_px_kernel(SceneView sc, const float* __restrict__ cam,
                                 const float* __restrict__ bound,
                                 RenderParams p,
                                 const float* __restrict__ t_blk,
                                 const float* __restrict__ status_blk,
                                 float* __restrict__ t0_out,
                                 float* __restrict__ status_out,
                                 BlockParams bp) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= p.width || i >= p.rows) return;
  const float x = 2.0f * ((float)j + 0.5f) / (float)p.width - 1.0f;
  const float y =
      1.0f - 2.0f * (((float)i + 0.5f) + __ldg(cam + 7)) / (float)p.height;
  const Ray r = view_ray(cam, p, x, y);
  float live = 1.0f, t = 0.0f, t_cap = FAR_T;
  if (p.use_bound) bound_clip(bound, r, p.min_dist, live, t, t_cap);
  const size_t bo = (size_t)(i / bp.block) * bp.bcols + j / bp.block;
  const float live_in = status_blk[bo];
  live = live * live_in;
  t = fmaxf(t, t_blk[bo]) * live_in;
  const CullView uncull{};
  const float near =
      cone_march<0>(sc, uncull, 0, r, p, bp.omega_px, bp.inv1w_px, live, t, t_cap);
  const size_t o = (size_t)i * p.width + j;
  t0_out[o] = t;
  status_out[o] = near;
}

}  // namespace rmt

extern "C" {

// The launchers return the cudaError_t of the launch (0 = success). t_out
// and hit_out may be null (no residuals); cull->mode 0 renders unculled;
// mats != 0 shades with the scene's materials. With block->ni > 0 the
// coarse pass writes, and the fine pass reads, the 2*ni interval planes at
// t0 (status null). soft != 0 runs the soft build (no prepass, relax 1),
// which also writes s_min and t_min where soft_params gives them. img null
// runs the march-only build (fine_march.cu), which writes t and hit only.
// dyn != 0 reads `tape` as the frame's dynamic tape (the DYN builds of
// prepass_dyn.cu: un-culled or gated, hard, no march-only build).
int rmt_coarse_launch(const float* leaf_params, const int* row_kind,
                      const int* tape, int n_instr, const float* op_param,
                      int dyn, const float* cam, const float* bound,
                      const rmt::RenderParams* params,
                      const rmt::CullView* cull, float* t0_out,
                      float* status_out, const rmt::BlockParams* block_params,
                      void* stream) {
  rmt::CoarseLaunch L;
  L.p = *params;
  L.bp = *block_params;
  L.sc = rmt::make_scene(leaf_params, row_kind, tape, n_instr, op_param,
                         L.p.max_dist);
  if (L.bp.ni > rmt::MAX_NI) return (int)cudaErrorInvalidValue;
  const int kind = L.bp.ni > 0 ? 2 : (L.bp.block > 1 ? 1 : 0);
  const int cols = kind == 0 ? L.p.width : L.bp.bcols;
  L.block = dim3(rmt::COARSE_THREADS);
  L.grid = dim3((cols + rmt::COARSE_THREADS - 1) / rmt::COARSE_THREADS,
                kind == 0 ? L.p.rows : L.bp.brows);
  L.st = (cudaStream_t)stream;
  L.cam = cam;
  L.bound = bound;
  L.cv = *cull;
  L.t0_out = t0_out;
  L.status_out = status_out;
  if (dyn) return (int)rmt::launch_coarse_dyn(L, cull->mode, kind);
  switch (cull->mode) {
    case 0: L.kinds<0>(kind); break;
    case 1: L.kinds<1>(kind); break;
    case 2: L.kinds<2>(kind); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int rmt_coarse_px_launch(const float* leaf_params, const int* row_kind,
                         const int* tape, int n_instr, const float* op_param,
                         const float* cam, const float* bound,
                         const rmt::RenderParams* params, const float* t_blk,
                         const float* status_blk, float* t0_out,
                         float* status_out,
                         const rmt::BlockParams* block_params, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::BlockParams bp = *block_params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  const dim3 block(rmt::COARSE_THREADS);
  const dim3 grid((p.width + rmt::COARSE_THREADS - 1) / rmt::COARSE_THREADS,
                  p.rows);
  rmt::coarse_px_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      sc, cam, bound, p, t_blk, status_blk, t0_out, status_out, bp);
  return (int)cudaGetLastError();
}

int rmt_fine_launch(const float* leaf_params, const int* row_kind,
                    const int* tape, int n_instr, const float* op_param,
                    int dyn, const float* cam, const float* bound,
                    const rmt::RenderParams* params,
                    const rmt::CullView* cull, const float* t0_in,
                    const float* status_in, float* img, float* t_out,
                    float* hit_out, int mats,
                    const rmt::BlockParams* block_params, int soft,
                    const rmt::SoftParams* soft_params, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::BlockParams bp = *block_params;
  if (bp.ni > rmt::MAX_NI) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)p.width * p.naa * p.naa;
  rmt::FineLaunch L;
  L.grid = dim3((unsigned)((lanes + rmt::FINE_THREADS - 1) / rmt::FINE_THREADS),
                p.rows);
  L.block = dim3(rmt::FINE_THREADS);
  L.st = (cudaStream_t)stream;
  L.sc = rmt::make_scene(leaf_params, row_kind, tape, n_instr, op_param,
                         p.max_dist);
  L.cam = cam;
  L.bound = bound;
  L.p = p;
  L.cv = *cull;
  L.t0_in = t0_in;
  L.status_in = status_in;
  L.img = img;
  L.t_out = t_out;
  L.hit_out = hit_out;
  L.bp = bp;
  L.sp = *soft_params;
  const bool relax = p.relax > 1.0f;
  if (soft && (dyn || relax || !p.no_prepass ||
               (t_out != nullptr && (L.sp.s_min_out == nullptr ||
                                     L.sp.t_min_out == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (soft) return (int)rmt::launch_fine_soft(L, cull->mode, mats != 0);
  const int kind = p.no_prepass ? 0
                   : bp.ni > 0   ? 2
                   : (bp.block > 1 && !bp.chain) ? 1
                                                : 0;
  if (img == nullptr) {
    // The march-only build: t and hit only (fine_march.cu).
    if (dyn || t_out == nullptr || hit_out == nullptr)
      return (int)cudaErrorInvalidValue;
    return (int)rmt::launch_fine_march(L, cull->mode, relax, kind);
  }
  if (dyn) return (int)rmt::launch_fine_dyn(L, cull->mode, relax, mats != 0, kind);
  switch (cull->mode) {
    case 0: L.flags<0>(relax, mats != 0, kind); break;
    case 1: L.flags<1>(relax, mats != 0, kind); break;
    case 2: L.flags<2>(relax, mats != 0, kind); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
