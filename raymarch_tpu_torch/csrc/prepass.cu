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
// The chained pixel kernel K3 (coarse_px_kernel, replacing the Pallas
// coarse_px_kernel at 969) is in coarse_px.cu.
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
// fine_soft.cu the soft ones, fine_march.cu the march-only ones,
// intervals_wide.cu those past MAX_NI intervals and prepass_dyn.cu the DYN
// builds of both, which interpret the frame's dynamic tape.
//
// Both kernels read the scene from its packed words (scene_eval.cuh
// SceneWords: one 16-byte word per instruction, float4 leaf rows) and keep
// the value stack out of local memory: its top in a register, and the slot
// below it in a register for a stack depth of at most REG_STACK (the STK
// build REG_STACK), else the slots below the top in shared memory
// (STK_SMEM). The host chooses the route from the spec's stack depth
// (ops/cuda_march.py stack_route) and names it in the launch.
//
// With leaf culling (cfg.leaf_cull) both kernels evaluate the scene of a
// point through its pixel's tile (WordScene): the compact plan's
// item lists of the tile (O(active leaves) per point) or, for a scene
// without a residual-free plan, the gated tape with the tile's leaf mask.
// Each kernel has its own tile grid; every ray (and tap) is evaluated with
// the list of the tile whose cone holds it.
// Given residual pointers it also writes each AA ray's march end t and hit
// flag (emit_th=True, 1850-1862), which the fused backward replays; the
// image does not depend on whether they are written. A painted scene
// (spec.has_materials) takes each hit ray's albedo from one more walk of
// the static tape at its hit point (WordScene::color, pallas_prepass.py:
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
// rounds half to even with rintf, as jnp.round does. Every K1/K2 source
// builds with -fmad=false (_build.py SOURCE_FLAGS): no FMA contraction, so
// each operation of the march and the scene rounds as the plain torch
// versions' do and the kernels' planes and (t, hit) equal theirs, static
// and DYN builds alike. "No interval" is the reference's finite 3.0e38,
// tested with < 9.0e37, never INFINITY.
#include <cstdint>

#include <cuda_runtime.h>

#include "coarse.cuh"
#include "fine.cuh"
#include "render_common.cuh"
#include "scene_eval.cuh"

extern "C" {

// The launchers return the cudaError_t of the launch (0 = success). t_out
// and hit_out may be null (no residuals); cull->mode 0 renders unculled;
// mats != 0 shades with the scene's materials. With block->ni > 0 the
// coarse pass writes, and the fine pass reads, the 2*ni interval planes at
// t0 (status null). soft != 0 runs the soft build (no prepass, relax 1),
// which also writes s_min and t_min where soft_params gives them. img null
// runs the march-only build (fine_march.cu), which writes t and hit only.
// words is the packed tape int32[n_instr, 4] (ops/cuda_march.py
// pack_words); dyn != 0 marks it as the frame's dynamic tape (the DYN
// builds, MODE 3 and 4: un-culled or gated; hard in prepass_dyn.cu,
// march-only in fine_march.cu, soft in fine_soft.cu); stack_depth is the
// spec's, whose route (REG_STACK or STK_SMEM) the launch names in stk.
// Interval counts above MAX_NI take the builds of intervals_wide.cu.
int rmt_coarse_launch(const float* leaf_params, const int* row_kind,
                      const int* words, int n_instr, const float* op_param,
                      int dyn, int stk, int stack_depth, const float* cam,
                      const float* bound,
                      const rmt::RenderParams* params,
                      const rmt::CullView* cull, float* t0_out,
                      float* status_out, const rmt::BlockParams* block_params,
                      void* stream) {
  rmt::CoarseLaunch L;
  L.p = *params;
  L.bp = *block_params;
  if (!rmt::make_words(leaf_params, row_kind, words, n_instr, op_param,
                       L.p.max_dist, stk, stack_depth, &L.sw))
    return (int)cudaErrorInvalidValue;
  L.stk = stk;
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
  switch (rmt::build_mode(cull->mode, dyn != 0)) {
    case 0: return (int)rmt::launch_coarse<0>(L, kind);
    case 1: return (int)rmt::launch_coarse<1>(L, kind);
    case 2: return (int)rmt::launch_coarse<2>(L, kind);
    case 3: return (int)rmt::launch_coarse<3>(L, kind);
    case 4: return (int)rmt::launch_coarse<4>(L, kind);
    default:  // a dynamic tape has no compact plan: no item lists
      return (int)cudaErrorInvalidValue;
  }
}

int rmt_fine_launch(const float* leaf_params, const int* row_kind,
                    const int* words, int n_instr, const float* op_param,
                    int dyn, int stk, int stack_depth, const float* cam,
                    const float* bound,
                    const rmt::RenderParams* params,
                    const rmt::CullView* cull, const float* t0_in,
                    const float* status_in, float* img, float* t_out,
                    float* hit_out, int mats,
                    const rmt::BlockParams* block_params, int soft,
                    const rmt::SoftParams* soft_params, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::BlockParams bp = *block_params;
  const long long lanes = (long long)p.width * p.naa * p.naa;
  rmt::FineLaunch L;
  L.grid = dim3((unsigned)((lanes + rmt::FINE_THREADS - 1) / rmt::FINE_THREADS),
                p.rows);
  L.block = dim3(rmt::FINE_THREADS);
  L.st = (cudaStream_t)stream;
  if (!rmt::make_words(leaf_params, row_kind, words, n_instr, op_param,
                       p.max_dist, stk, stack_depth, &L.sw))
    return (int)cudaErrorInvalidValue;
  L.stk = stk;
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
  const int mode = rmt::build_mode(cull->mode, dyn != 0);
  if (mode < 0) return (int)cudaErrorInvalidValue;
  if (soft && (relax || !p.no_prepass ||
               (t_out != nullptr && (L.sp.s_min_out == nullptr ||
                                     L.sp.t_min_out == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (soft) return (int)rmt::launch_fine_soft(L, mode, mats != 0);
  const int kind = p.no_prepass             ? 0
                   : bp.ni > rmt::MAX_NI    ? 3
                   : bp.ni > 0              ? 2
                   : (bp.block > 1 && !bp.chain) ? 1
                                                : 0;
  if (img == nullptr) {
    // The march-only build: t and hit only (fine_march.cu).
    if (t_out == nullptr || hit_out == nullptr)
      return (int)cudaErrorInvalidValue;
    switch (mode) {
      case 0: return (int)rmt::launch_fine_march<0>(L, relax, kind);
      case 1: return (int)rmt::launch_fine_march<1>(L, relax, kind);
      case 2: return (int)rmt::launch_fine_march<2>(L, relax, kind);
      case 3: return (int)rmt::launch_fine_march<3>(L, relax, kind);
      default: return (int)rmt::launch_fine_march<4>(L, relax, kind);
    }
  }
  const bool m = mats != 0;
  switch (mode) {
    case 0: return (int)rmt::launch_fine_hard<0>(L, relax, m, kind);
    case 1: return (int)rmt::launch_fine_hard<1>(L, relax, m, kind);
    case 2: return (int)rmt::launch_fine_hard<2>(L, relax, m, kind);
    case 3: return (int)rmt::launch_fine_hard<3>(L, relax, m, kind);
    default: return (int)rmt::launch_fine_hard<4>(L, relax, m, kind);
  }
}

}  // extern "C"

namespace rmt {

template cudaError_t launch_coarse<0>(const CoarseLaunch&, int);
template cudaError_t launch_coarse<1>(const CoarseLaunch&, int);
template cudaError_t launch_coarse<2>(const CoarseLaunch&, int);
template cudaError_t launch_fine_hard<0>(const FineLaunch&, bool, bool, int);

}  // namespace rmt
