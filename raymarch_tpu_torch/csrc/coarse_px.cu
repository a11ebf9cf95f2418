// The chained pixel kernel K3 (coarse_px_kernel<MODE, STK>, coarse.cuh) with
// a plain C interface for ctypes: MODE 0 on the static tape, 3 on the
// frame's dynamic tape (the reference's coarse_px_kernel,
// pallas_prepass.py:969-990, launched at 1439, whose scene_eval takes
// dynamic specs; un-culled, as the reference's).
//
// It reads the scene as K1 and K2 do: the packed words (scene_eval.cuh
// WordScene, one 16-byte word per instruction, float4 leaf rows), the value
// stack's top in a register and the slots below it in a register (stack
// depth <= REG_STACK) or in shared memory, one column per thread (STK_SMEM;
// ops/cuda_march.py stack_route). A K1/K2-family source (_build.py
// K12_SOURCES): built with -fmad=false, so that its planes equal
// coarse_px_plain's pixel for pixel.
//
// What bounds it on an H100: f32 instruction issue in the scene evaluator
// over the whole tape per pixel, from its block's stop distance, and the
// per-pixel floor (raygen's IEEE divisions and root, the bound clip); it
// reads 8 bytes of block planes per pixel and writes 8. A warp is an 8x4
// tile of pixels (coarse.cuh), whose lanes share one or two blocks' stop
// distances and status: they start, die and stop together.
#include <cuda_runtime.h>

#include "coarse.cuh"
#include "render_common.cuh"

namespace {

struct PxLaunch {
  dim3 grid, block;
  cudaStream_t st;
  rmt::SceneWords sw;
  const float *cam, *bound;
  rmt::RenderParams p;
  const float *t_blk, *status_blk;
  float *t0_out, *status_out;
  rmt::BlockParams bp;

  template <int MODE, int STK>
  cudaError_t run() const {
    const size_t smem = rmt::stack_smem_bytes<false, STK>(sw, block.x);
    rmt::coarse_px_kernel<MODE, STK><<<grid, block, smem, st>>>(
        sw, cam, bound, p, t_blk, status_blk, t0_out, status_out, bp);
    return cudaGetLastError();
  }
  template <int MODE>
  cudaError_t go(int stk) const {
    return stk == rmt::REG_STACK ? run<MODE, rmt::REG_STACK>()
                                 : run<MODE, rmt::STK_SMEM>();
  }
};

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = success). words is the packed
// tape int32[n_instr, 4] (ops/cuda_march.py pack_words); dyn != 0 marks it
// as the frame's dynamic tape; stack_depth is the spec's, whose route
// (REG_STACK or STK_SMEM) the launch names in stk.
int rmt_coarse_px_launch(const float* leaf_params, const int* row_kind,
                         const int* words, int n_instr, const float* op_param,
                         int dyn, int stk, int stack_depth, const float* cam,
                         const float* bound, const rmt::RenderParams* params,
                         const float* t_blk, const float* status_blk,
                         float* t0_out, float* status_out,
                         const rmt::BlockParams* block_params, void* stream) {
  PxLaunch L;
  L.p = *params;
  L.bp = *block_params;
  if (!rmt::make_words(leaf_params, row_kind, words, n_instr, op_param,
                       L.p.max_dist, stk, stack_depth, &L.sw))
    return (int)cudaErrorInvalidValue;
  constexpr int cols = rmt::PX_TILE_W * rmt::PX_WARPS;
  L.block = dim3(rmt::COARSE_THREADS);
  L.grid = dim3((L.p.width + cols - 1) / cols,
                (L.p.rows + rmt::PX_TILE_H - 1) / rmt::PX_TILE_H);
  L.st = (cudaStream_t)stream;
  L.cam = cam;
  L.bound = bound;
  L.t_blk = t_blk;
  L.status_blk = status_blk;
  L.t0_out = t0_out;
  L.status_out = status_out;
  return (int)(dyn ? L.go<3>(stk) : L.go<0>(stk));
}

}  // extern "C"
