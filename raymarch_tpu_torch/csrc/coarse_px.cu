// The chained pixel kernel K3 (coarse_px_kernel<MODE>, coarse.cuh) with a
// plain C interface for ctypes: MODE 0 on the static tape, 3 on the frame's
// dynamic tape (the reference's coarse_px_kernel, pallas_prepass.py:969-990,
// whose scene_eval takes dynamic specs; un-culled, as the reference's).
// It evaluates the scene through SceneView's interpreter (scene_eval.cuh
// TileScene over scene_distance), with nvcc's default flags: a translation
// unit of its own, apart from the K1/K2 sources, which build without FMA
// contraction on the packed scene words.
//
// What bounds it on an H100: f32 instruction issue in the scene interpreter
// over the whole tape per pixel, from its block's stop distance; it reads
// 8 bytes of block planes per pixel and writes 8.
#include <cuda_runtime.h>

#include "coarse.cuh"
#include "render_common.cuh"

extern "C" {

// Returns the cudaError_t of the launch (0 = success). dyn != 0 reads `tape`
// as the frame's dynamic tape.
int rmt_coarse_px_launch(const float* leaf_params, const int* row_kind,
                         const int* tape, int n_instr, const float* op_param,
                         int dyn, const float* cam, const float* bound,
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (dyn)
    rmt::coarse_px_kernel<3><<<grid, block, 0, st>>>(
        sc, cam, bound, p, t_blk, status_blk, t0_out, status_out, bp);
  else
    rmt::coarse_px_kernel<0><<<grid, block, 0, st>>>(
        sc, cam, bound, p, t_blk, status_blk, t0_out, status_out, bp);
  return (int)cudaGetLastError();
}

}  // extern "C"
