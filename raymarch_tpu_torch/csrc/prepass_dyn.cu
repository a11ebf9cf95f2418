// The DYN builds of the coarse kernel (coarse_kernel<MODE, KIND>,
// coarse.cuh), of the chained pixel kernel K3 (coarse_px_kernel<3>,
// un-culled as the reference's coarse_px_kernel, pallas_prepass.py:969-990,
// whose scene_eval takes dynamic specs) and of the hard fine kernel
// (fine_kernel<MODE, RELAX, MATS, PRE>, fine.cuh): MODE 3 (un-culled) and 4
// (gated by the tile's leaf mask)
// interpret the frame's dynamic tape (scene_eval.cuh scene_distance<true>
// and scene_color<true>: the stack starts at max_dist, a NOP is the
// identity), so that a topology edit within the tape's bucket is a buffer
// write and builds nothing. They stand in for the dynamic branches of
// raymarch_tpu/ops/pallas_march.py:_make_scene_eval (709-871) and
// _make_scene_color_eval (873-1047) inside the Pallas coarse_kernel
// (pallas_prepass.py:885) and fine_packed_kernel (1521). The reference
// interprets macroize_streams' fused entries; this interpreter runs the raw
// tape with its NOPs skipped, as K5-K7 do (march.cu).
//
// A translation unit of its own so that nvcc builds it beside prepass.cu,
// with the same flags (FMA contraction on, as the static hard builds): a
// dynamic frame's rays then take the static frame's steps wherever the two
// tapes fold the same leaves in the same order.
//
// What bounds them on an H100: as the static builds, f32 instruction issue
// in the scene interpreter and warp divergence; the dynamic tape adds a NOP
// test per bucket instruction (config 2: 8 instructions against 5).
#include <cuda_runtime.h>

#include "coarse.cuh"
#include "fine.cuh"

namespace rmt {

cudaError_t launch_coarse_dyn(const CoarseLaunch& L, int mode, int kind) {
  switch (mode) {
    case 3: L.kinds<3>(kind); break;
    case 4: L.kinds<4>(kind); break;
    default:  // a dynamic tape has no compact plan: no item lists
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_fine_dyn(const FineLaunch& L, int mode, bool relax,
                            bool mats, int kind) {
  switch (mode) {
    case 3: L.flags<3>(relax, mats, kind); break;
    case 4: L.flags<4>(relax, mats, kind); break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

void launch_coarse_px_dyn(dim3 grid, dim3 block, cudaStream_t st,
                          const SceneView& sc, const float* cam,
                          const float* bound, const RenderParams& p,
                          const float* t_blk, const float* status_blk,
                          float* t0_out, float* status_out,
                          const BlockParams& bp) {
  coarse_px_kernel<3><<<grid, block, 0, st>>>(sc, cam, bound, p, t_blk,
                                              status_blk, t0_out, status_out,
                                              bp);
}

}  // namespace rmt
