// The DYN builds of the coarse kernel (coarse_kernel<MODE, KIND, STK>,
// coarse.cuh) and the un-culled DYN builds of the hard fine kernel
// (fine_kernel<3, RELAX, MATS, PRE, false, STK>, fine.cuh; MODE 4's, gated
// by the tile's leaf mask, are in fine_dyn_gated.cu): MODE 3 (un-culled)
// and 4 (gated) interpret the frame's dynamic tape, packed into scene
// words per frame (scene_eval.cuh words_distance<true> and
// words_color<true>: the stack's top starts at max_dist, a NOP is skipped),
// so that a topology edit within the tape's bucket is a buffer write and
// builds nothing. They stand in for the dynamic branches of
// raymarch_tpu/ops/pallas_march.py:_make_scene_eval (709-871) and
// _make_scene_color_eval (873-1047) inside the Pallas coarse_kernel
// (pallas_prepass.py:885) and fine_packed_kernel (1521). The reference
// interprets macroize_streams' fused entries; this interpreter runs the raw
// tape with its NOPs skipped, as K5-K7 do (march.cuh).
//
// A translation unit of its own so that nvcc builds it beside prepass.cu,
// with the same flags (-fmad=false, as every K1/K2 source): each operation
// rounds as the plain versions' (sdf._apply_dynamic_tape) do, so a DYN
// build's (t, hit) and planes equal its plain version's, and the static
// frame's wherever the two tapes fold the same leaves in the same order.
//
// What bounds them on an H100: as the static builds, f32 instruction issue
// in the scene interpreter and warp divergence; the dynamic tape adds a NOP
// test per bucket instruction (config 2: 8 instructions against 5).
#include <cuda_runtime.h>

#include "coarse.cuh"
#include "fine.cuh"

namespace rmt {

template cudaError_t launch_coarse<3>(const CoarseLaunch&, int);
template cudaError_t launch_coarse<4>(const CoarseLaunch&, int);
template cudaError_t launch_fine_hard<3>(const FineLaunch&, bool, bool, int);

}  // namespace rmt
