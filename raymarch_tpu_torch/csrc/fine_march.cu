// The march-only builds of the fine kernel (fine_kernel<MODE, RELAX, false,
// PRE, true, STK>, fine.cuh) on static tapes, MODE 0-2: the second launch
// of raymarch_tpu/ops/pallas_prepass.py:fine_packed_kernel (1827,
// march_only 1621-1640), which writes each AA ray's march end t and hit
// flag and skips the taps, the shading and the image
// (make_pallas_image_march_fast, 1932). Those on the frame's dynamic tape
// (MODE 3 un-culled, 4 gated) are in fine_march_dyn.cu. Compiled as
// prepass.cu and prepass_dyn.cu are (-fmad=false), so that its (t, hit)
// are those of the fine kernel with residuals, static or DYN, and of their
// plain version, bit for bit.
//
// What bounds it on an H100: f32 instruction issue in the scene interpreter
// over the march from the prepass's start (or through its near intervals);
// it writes 8 bytes per AA ray (265 MB at 1080p / 16 AA).
#include <cuda_runtime.h>

#include "fine.cuh"

namespace rmt {

template cudaError_t launch_fine_march<0>(const FineLaunch&, bool, int);
template cudaError_t launch_fine_march<1>(const FineLaunch&, bool, int);
template cudaError_t launch_fine_march<2>(const FineLaunch&, bool, int);

}  // namespace rmt
