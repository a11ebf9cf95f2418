// The march-only builds of the fine kernel (fine_kernel<MODE, RELAX, false,
// PRE, true>, fine.cuh): the second launch of raymarch_tpu/ops/
// pallas_prepass.py:fine_packed_kernel (1827, march_only 1621-1640), which
// writes each AA ray's march end t and hit flag and skips the taps, the
// shading and the image (make_pallas_image_march_fast, 1932). Compiled as
// prepass.cu is, with nvcc's default FMA contraction, so that its (t, hit)
// are those of the fine kernel with residuals bit for bit.
//
// What bounds it on an H100: f32 instruction issue in the scene interpreter
// over the march from the prepass's start (or through its near intervals);
// it writes 8 bytes per AA ray (265 MB at 1080p / 16 AA).
#include <cuda_runtime.h>

#include "fine.cuh"

namespace rmt {

cudaError_t launch_fine_march(const FineLaunch& L, int mode, bool relax,
                              int kind) {
  switch (mode) {
    case 0: L.march_flags<0>(relax, kind); break;
    case 1: L.march_flags<1>(relax, kind); break;
    case 2: L.march_flags<2>(relax, kind); break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace rmt
