// K7's pixel build (march.cuh's march_kernel, SRC 1, OUT 2): the mean of
// each pixel's gamma-corrected AA samples, the image of
// make_renderer(backend="pallas_full").
#include <cuda_runtime.h>

#include "march.cuh"

namespace rmt {

cudaError_t launch_march_pixels(const MarchLaunch& L, bool mats, bool dyn,
                                bool relax) {
  return mats ? L.flags<1, 2, true>(dyn, relax)
              : L.flags<1, 2, false>(dyn, relax);
}

}  // namespace rmt
