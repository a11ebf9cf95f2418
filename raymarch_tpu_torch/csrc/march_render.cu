// K7 per AA ray (march.cuh's march_kernel, SRC 1, OUT 1): the gamma-
// corrected r, g, b of each ray, as make_pallas_image_render returns them.
#include <cuda_runtime.h>

#include "march.cuh"

namespace rmt {

cudaError_t launch_march_render(const MarchLaunch& L, bool mats, bool dyn,
                                bool relax) {
  return mats ? L.flags<1, 1, true>(dyn, relax)
              : L.flags<1, 1, false>(dyn, relax);
}

}  // namespace rmt
