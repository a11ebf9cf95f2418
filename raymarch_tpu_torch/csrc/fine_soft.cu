// The soft builds of the fine kernel (fine_kernel<MODE, false, MATS, 3, false, STK>,
// fine.cuh) on static tapes (MODE 0-2) and on the frame's dynamic tape
// (MODE 3 un-culled, 4 gated; the reference's soft fine kernel interprets
// dynamic specs too): soft coverage, replacing the soft branch of raymarch_tpu/ops/
// pallas_prepass.py:fine_packed_kernel (1521; _fine_march_tile_soft 380,
// the shading 1696-1760). Compiled with -fmad=false (_build.py
// SOURCE_FLAGS): the closest approach is an argmin over a grazing ray's
// samples, which an FMA's different rounding moves by a whole step; without
// contraction the build rounds as its plain version (cuda_prepass.
// fine_res_plain) does, operation for operation.
//
// What bounds it on an H100: as the hard builds, f32 instruction issue in
// the scene interpreter, here over the whole march from t = 0 (no prepass)
// and past near misses until the inflated bound's no-improvement exit; it
// writes 12 bytes per pixel and 16 per AA ray of residuals.
#include <cuda_runtime.h>

#include "fine.cuh"

namespace rmt {

cudaError_t launch_fine_soft(const FineLaunch& L, int mode, bool mats) {
  switch (mode * 2 + (mats ? 1 : 0)) {
    case 0: L.go<0, false, false, 3>(); break;
    case 1: L.go<0, false, true, 3>(); break;
    case 2: L.go<1, false, false, 3>(); break;
    case 3: L.go<1, false, true, 3>(); break;
    case 4: L.go<2, false, false, 3>(); break;
    case 5: L.go<2, false, true, 3>(); break;
    case 6: L.go<3, false, false, 3>(); break;
    case 7: L.go<3, false, true, 3>(); break;
    case 8: L.go<4, false, false, 3>(); break;
    case 9: L.go<4, false, true, 3>(); break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace rmt
