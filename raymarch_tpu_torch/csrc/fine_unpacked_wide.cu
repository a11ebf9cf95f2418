// The PRE 4 builds of the unpacked fine pass K4 (fine_unpacked_kernel<MODE,
// RELAX, MATS, 4>, fine_unpacked.cuh): more than MAX_NI near intervals per
// block, their bounds read in place from the 2*ni interval planes (fine.cuh
// PlaneIntervals), so that `n_intervals` has no cap (pallas_prepass.py:1010's
// fine_kernel loops over ni planes). A translation unit of its own, with
// nvcc's default flags as fine_unpacked.cu, so that nvcc builds these 20
// instantiations beside the others.
#include <cuda_runtime.h>

#include "fine_unpacked.cuh"

namespace rmt {

template <int MODE, bool RELAX, bool MATS>
void unpacked_wide(const UnpackedLaunch& L) {
  fine_unpacked_kernel<MODE, RELAX, MATS, 4><<<L.grid, L.block, 0, L.st>>>(
      L.sc, L.cam, L.bound, L.p, L.cv, L.t0_in, L.status_in, L.img, L.t_out,
      L.hit_out, L.bp, L.shared);
}

// Every MODE (0-2 static, 3-4 DYN), RELAX and MATS.
#define RMT_WIDE_MODE(M)                                               \
  template void unpacked_wide<M, false, false>(const UnpackedLaunch&); \
  template void unpacked_wide<M, false, true>(const UnpackedLaunch&);  \
  template void unpacked_wide<M, true, false>(const UnpackedLaunch&);  \
  template void unpacked_wide<M, true, true>(const UnpackedLaunch&);
RMT_WIDE_MODE(0)
RMT_WIDE_MODE(1)
RMT_WIDE_MODE(2)
RMT_WIDE_MODE(3)
RMT_WIDE_MODE(4)
#undef RMT_WIDE_MODE

}  // namespace rmt
