// The builds of the fine kernel K2 (forward, residuals and march-only) and
// of the unpacked fine pass K4 for more than MAX_NI near intervals per
// block: PRE 4, whose interval march reads each block's interval bounds in
// place from the 2*ni interval planes (fine.cuh PlaneIntervals) instead of
// copying at most MAX_NI of them to registers, so that `n_intervals` has no
// cap (the reference takes any count: pallas_prepass.py:1521's
// _fine_march_interval_tile and 1010's fine_kernel loop over ni planes).
// The coarse kernel's interval scan writes them in place the same way
// (coarse_kernel<MODE, 3>, prepass.cu and prepass_dyn.cu). The builds for
// ni <= MAX_NI keep their register arrays and their code.
//
// A translation unit of its own, compiled with the same flags as prepass.cu
// (FMA contraction on, as every hard fine build), so that nvcc builds these
// 50 instantiations beside the others. What bounds them on an H100: as the
// PRE 2 builds, f32 instruction issue in the scene interpreter; the bounds
// of the current interval are two L1-cached loads per march step.
#include <cuda_runtime.h>

#include "fine.cuh"
#include "fine_unpacked.cuh"

namespace rmt {

template <int MODE, bool RELAX, bool MATS, bool MO>
void fine_wide(const FineLaunch& L) {
  fine_kernel<MODE, RELAX, MATS, 4, MO><<<L.grid, L.block, 0, L.st>>>(
      L.sc, L.cam, L.bound, L.p, L.cv, L.t0_in, L.status_in, L.img, L.t_out,
      L.hit_out, L.bp, L.sp);
}

template <int MODE, bool RELAX, bool MATS>
void unpacked_wide(const UnpackedLaunch& L) {
  fine_unpacked_kernel<MODE, RELAX, MATS, 4><<<L.grid, L.block, 0, L.st>>>(
      L.sc, L.cam, L.bound, L.p, L.cv, L.t0_in, L.status_in, L.img, L.t_out,
      L.hit_out, L.bp, L.shared);
}

// Every MODE (0-2 static, 3-4 DYN), RELAX and MATS; march-only without
// materials.
#define RMT_WIDE_MODE(M)                                         \
  template void fine_wide<M, false, false, false>(const FineLaunch&); \
  template void fine_wide<M, false, true, false>(const FineLaunch&);  \
  template void fine_wide<M, true, false, false>(const FineLaunch&);  \
  template void fine_wide<M, true, true, false>(const FineLaunch&);   \
  template void fine_wide<M, false, false, true>(const FineLaunch&);  \
  template void fine_wide<M, true, false, true>(const FineLaunch&);   \
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
