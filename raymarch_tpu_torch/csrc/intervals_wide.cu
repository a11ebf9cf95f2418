// The builds of the fine kernel K2 (forward, residuals and march-only) for
// more than MAX_NI near intervals per block: PRE 4, whose interval march
// reads each block's interval bounds in place from the 2*ni interval
// planes (fine.cuh PlaneIntervals) instead of copying at most MAX_NI of
// them to registers, so that `n_intervals` has no cap (the reference takes
// any count: pallas_prepass.py:1521's _fine_march_interval_tile loops over
// ni planes). The coarse kernel's interval scan writes them in place for
// any ni (coarse_kernel<MODE, 2, STK>, prepass.cu and prepass_dyn.cu). The
// builds for ni <= MAX_NI keep the bounds in registers (ShiftIntervals).
// K4's PRE 4 builds are in its sources, one a culling mode
// (fine_unpacked.cuh).
//
// A translation unit of its own, compiled as every K1/K2 source is
// (_build.py SOURCE_FLAGS: -fmad=false), so that nvcc builds these
// instantiations beside the others. What bounds them on an H100: as the
// PRE 2 builds, f32 instruction issue in the scene interpreter; the bounds
// of the current interval are two L1-cached loads per march step.
#include <cuda_runtime.h>

#include "fine.cuh"

namespace rmt {

template <int MODE, bool RELAX, bool MATS, bool MO, int STK>
void fine_wide(const FineLaunch& L) {
  L.launch<MODE, RELAX, MATS, 4, MO, STK>();
}

// Every MODE (0-2 static, 3-4 DYN), RELAX and MATS, march-only without
// materials, on each stack route the build reads (uses_stack).
#define RMT_WIDE(M, R, A, O)                                          \
  template void fine_wide<M, R, A, O, REG_STACK>(const FineLaunch&); \
  template void fine_wide<M, R, A, O, STK_SMEM>(const FineLaunch&);
#define RMT_WIDE_MODE(M)           \
  RMT_WIDE(M, false, false, false) \
  RMT_WIDE(M, false, true, false)  \
  RMT_WIDE(M, true, false, false)  \
  RMT_WIDE(M, true, true, false)   \
  RMT_WIDE(M, false, false, true)  \
  RMT_WIDE(M, true, false, true)
RMT_WIDE_MODE(0)
RMT_WIDE_MODE(2)
RMT_WIDE_MODE(3)
RMT_WIDE_MODE(4)
// MODE 1 folds its item lists: its builds without materials read no stack.
template void fine_wide<1, false, false, false, REG_STACK>(const FineLaunch&);
template void fine_wide<1, true, false, false, REG_STACK>(const FineLaunch&);
template void fine_wide<1, false, false, true, REG_STACK>(const FineLaunch&);
template void fine_wide<1, true, false, true, REG_STACK>(const FineLaunch&);
RMT_WIDE(1, false, true, false)
RMT_WIDE(1, true, true, false)
#undef RMT_WIDE_MODE
#undef RMT_WIDE

}  // namespace rmt
