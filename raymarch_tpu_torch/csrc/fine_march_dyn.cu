// The march-only builds of the fine kernel on the frame's dynamic tape
// (fine_kernel<MODE, RELAX, false, PRE, true, STK>, fine.cuh; MODE 3
// un-culled, 4 gated): fine_march.cu's builds for dynamic tapes, in a
// source of their own so that nvcc compiles the two groups in parallel,
// with the same flags (-fmad=false).
#include <cuda_runtime.h>

#include "fine.cuh"

namespace rmt {

template cudaError_t launch_fine_march<3>(const FineLaunch&, bool, int);
template cudaError_t launch_fine_march<4>(const FineLaunch&, bool, int);

}  // namespace rmt
