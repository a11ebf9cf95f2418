// The compact item lists' builds (MODE 1: a static tape culled by its plan)
// of the unpacked fine pass K4 (fine_unpacked_kernel<1, RELAX, MATS, PRE,
// STK>, fine_unpacked.cuh; fine_unpacked.cu describes the kernel): a
// translation unit of its own, with the flags of every K4 source
// (-fmad=false), so that nvcc builds it beside the others.
#include <cuda_runtime.h>

#include "fine_unpacked.cuh"

namespace rmt {

template cudaError_t launch_unpacked<1>(const UnpackedLaunch&, bool, bool, int);

}  // namespace rmt
