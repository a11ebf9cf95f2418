// The gated DYN builds (MODE 4: the dynamic tape gated by the tile's leaf
// mask) of the unpacked fine pass K4 (fine_unpacked_kernel<4, RELAX, MATS,
// PRE, STK>, fine_unpacked.cuh; fine_unpacked.cu describes the kernel): a
// translation unit of its own, with the flags of every K4 source
// (-fmad=false), so that nvcc builds it beside the others.
#include <cuda_runtime.h>

#include "fine_unpacked.cuh"

namespace rmt {

template cudaError_t launch_unpacked<4>(const UnpackedLaunch&, bool, bool, int);

}  // namespace rmt
