// The gated DYN hard builds of the fine kernel (fine_kernel<4, RELAX, MATS,
// PRE, false, STK>, fine.cuh): the frame's dynamic tape, packed into scene
// words, with the tile's leaf mask (prepass_dyn.cu describes the DYN
// builds). A source of its own so that nvcc compiles these builds beside
// prepass_dyn.cu's, with the same flags (-fmad=false).
#include <cuda_runtime.h>

#include "fine.cuh"

namespace rmt {

template cudaError_t launch_fine_hard<4>(const FineLaunch&, bool, bool, int);

}  // namespace rmt
