// The culled static-tape hard builds of the fine kernel (fine_kernel<MODE,
// RELAX, MATS, PRE, false, STK>, fine.cuh): MODE 1, which folds the tile's
// compact item lists over float4 leaf rows (its colour walk, with
// materials, reads the gated tape), and MODE 2, the gated tape (the tape's
// packed words with the tile's leaf mask). prepass.cu's header describes
// the kernel; a source of its own so that nvcc compiles these builds beside
// prepass.cu's, with the same flags (-fmad=false).
#include <cuda_runtime.h>

#include "fine.cuh"

namespace rmt {

template cudaError_t launch_fine_hard<1>(const FineLaunch&, bool, bool, int);
template cudaError_t launch_fine_hard<2>(const FineLaunch&, bool, bool, int);

}  // namespace rmt
