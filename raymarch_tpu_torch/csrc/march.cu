// K5 and K6 (march.cuh's march_kernel, OUT 0) and the plain C interface of
// every flat march build for ctypes.
#include <cstdint>

#include <cuda_runtime.h>

#include "march.cuh"

namespace rmt {

cudaError_t launch_march_rays(const MarchLaunch& L, bool rays, bool dyn,
                              bool relax) {
  return rays ? L.flags<0, 0, false>(dyn, relax)
              : L.flags<1, 0, false>(dyn, relax);
}

}  // namespace rmt

extern "C" {

// Launches K5 (origins and dirs given, out 0), K6 (no rays, out 0) or K7
// (no rays: out 1 per AA ray, out 2 per pixel) over n rays; returns the
// cudaError_t of the launch (0 = success). words = i32[n_instr, 4]: the
// packed static tape, or with dyn != 0 the frame's packed dynamic tape;
// leaf_params 16-byte aligned; stk the value stack's route (REG_STACK or
// STK_SMEM) for a tape of stack depth stack_depth. out 0 writes t, hit (o0,
// o1) and steps; out 1 writes r, g, b (o0, o1, o2); out 2 the image f32[H,
// W, 3] (o0); with mats != 0 the albedo of a painted scene.
int rmt_march_launch(const float* leaf_params, const int* row_kind,
                     const int* words, int n_instr, const float* op_param,
                     int dyn, int stk, int stack_depth, int mats,
                     const float* origins, const float* dirs,
                     const float* cam, const float* bound,
                     const rmt::RenderParams* params, int n, int out,
                     float* o0, float* o1, float* o2, int* steps,
                     void* stream) {
  if (n <= 0) return 0;
  const bool rays = origins != nullptr;
  if ((rays && (dirs == nullptr || out != 0)) || (!rays && cam == nullptr) ||
      out < 0 || out > 2)
    return (int)cudaErrorInvalidValue;
  rmt::MarchLaunch L;
  L.p = *params;
  if (!rmt::make_words(leaf_params, row_kind, words, n_instr, op_param,
                       L.p.max_dist, stk, stack_depth, &L.sw))
    return (int)cudaErrorInvalidValue;
  const int S = L.p.naa * L.p.naa;
  L.threads = out == 2 ? rmt::pixel_threads(S) : rmt::MARCH_THREADS;
  if (out == 2 && (S < 1 || L.threads > rmt::PIXEL_MAX_THREADS || n % S != 0))
    return (int)cudaErrorInvalidValue;
  L.grid = (unsigned)((n + (long long)L.threads - 1) / L.threads);
  L.st = (cudaStream_t)stream;
  L.stk = stk;
  L.origins = origins;
  L.dirs = dirs;
  L.cam = cam;
  L.bound = bound;
  L.n = n;
  L.o0 = o0;
  L.o1 = o1;
  L.o2 = o2;
  L.steps = steps;
  const bool relax = L.p.relax > 1.0f;
  if (out == 0) return (int)rmt::launch_march_rays(L, rays, dyn != 0, relax);
  if (out == 1)
    return (int)rmt::launch_march_render(L, mats != 0, dyn != 0, relax);
  return (int)rmt::launch_march_pixels(L, mats != 0, dyn != 0, relax);
}

}  // extern "C"
