// The coarse (cone) kernel of the cone-prepass renderer: the device code
// that prepass.cu (the static-tape builds, MODE 0-2) and prepass_dyn.cu (the
// DYN builds, MODE 3 and 4) instantiate. prepass.cu's header describes it.
#pragma once

#include <cuda_runtime.h>

#include "fine.cuh"
#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

constexpr int COARSE_THREADS = 128;

// The cone march of one centre ray from (t, live) at cone angle omega
// (_cone_march_tile, 157-174) -> status; t ends at the stop distance.
template <int MODE>
__device__ __forceinline__ float cone_march(const SceneView& sc,
                                            const CullView& cv, int tile,
                                            const Ray& r, const RenderParams& p,
                                            float omega, float inv1w,
                                            float live, float& t,
                                            float t_cap) {
  float near = 0.0f;
  for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
    const float d = scene_distance_tile<MODE>(
        sc, cv, tile, r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
    const float slack = d - omega * t;
    if (slack < p.min_dist) {
      near = 1.0f;
      live = 0.0f;
    } else if (d > p.max_dist || t > t_cap) {
      live = 0.0f;
    } else {
      t = t + slack * inv1w;
    }
  }
  return near;
}

// The centre ray's scan for near intervals (_cone_interval_march_tile,
// 225-293): plain sphere steps inside a near zone, cone steps outside, for
// 2 * max_iter steps. idx counts the closed zones. A zone's end reverts to
// FAR_T when the centre ray hits inside it, when the budget ends with it
// open, and (the last zone) when one more zone would open; the ray then
// stops. Indices are selected by unrolled compares so that st/en stay in
// registers.
template <int MODE>
__device__ __forceinline__ void interval_scan(const SceneView& sc,
                                              const CullView& cv, int tile,
                                              const Ray& r,
                                              const RenderParams& p,
                                              const BlockParams& bp,
                                              float live, float t,
                                              float t_cap, float (&st)[MAX_NI],
                                              float (&en)[MAX_NI]) {
#pragma unroll
  for (int q = 0; q < MAX_NI; ++q) st[q] = en[q] = FAR_T;
  bool was_near = false;
  int idx = 0;
  for (int k = 0; k < 2 * p.max_iter && live > 0.0f; ++k) {
    const float d = scene_distance_tile<MODE>(
        sc, cv, tile, r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
    const float slack = d - p.omega * t;
    const bool near = slack < p.min_dist;
    const bool hit_c = near && d < p.min_dist;
    const bool esc = !hit_c && (d > p.max_dist || t > t_cap);
    const bool closing = was_near && (!near || esc);
    const bool overflow = near && !was_near && idx >= bp.ni;
    const bool opening = near && !was_near && !overflow;
#pragma unroll
    for (int q = 0; q < MAX_NI; ++q) {
      if (q == idx) {
        if (opening) st[q] = t;
        if (closing) en[q] = t;
        if (hit_c) en[q] = FAR_T;
      }
      if (overflow && q == bp.ni - 1) en[q] = FAR_T;
    }
    if (closing) ++idx;
    const bool live2 = !(hit_c || esc || overflow);
    if (live2) t = t + (near ? d : slack * p.inv1w);
    was_near = near && live2;
    live = live2 ? 1.0f : 0.0f;
  }
  if (was_near) {
#pragma unroll
    for (int q = 0; q < MAX_NI; ++q)
      if (q == idx) en[q] = FAR_T;
  }
}

// KIND 0: one thread per pixel of the band, writes t0 and status
// f32[rows, width] (B = 1, no intervals). KIND 1: one thread per block of
// the band, t0 and status f32[brows, bcols]. KIND 2: one thread per block,
// the 2*ni interval planes f32[2*ni, brows, bcols] (starts, then ends) at
// t0_out. MODE is the culling mode (CullView::mode); under culling a block
// reads the coarse tile that holds it (tiles of whole blocks).
template <int MODE, int KIND>
__global__ void coarse_kernel(SceneView sc, const float* __restrict__ cam,
                              const float* __restrict__ bound, RenderParams p,
                              CullView cv, float* __restrict__ t0_out,
                              float* __restrict__ status_out, BlockParams bp) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if constexpr (KIND == 0) {
    if (j >= p.width || i >= p.rows) return;
    // Pixel-centre screen coordinates, f32 op order of pallas_prepass.py:910-911.
    const float x = 2.0f * ((float)j + 0.5f) / (float)p.width - 1.0f;
    const float y =
        1.0f - 2.0f * (((float)i + 0.5f) + __ldg(cam + 7)) / (float)p.height;
    const Ray r = view_ray(cam, p, x, y);

    const int tile = mode_culled(MODE) ? tile_of(cv, i, j) : 0;
    float live = 1.0f, t = 0.0f, t_cap = 3.0e38f;
    if (p.use_bound) bound_clip(bound, r, p.min_dist, live, t, t_cap);
    float near = 0.0f;
    for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
      const float d = scene_distance_tile<MODE>(
          sc, cv, tile, r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
      const float slack = d - p.omega * t;
      if (slack < p.min_dist) {
        near = 1.0f;
        live = 0.0f;
      } else if (d > p.max_dist || t > t_cap) {
        live = 0.0f;
      } else {
        t = t + slack * p.inv1w;
      }
    }
    const size_t o = (size_t)i * p.width + j;
    t0_out[o] = t;
    status_out[o] = near;
  } else {
    if (j >= bp.bcols || i >= bp.brows) return;
    // Block-centre screen coordinates (910-911): an edge block's centre may
    // lie outside the image and is marched all the same.
    const float bsz = (float)bp.block;
    const float x = 2.0f * (((float)j + 0.5f) * bsz) / (float)p.width - 1.0f;
    const float y =
        1.0f - 2.0f * (((float)i + 0.5f) * bsz + __ldg(cam + 7)) / (float)p.height;
    const Ray r = view_ray(cam, p, x, y);
    const int tile = mode_culled(MODE) ? tile_of(cv, i, j) : 0;
    float live = 1.0f, t = 0.0f, t_cap = FAR_T;
    if (p.use_bound) bound_clip(bound, r, p.min_dist, live, t, t_cap);
    const size_t o = (size_t)i * bp.bcols + j;
    if constexpr (KIND == 2) {
      float st[MAX_NI], en[MAX_NI];
      interval_scan<MODE>(sc, cv, tile, r, p, bp, live, t, t_cap, st, en);
      const size_t plane = (size_t)bp.brows * bp.bcols;
#pragma unroll
      for (int q = 0; q < MAX_NI; ++q) {
        if (q < bp.ni) {
          t0_out[q * plane + o] = st[q];
          t0_out[(bp.ni + q) * plane + o] = en[q];
        }
      }
    } else {
      const float near = cone_march<MODE>(sc, cv, tile, r, p, p.omega, p.inv1w,
                                          live, t, t_cap);
      t0_out[o] = t;
      status_out[o] = near;
    }
  }
}

// The coarse kernel's launch, dispatched to its build by template flags.
struct CoarseLaunch {
  dim3 grid, block;
  cudaStream_t st;
  SceneView sc;
  const float *cam, *bound;
  RenderParams p;
  CullView cv;
  float *t0_out, *status_out;
  BlockParams bp;

  template <int MODE, int KIND>
  void go() const {
    coarse_kernel<MODE, KIND><<<grid, block, 0, st>>>(sc, cam, bound, p, cv,
                                                      t0_out, status_out, bp);
  }
  template <int MODE>
  void kinds(int kind) const {
    if (kind == 2) go<MODE, 2>();
    else if (kind == 1) go<MODE, 1>();
    else go<MODE, 0>();
  }
};

// Launches the DYN build (MODE 3 for cull mode 0, 4 for 2) of the coarse
// kernel (prepass_dyn.cu).
cudaError_t launch_coarse_dyn(const CoarseLaunch& L, int mode, int kind);

}  // namespace rmt
