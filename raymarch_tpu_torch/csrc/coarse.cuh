// The coarse (cone) kernel and the chained pixel kernel of the cone-prepass
// renderer: the device code that prepass.cu (the coarse kernel's static-tape
// builds, MODE 0-2), prepass_dyn.cu (its DYN builds, MODE 3 and 4) and
// coarse_px.cu (the chained pixel kernel's) instantiate. prepass.cu's and
// coarse_px.cu's headers describe them.
#pragma once

#include <cuda_runtime.h>

#include "fine.cuh"
#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

constexpr int COARSE_THREADS = 128;

// The cone march of one centre ray from (t, live) at cone angle omega
// (_cone_march_tile, 157-174) -> status; t ends at the stop distance.
// scene(px, py, pz) is the scene function (WordScene, for K1 and K3).
template <class Scene>
__device__ __forceinline__ float cone_march(const Scene& scene, const Ray& r,
                                            const RenderParams& p,
                                            float omega, float inv1w,
                                            float live, float& t,
                                            float t_cap) {
  float near = 0.0f;
  for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
    const float d = scene(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
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
// stops. The zones are written in place in the interval planes (any ni):
// a handful of stores per block, against an index that depends on the ray
// if they were kept in registers (which the compiler moves to local
// memory).
template <class Scene>
__device__ __forceinline__ void interval_scan(const Scene& scene,
                                              const Ray& r,
                                              const RenderParams& p,
                                              const BlockParams& bp,
                                              float live, float t,
                                              float t_cap,
                                              const PlaneIntervals& planes) {
  planes.clear();
  bool was_near = false;
  int idx = 0;
  for (int k = 0; k < 2 * p.max_iter && live > 0.0f; ++k) {
    const float d = scene(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
    const float slack = d - p.omega * t;
    const bool near = slack < p.min_dist;
    const bool hit_c = near && d < p.min_dist;
    const bool esc = !hit_c && (d > p.max_dist || t > t_cap);
    const bool closing = was_near && (!near || esc);
    const bool overflow = near && !was_near && idx >= bp.ni;
    const bool opening = near && !was_near && !overflow;
    planes.mark(idx, opening, closing, hit_c, overflow, t);
    if (closing) ++idx;
    const bool live2 = !(hit_c || esc || overflow);
    if (live2) t = t + (near ? d : slack * p.inv1w);
    was_near = near && live2;
    live = live2 ? 1.0f : 0.0f;
  }
  if (was_near) planes.reopen(idx);
}

// KIND 0: one thread per pixel of the band, writes t0 and status
// f32[rows, width] (B = 1, no intervals). KIND 1: one thread per block of
// the band, t0 and status f32[brows, bcols]. KIND 2: one thread per block,
// the 2*ni interval planes f32[2*ni, brows, bcols] (starts, then ends) at
// t0_out, written in place for any ni. MODE
// is the culling mode (CullView::mode); under culling a block reads the
// coarse tile that holds it (tiles of whole blocks). STK is the value
// stack's route (fine.cuh fine_kernel); the scene is read from its packed
// words.
template <int MODE, int KIND, int STK>
__global__ void coarse_kernel(SceneWords sw, const float* __restrict__ cam,
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
    const WordScene<MODE, STK> scene{sw, cv, tile};
    float live = 1.0f, t = 0.0f, t_cap = 3.0e38f;
    if (p.use_bound) bound_clip(bound, r, p.min_dist, live, t, t_cap);
    float near = 0.0f;
    for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
      const float d = scene(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
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
    const WordScene<MODE, STK> scene{sw, cv, tile};
    float live = 1.0f, t = 0.0f, t_cap = FAR_T;
    if (p.use_bound) bound_clip(bound, r, p.min_dist, live, t, t_cap);
    const size_t o = (size_t)i * bp.bcols + j;
    if constexpr (KIND == 2) {
      PlaneIntervals planes;
      planes.load(t0_out, (size_t)bp.brows * bp.bcols, o, bp.ni);
      interval_scan(scene, r, p, bp, live, t, t_cap, planes);
    } else {
      const float near =
          cone_march(scene, r, p, p.omega, p.inv1w, live, t, t_cap);
      t0_out[o] = t;
      status_out[o] = near;
    }
  }
}

// The coarse kernel's launch, dispatched to its build by template flags:
// the planes `kind` (KIND) and the stack route stk (STK).
struct CoarseLaunch {
  dim3 grid, block;
  cudaStream_t st;
  SceneWords sw;
  int stk;
  const float *cam, *bound;
  RenderParams p;
  CullView cv;
  float *t0_out, *status_out;
  BlockParams bp;

  template <int MODE, int KIND, int STK>
  void run() const {
    const size_t smem =
        STK == STK_SMEM ? (size_t)sw.rows * block.x * sizeof(float) : 0;
    coarse_kernel<MODE, KIND, STK><<<grid, block, smem, st>>>(
        sw, cam, bound, p, cv, t0_out, status_out, bp);
  }
  template <int MODE, int KIND>
  void go() const {
    if constexpr (!uses_stack(MODE, false)) {
      run<MODE, KIND, REG_STACK>();
    } else if (stk == REG_STACK) {
      run<MODE, KIND, REG_STACK>();
    } else {
      run<MODE, KIND, STK_SMEM>();
    }
  }
  template <int MODE>
  void kinds(int kind) const {
    if (kind == 2) go<MODE, 2>();
    else if (kind == 1) go<MODE, 1>();
    else go<MODE, 0>();
  }
};

// Launches the coarse kernel's build of MODE for the planes `kind`:
// instantiated for MODE 0-2 in prepass.cu, 3 and 4 (DYN) in
// prepass_dyn.cu.
template <int MODE>
cudaError_t launch_coarse(const CoarseLaunch& L, int kind) {
  L.kinds<MODE>(kind);
  return cudaGetLastError();
}
extern template cudaError_t launch_coarse<0>(const CoarseLaunch&, int);
extern template cudaError_t launch_coarse<1>(const CoarseLaunch&, int);
extern template cudaError_t launch_coarse<2>(const CoarseLaunch&, int);
extern template cudaError_t launch_coarse<3>(const CoarseLaunch&, int);
extern template cudaError_t launch_coarse<4>(const CoarseLaunch&, int);

// The chained pixel kernel K3 (prepass_chain, B > 1), one thread per pixel
// of the band: the pixel's cone ray at omega_px over the whole tape, started
// at max(its bound-clip start, its block's t0) and dead where its block's
// status is 0 (_cone_march_tile 152-154). Writes t0 and status f32[rows,
// width]. MODE 0 reads the static tape, 3 the frame's dynamic tape, from
// its packed words on stack route STK (WordScene; un-culled, as the
// reference's, so cv and tile go unread): coarse_px.cu.
//
// A warp is a PX_TILE_W x PX_TILE_H tile of pixels (lane = row-in-tile *
// PX_TILE_W + column-in-tile), a block PX_WARPS such tiles side by side:
// at B = 4 a warp's 32 pixels lie in two B x B blocks, so they start at
// two block stop distances, die together where a block is dead, and stop
// within a few steps of each other (a row of 32 pixels spans eight
// blocks).
constexpr int PX_TILE_W = 8;
constexpr int PX_TILE_H = 4;
constexpr int PX_WARPS = COARSE_THREADS / 32;

template <int MODE, int STK>
__global__ void coarse_px_kernel(SceneWords sw, const float* __restrict__ cam,
                                 const float* __restrict__ bound,
                                 RenderParams p,
                                 const float* __restrict__ t_blk,
                                 const float* __restrict__ status_blk,
                                 float* __restrict__ t0_out,
                                 float* __restrict__ status_out,
                                 BlockParams bp) {
  const int lane = threadIdx.x & 31;
  const int j = (blockIdx.x * PX_WARPS + (threadIdx.x >> 5)) * PX_TILE_W +
                lane % PX_TILE_W;
  const int i = blockIdx.y * PX_TILE_H + lane / PX_TILE_W;
  if (j >= p.width || i >= p.rows) return;
  const float x = 2.0f * ((float)j + 0.5f) / (float)p.width - 1.0f;
  const float y =
      1.0f - 2.0f * (((float)i + 0.5f) + __ldg(cam + 7)) / (float)p.height;
  const Ray r = view_ray(cam, p, x, y);
  float live = 1.0f, t = 0.0f, t_cap = FAR_T;
  if (p.use_bound) bound_clip(bound, r, p.min_dist, live, t, t_cap);
  const size_t bo = (size_t)(i / bp.block) * bp.bcols + j / bp.block;
  const float live_in = status_blk[bo];
  live = live * live_in;
  t = fmaxf(t, t_blk[bo]) * live_in;
  const CullView uncull{};
  const WordScene<MODE, STK> scene{sw, uncull, 0};
  const float near =
      cone_march(scene, r, p, bp.omega_px, bp.inv1w_px, live, t, t_cap);
  const size_t o = (size_t)i * p.width + j;
  t0_out[o] = t;
  status_out[o] = near;
}

}  // namespace rmt
