// The unpacked fine pass K4: the device code that fine_unpacked.cu (PRE 1
// and 2) and intervals_wide.cu (PRE 4: more than MAX_NI intervals)
// instantiate. fine_unpacked.cu's header describes the kernel.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>

#include "fine.cuh"
#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

constexpr int UNPACKED_THREADS = 128;

// One thread per pixel (band row i = blockIdx.y, column j). Writes the
// image f32[rows, width, 3] and, when t_out is not null, the residuals t
// and hit f32[rows, width, S].
template <int MODE, bool RELAX, bool MATS, int PRE>
__global__ void fine_unpacked_kernel(SceneView sc, const float* __restrict__ cam,
                                     const float* __restrict__ bound,
                                     RenderParams p, CullView cv,
                                     const float* __restrict__ t0_in,
                                     const float* __restrict__ status_in,
                                     float* __restrict__ img,
                                     float* __restrict__ t_out,
                                     float* __restrict__ hit_out,
                                     BlockParams bp, int shared) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= p.width || i >= p.rows) return;
  const int S = p.naa * p.naa;
  const int tile = mode_culled(MODE) ? tile_of(cv, i, j) : 0;
  const TileScene<MODE> scene{sc, cv, tile};

  // The pixel's prepass: the same for all of its samples.
  float t_start = 0.0f, live0 = 1.0f;
  float st[MAX_NI], en[MAX_NI];
  std::conditional_t<PRE == 4, PlaneIntervals, NoPlanes> planes;
  if constexpr (PRE == 2) {
    // A ray lives iff its block has a first interval, and starts there
    // (pallas_prepass.py:1118-1122).
    const size_t po = (size_t)(i / bp.block) * bp.bcols + j / bp.block;
    const size_t plane = (size_t)bp.brows * bp.bcols;
#pragma unroll
    for (int n = 0; n < MAX_NI; ++n) {
      st[n] = n < bp.ni ? t0_in[n * plane + po] : FAR_T;
      en[n] = n < bp.ni ? t0_in[(bp.ni + n) * plane + po] : FAR_T;
    }
    live0 = st[0] < FAR_TEST ? 1.0f : 0.0f;
    t_start = live0 > 0.0f ? st[0] : 0.0f;
  } else if constexpr (PRE == 4) {
    // More than MAX_NI intervals: read in place (st, en unused).
    const size_t po = (size_t)(i / bp.block) * bp.bcols + j / bp.block;
    planes.load(t0_in, (size_t)bp.brows * bp.bcols, po, bp.ni);
    live0 = planes.st(0) < FAR_TEST ? 1.0f : 0.0f;
    t_start = live0 > 0.0f ? planes.st(0) : 0.0f;
  } else if (!p.no_prepass) {
    // Block planes, or pixel planes (B = 1, or after the chained pass).
    const int pb = bp.chain ? 1 : bp.block;
    const int pcols = bp.chain ? p.width : bp.bcols;
    const size_t po = (size_t)(i / pb) * pcols + j / pb;
    t_start = t0_in[po];
    live0 = status_in[po];
  }

  float nx = 0.0f, ny = 0.0f, nz = 0.0f;  // the pixel's shared normal
  bool have_normal = false;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int s = 0; s < S; ++s) {
    float x, y;
    aa_screen_xy(cam, p, i, j, s, x, y);
    const Ray r = view_ray(cam, p, x, y);
    float t = t_start;
    float t_cap = FAR_T;
    if (p.use_bound) {
      // Only the exit cap matters: the start comes from the prepass.
      float l = live0, t_unused = t;
      bound_clip(bound, r, p.min_dist, l, t_unused, t_cap);
    }
    float hit;
    if constexpr (PRE == 2) {
      hit = interval_march<RELAX>(scene, r, p, st, en, live0, t, t_cap);
    } else if constexpr (PRE == 4) {
      hit = interval_march<RELAX>(scene, r, p, st, en, live0, t, t_cap,
                                  planes);
    } else {
      hit = legacy_march<RELAX>(scene, r, p, live0, t, t_cap);
    }
    if (t_out != nullptr) {
      const size_t ri = ((size_t)i * p.width + j) * S + s;
      t_out[ri] = t;
      hit_out[ri] = hit;
    }

    float diff = 0.0f;
    float alb[3] = {p.albedo[0], p.albedo[1], p.albedo[2]};
    if (hit > 0.0f) {
      const float px = r.ox + r.dx * t;
      const float py = r.oy + r.dy * t;
      const float pz = r.oz + r.dz * t;
      if (!(shared && have_normal)) {
        tet_normal(scene, p.eps, px, py, pz, nx, ny, nz);
        have_normal = true;
      }
      diff = lambert<MATS>(scene, p, px, py, pz, nx, ny, nz, alb);
    }
    float fc[3];
    floor_colour(r, p, fc);
    const float miss = 1.0f - hit;
    cr = cr + sqrtf(fmaxf(hit * (alb[0] * diff) + miss * fc[0], 0.0f) + 1e-12f);
    cg = cg + sqrtf(fmaxf(hit * (alb[1] * diff) + miss * fc[1], 0.0f) + 1e-12f);
    cb = cb + sqrtf(fmaxf(hit * (alb[2] * diff) + miss * fc[2], 0.0f) + 1e-12f);
  }
  float* out = img + ((size_t)i * p.width + j) * 3;
  out[0] = cr * p.inv_s;
  out[1] = cg * p.inv_s;
  out[2] = cb * p.inv_s;
}

struct UnpackedLaunch;
// Launches the PRE 4 build (more than MAX_NI intervals) of
// fine_unpacked_kernel<MODE, RELAX, MATS, 4>: in fine_unpacked_wide.cu.
template <int MODE, bool RELAX, bool MATS>
void unpacked_wide(const UnpackedLaunch& L);

// K4's launch, dispatched to its build by template flags. pre is the
// prepass planes: 1 pixel or block planes (or none), 2 at most MAX_NI
// intervals, 4 more.
struct UnpackedLaunch {
  dim3 grid, block;
  cudaStream_t st;
  SceneView sc;
  const float *cam, *bound;
  RenderParams p;
  CullView cv;
  const float *t0_in, *status_in;
  float *img, *t_out, *hit_out;
  BlockParams bp;
  int shared;

  template <int MODE, bool RELAX, bool MATS, int PRE>
  void go() const {
    fine_unpacked_kernel<MODE, RELAX, MATS, PRE><<<grid, block, 0, st>>>(
        sc, cam, bound, p, cv, t0_in, status_in, img, t_out, hit_out, bp,
        shared);
  }
  template <int MODE, bool RELAX, bool MATS>
  void pre(int pre) const {
    if (pre == 4) unpacked_wide<MODE, RELAX, MATS>(*this);
    else if (pre == 2) go<MODE, RELAX, MATS, 2>();
    else go<MODE, RELAX, MATS, 1>();
  }
  template <int MODE>
  void flags(bool relax, bool mats, int pre_) const {
    if (relax) {
      if (mats) pre<MODE, true, true>(pre_);
      else pre<MODE, true, false>(pre_);
    } else {
      if (mats) pre<MODE, false, true>(pre_);
      else pre<MODE, false, false>(pre_);
    }
  }
};

}  // namespace rmt
