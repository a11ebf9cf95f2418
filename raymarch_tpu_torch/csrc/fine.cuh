// The fine kernel (march + shade + AA mean) of the cone-prepass renderer:
// the device code that prepass.cu (the hard builds, with nvcc's default FMA
// contraction) and fine_soft.cu (the soft builds, compiled with
// -fmad=false) instantiate. prepass.cu's header describes the kernel.
//
// The soft builds round every operation on its own, as the plain torch
// versions do: a soft ray's closest approach is the argmin over its
// samples, and on a grazing ray two samples can lie within an ulp of each
// other, so a contracted FMA anywhere in the march or the scene moves t_min
// by a whole step and the surface term with it (a quarter of a sample's
// colour).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

// Scene bounding-sphere clip (_bound_clip, 107-127). bound = (c3, R, valid).
// Updates live / t0 / t_cap only when the bound is valid.
__device__ __forceinline__ void bound_clip(const float* __restrict__ bound,
                                           const Ray& r, float min_dist,
                                           float& live, float& t0,
                                           float& t_cap) {
  const float bcx = __ldg(bound + 0), bcy = __ldg(bound + 1),
              bcz = __ldg(bound + 2), br = __ldg(bound + 3);
  if (!(__ldg(bound + 4) > 0.0f)) return;
  const float ocx = r.ox - bcx;
  const float ocy = r.oy - bcy;
  const float ocz = r.oz - bcz;
  const float bq = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - br * br;
  const float disc = bq * bq - c2;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t_enter = -bq - sq;
  const float t_exit = -bq + sq;
  const float hit_bound = (disc > 0.0f && t_exit > 0.0f) ? live : 0.0f;
  live = hit_bound;
  t0 = fmaxf(t_enter, 0.0f) * hit_bound;
  t_cap = t_exit + min_dist;
}

constexpr int MAX_NI = 4;          // near intervals a build keeps in registers
constexpr float FAR_T = 3.0e38f;   // "no interval" (pallas_prepass.py:188)
// A multiple of 64: a pixel's 64 samples (aa_samples = 8) share a block.
constexpr int FINE_THREADS = 128;
constexpr float FAR_TEST = 9.0e37f;

// The soft build's outputs and constants (PRE 3), the fine kernel's last
// argument; mirrored by cuda_prepass.py:_CSoftParams. s_min_out and
// t_min_out f32[rows, width, S] may be null (no residuals).
struct SoftParams {
  float* s_min_out;
  float* t_min_out;
  float beta_inv;  // f32(1 / coverage_beta)
  float infl;      // f32(min_dist + soft_cull_log_alpha * coverage_beta)
};

// The soft march of one AA ray from t = 0 (_fine_march_tile_soft, 380-476)
// -> hit; t ends where the ray does, s_min is the smallest scene distance
// met at a sample (strict <) and t_min its t. With bound_accel the scene's
// bounding sphere, inflated by infl, clips the ray (a ray that misses it
// has alpha 0 either way), caps t at -bq + R + min_dist and ends the ray
// past the sphere's centre once |p - c| - R exceeds s_min: no later sample
// could lower s_min or hit. At most max_iter samples count.
template <int MODE>
__device__ __forceinline__ float soft_march(const SceneView& sc,
                                            const CullView& cv, int tile,
                                            const Ray& r,
                                            const float* __restrict__ bound,
                                            const RenderParams& p, float infl,
                                            float& t, float& s_min,
                                            float& t_min) {
  float live = 1.0f, t_cap = FAR_T, t_mid = FAR_T;
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f, br = 0.0f;
  if (p.use_bound && __ldg(bound + 4) > 0.0f) {
    bcx = __ldg(bound + 0);
    bcy = __ldg(bound + 1);
    bcz = __ldg(bound + 2);
    br = __ldg(bound + 3) + infl;
    const float ocx = r.ox - bcx;
    const float ocy = r.oy - bcy;
    const float ocz = r.oz - bcz;
    const float bq = r.dx * ocx + r.dy * ocy + r.dz * ocz;
    const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - br * br;
    const float disc = bq * bq - c2;
    const float t_exit = -bq + sqrtf(fmaxf(disc, 0.0f));
    if (!(disc > 0.0f && t_exit > 0.0f)) live = 0.0f;
    t_cap = -bq + br + p.min_dist;
    t_mid = -bq;
  }
  t = 0.0f;
  s_min = FAR_T;
  t_min = 0.0f;
  float hit = 0.0f;
  for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
    const float px = r.ox + r.dx * t;
    const float py = r.oy + r.dy * t;
    const float pz = r.oz + r.dz * t;
    const float d = scene_distance_tile<MODE>(sc, cv, tile, px, py, pz);
    if (d < s_min) {
      s_min = d;
      t_min = t;
    }
    if (d < p.min_dist) {
      hit = 1.0f;
      live = 0.0f;
    } else if (d > p.max_dist || t > t_cap) {
      live = 0.0f;
    } else if (t > t_mid) {
      const float pcx = px - bcx, pcy = py - bcy, pcz = pz - bcz;
      if (sqrtf(pcx * pcx + pcy * pcy + pcz * pcz + 1e-20f) - br > s_min)
        live = 0.0f;
    }
    if (live > 0.0f) t = t + d;
  }
  return hit;
}

// The fine march of one AA ray through its block's near intervals
// (_fine_march_interval_tile, 327-362) -> hit; t ends where the ray does.
// Plain steps inside interval idx (RELAX: over-relaxed, with the fallback
// of the legacy march); a step past e_idx jumps to max(t, s_{idx+1}) with
// omega, step and previous radius reset, or is a miss when no interval is
// left. Hit and escape are tested only at samples that did not overshoot.
template <int MODE, bool RELAX>
__device__ __forceinline__ float interval_march(const SceneView& sc,
                                                const CullView& cv, int tile,
                                                const Ray& r,
                                                const RenderParams& p,
                                                const float (&st)[MAX_NI],
                                                const float (&en)[MAX_NI],
                                                float live, float& t,
                                                float t_cap) {
  float hit = 0.0f;
  float prev_r = 0.0f, step_len = 0.0f, omega = p.relax;
  int idx = 0;
  for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
    const float d = scene_distance_tile<MODE>(
        sc, cv, tile, r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
    float new_step = d;
    bool fail = false;
    if constexpr (RELAX) {
      fail = omega > 1.0f && d + prev_r < step_len;
      new_step = fail ? p.relax_back * step_len : omega * d;
      if (fail) omega = 1.0f;
    }
    if (!fail) {
      if (d < p.min_dist) {
        hit = 1.0f;
        live = 0.0f;
      } else if (d > p.max_dist || t > t_cap) {
        live = 0.0f;
      }
    }
    if (live > 0.0f) {
      const float t2 = t + new_step;
      float e = FAR_T, ns = FAR_T;  // e_idx, and s_{idx+1} (FAR_T past the last)
#pragma unroll
      for (int q = 0; q < MAX_NI; ++q) {
        if (q == idx) e = en[q];
        if (q == idx + 1) ns = st[q];
      }
      if (t2 > e && ns > FAR_TEST) {
        t = t2;
        live = 0.0f;  // no interval left: a miss
      } else if (t2 > e) {
        t = fmaxf(t2, ns);
        ++idx;
        omega = p.relax;
        step_len = 0.0f;
        prev_r = 0.0f;
        continue;
      } else {
        t = t2;
      }
    }
    prev_r = d;
    step_len = new_step;
  }
  return hit;
}

// The fine march of one AA ray from (t, live) (_fine_march_tile, 477-525)
// -> hit; t ends where the ray does. Plain sphere-tracing steps or, with
// RELAX, over-relaxed stepping: step omega*d; when consecutive safe spheres
// stop overlapping the step overshot, so step back by (1 - relax)*step and
// drop the ray to omega = 1. Hit and escape are tested only at samples that
// did not overshoot. The march of K2's legacy planes and of K4.
template <int MODE, bool RELAX>
__device__ __forceinline__ float legacy_march(const SceneView& sc,
                                              const CullView& cv, int tile,
                                              const Ray& r,
                                              const RenderParams& p,
                                              float live, float& t,
                                              float t_cap) {
  float hit = 0.0f;
  if constexpr (RELAX) {
    float prev_r = 0.0f, step_len = 0.0f, omega = p.relax;
    for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
      const float d = scene_distance_tile<MODE>(
          sc, cv, tile, r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
      const bool fail = omega > 1.0f && d + prev_r < step_len;
      const float new_step = fail ? p.relax_back * step_len : omega * d;
      if (fail) {
        omega = 1.0f;
      } else if (d < p.min_dist) {
        hit = 1.0f;
        live = 0.0f;
      } else if (d > p.max_dist || t > t_cap) {
        live = 0.0f;
      }
      if (live > 0.0f) t = t + new_step;
      prev_r = d;
      step_len = new_step;
    }
  } else {
    for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
      const float d = scene_distance_tile<MODE>(
          sc, cv, tile, r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
      if (d < p.min_dist) {
        hit = 1.0f;
        live = 0.0f;
      } else if (d > p.max_dist || t > t_cap) {
        live = 0.0f;
      } else {
        t = t + d;
      }
    }
  }
  return hit;
}

// The tetrahedron taps' unnormalised normal at p (pallas_march._tet_taps
// 1049): k in {(+,-,-), (-,-,+), (-,+,-), (+,+,+)}, summed in that order.
template <int MODE>
__device__ __forceinline__ void tet_normal(const SceneView& sc,
                                           const CullView& cv, int tile,
                                           float e, float px, float py,
                                           float pz, float& nx, float& ny,
                                           float& nz) {
  const float d0 = scene_distance_tile<MODE>(sc, cv, tile, px + e, py - e, pz - e);
  const float d1 = scene_distance_tile<MODE>(sc, cv, tile, px - e, py - e, pz + e);
  const float d2 = scene_distance_tile<MODE>(sc, cv, tile, px - e, py + e, pz - e);
  const float d3 = scene_distance_tile<MODE>(sc, cv, tile, px + e, py + e, pz + e);
  nx = 0.0f;
  ny = 0.0f;
  nz = 0.0f;
  nx = nx + d0; ny = ny - d0; nz = nz - d0;
  nx = nx - d1; ny = ny - d1; nz = nz + d1;
  nx = nx - d2; ny = ny + d2; nz = nz - d2;
  nx = nx + d3; ny = ny + d3; nz = nz + d3;
}

// Lambert's diffuse term of the surface point p with normal n against the
// point light, floored at the ambient term; with MATS, alb takes the
// albedo the tape's colour walk carries to p (scene_color, gated by the
// tile's leaf mask under culling, as the reference's colour pass is).
template <int MODE, bool MATS>
__device__ __forceinline__ float lambert(const SceneView& sc,
                                         const CullView& cv, int tile,
                                         const RenderParams& p, float px,
                                         float py, float pz, float nx,
                                         float ny, float nz, float alb[3]) {
  const float ninv = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz + 1e-20f);
  const float tlx = px - p.light[0];
  const float tly = py - p.light[1];
  const float tlz = pz - p.light[2];
  const float linv = 1.0f / sqrtf(tlx * tlx + tly * tly + tlz * tlz + 1e-20f);
  float diff = (nx * tlx + ny * tly + nz * tlz) * (ninv * linv);
  diff = fmaxf(diff, p.ambient);
  if constexpr (MATS) {
    scene_color<mode_dyn(MODE)>(
        sc, px, py, pz, p.albedo, alb,
        mode_culled(MODE) ? cv.masks + (size_t)tile * cv.n_words : nullptr);
  }
  return diff;
}

// One thread per AA ray. Lane q of a row is (pixel j, sample s) with
// q = j * S + s, so a pixel's S samples sit in S adjacent lanes of one warp
// (S divides 32, or is 64 and fills two warps; the wrapper checks). Writes the image f32[rows, width, 3]
// and, when t_out is not null, the residuals t and hit f32[rows, width, S]
// (with PRE 3 also s_min and t_min, at sp).
// MODE is the culling mode (scene_eval.cuh; 3 and 4 the DYN builds, in
// prepass_dyn.cu), RELAX whether cfg.relax > 1, MATS whether the
// scene carries materials, PRE the prepass planes: 0 t0_in and status_in
// f32[rows, width] (or none with no_prepass), 1 the same at block
// resolution f32[brows, bcols], 2 the 2*ni interval planes f32[2*ni, brows,
// bcols] at t0_in; 3 none: the soft build. MO is the march-only build
// (pallas_prepass.py:1621-1640, launched at 1827): it writes t_out and
// hit_out, flat in pixel-major AA-ray order, and skips the taps, the
// shading and the image.
template <int MODE, bool RELAX, bool MATS, int PRE, bool MO = false>
__global__ void fine_kernel(SceneView sc, const float* __restrict__ cam,
                            const float* __restrict__ bound, RenderParams p,
                            CullView cv, const float* __restrict__ t0_in,
                            const float* __restrict__ status_in,
                            float* __restrict__ img,
                            float* __restrict__ t_out,
                            float* __restrict__ hit_out, BlockParams bp,
                            SoftParams sp) {
  const int S = p.naa * p.naa;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int j = q / S;
  const int s = q - j * S;
  // Threads past the row's end still run the shuffles below, with zeros.
  const bool valid = j < p.width && i < p.rows;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (valid) {
    float x, y;
    aa_screen_xy(cam, p, i, j, s, x, y);
    const Ray r = view_ray(cam, p, x, y);
    const int tile = mode_culled(MODE) ? tile_of(cv, i, j) : 0;
    float t, hit = 0.0f;
    float s_min = 0.0f, t_min = 0.0f;
    if constexpr (PRE == 3) {
      hit = soft_march<MODE>(sc, cv, tile, r, bound, p, sp.infl, t, s_min,
                             t_min);
    } else {
      float live;
      if constexpr (PRE == 2) {
        // A ray lives iff its block has a first interval, and starts there
        // (pallas_prepass.py:1604-1608).
        const float s0 = t0_in[(size_t)(i / bp.block) * bp.bcols + j / bp.block];
        live = s0 < FAR_TEST ? 1.0f : 0.0f;
        t = live > 0.0f ? s0 : 0.0f;
      } else if (p.no_prepass) {
        t = 0.0f;
        live = 1.0f;
      } else if constexpr (PRE == 1) {
        const size_t po = (size_t)(i / bp.block) * bp.bcols + j / bp.block;
        t = t0_in[po];
        live = status_in[po];
      } else {
        const size_t o = (size_t)i * p.width + j;
        t = t0_in[o];
        live = status_in[o];
      }
      float t_cap = 3.0e38f;
      if (p.use_bound) {
        // Only the exit cap matters: the start comes from the prepass.
        float l = live, t_unused = t;
        bound_clip(bound, r, p.min_dist, l, t_unused, t_cap);
      }
      if constexpr (PRE == 2) {
        // The block's intervals, FAR_T past the last.
        const size_t po = (size_t)(i / bp.block) * bp.bcols + j / bp.block;
        const size_t plane = (size_t)bp.brows * bp.bcols;
        float st[MAX_NI], en[MAX_NI];
  #pragma unroll
        for (int n = 0; n < MAX_NI; ++n) {
          st[n] = n < bp.ni ? t0_in[n * plane + po] : FAR_T;
          en[n] = n < bp.ni ? t0_in[(bp.ni + n) * plane + po] : FAR_T;
        }
        hit = interval_march<MODE, RELAX>(sc, cv, tile, r, p, st, en, live, t,
                                          t_cap);
      } else {
        hit = legacy_march<MODE, RELAX>(sc, cv, tile, r, p, live, t, t_cap);
      }
    }
    if (t_out != nullptr) {
      const size_t ri = ((size_t)i * p.width + j) * S + s;
      t_out[ri] = t;
      hit_out[ri] = hit;
      if constexpr (PRE == 3) {
        sp.s_min_out[ri] = s_min;
        sp.t_min_out[ri] = t_min;
      }
    }
    if constexpr (MO) return;

    // The surface term's point and coverage: the hit point and the hit
    // mask; soft, the march end, the closest approach or the origin, and
    // alpha. A miss takes diff = 0 and the default albedo (shade_miss,
    // 1683-1694).
    float cover = hit, px, py, pz;
    if constexpr (PRE == 3) {
      cover = soft_alpha(s_min, p.min_dist, sp.beta_inv);
      const float te = hit > 0.5f ? t : t_min;
      const bool lv = cover > 1e-4f;
      px = lv ? r.ox + r.dx * te : r.ox;
      py = lv ? r.oy + r.dy * te : r.oy;
      pz = lv ? r.oz + r.dz * te : r.oz;
    } else {
      px = r.ox + r.dx * t;
      py = r.oy + r.dy * t;
      pz = r.oz + r.dz * t;
    }
    float diff = 0.0f;
    float alb[3] = {p.albedo[0], p.albedo[1], p.albedo[2]};
    if (cover > 0.0f) {
      float nx, ny, nz;
      tet_normal<MODE>(sc, cv, tile, p.eps, px, py, pz, nx, ny, nz);
      diff = lambert<MODE, MATS>(sc, cv, tile, p, px, py, pz, nx, ny, nz, alb);
    }

    // Analytic checkerboard floor on a miss (wgsl:117-128).
    float fc[3];
    floor_colour(r, p, fc);
    const float miss = 1.0f - cover;
    cr = sqrtf(fmaxf(cover * (alb[0] * diff) + miss * fc[0], 0.0f) + 1e-12f);
    cg = sqrtf(fmaxf(cover * (alb[1] * diff) + miss * fc[1], 0.0f) + 1e-12f);
    cb = sqrtf(fmaxf(cover * (alb[2] * diff) + miss * fc[2], 0.0f) + 1e-12f);
  }

  if constexpr (MO) return;  // no image: the threads past the row's end
  // AA mean over the pixel's S adjacent lanes, in registers: within the
  // warp, and for S = 64 (a pixel over two warps of one block) the second
  // warp's sum joins the first's through shared memory.
  for (int off = (S < 32 ? S : 32) >> 1; off > 0; off >>= 1) {
    cr += __shfl_xor_sync(0xffffffffu, cr, off);
    cg += __shfl_xor_sync(0xffffffffu, cg, off);
    cb += __shfl_xor_sync(0xffffffffu, cb, off);
  }
  if (S > 32) {
    __shared__ float wsum[FINE_THREADS / 32][3];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      wsum[warp][0] = cr;
      wsum[warp][1] = cg;
      wsum[warp][2] = cb;
    }
    __syncthreads();
    if (s == 0) {
      cr += wsum[warp + 1][0];
      cg += wsum[warp + 1][1];
      cb += wsum[warp + 1][2];
    }
  }
  if (valid && s == 0) {
    float* out = img + ((size_t)i * p.width + j) * 3;
    out[0] = cr * p.inv_s;
    out[1] = cg * p.inv_s;
    out[2] = cb * p.inv_s;
  }
}

// The fine kernel's launch, dispatched to its build by template flags.
struct FineLaunch {
  dim3 grid, block;
  cudaStream_t st;
  SceneView sc;
  const float *cam, *bound;
  RenderParams p;
  CullView cv;
  const float *t0_in, *status_in;
  float *img, *t_out, *hit_out;
  BlockParams bp;
  SoftParams sp;

  template <int MODE, bool RELAX, bool MATS, int PRE>
  void go() const {
    fine_kernel<MODE, RELAX, MATS, PRE><<<grid, block, 0, st>>>(
        sc, cam, bound, p, cv, t0_in, status_in, img, t_out, hit_out, bp, sp);
  }
  template <int MODE, bool RELAX, bool MATS>
  void pre(int kind) const {
    if (kind == 2) go<MODE, RELAX, MATS, 2>();
    else if (kind == 1) go<MODE, RELAX, MATS, 1>();
    else go<MODE, RELAX, MATS, 0>();
  }
  template <int MODE>
  void flags(bool relax, bool mats, int kind) const {
    if (relax) {
      if (mats) pre<MODE, true, true>(kind);
      else pre<MODE, true, false>(kind);
    } else {
      if (mats) pre<MODE, false, true>(kind);
      else pre<MODE, false, false>(kind);
    }
  }
  // The march-only build (MO): no image, no materials.
  template <int MODE, bool RELAX, int PRE>
  void go_march() const {
    fine_kernel<MODE, RELAX, false, PRE, true><<<grid, block, 0, st>>>(
        sc, cam, bound, p, cv, t0_in, status_in, img, t_out, hit_out, bp, sp);
  }
  template <int MODE>
  void march_flags(bool relax, int kind) const {
    if (relax) {
      if (kind == 2) go_march<MODE, true, 2>();
      else if (kind == 1) go_march<MODE, true, 1>();
      else go_march<MODE, true, 0>();
    } else {
      if (kind == 2) go_march<MODE, false, 2>();
      else if (kind == 1) go_march<MODE, false, 1>();
      else go_march<MODE, false, 0>();
    }
  }
};

// Launches the soft build (PRE 3) for cull->mode `mode` (fine_soft.cu).
cudaError_t launch_fine_soft(const FineLaunch& L, int mode, bool mats);
// Launches the DYN build (MODE 3 for cull->mode 0, 4 for 2) of the hard
// fine kernel (prepass_dyn.cu).
cudaError_t launch_fine_dyn(const FineLaunch& L, int mode, bool relax,
                            bool mats, int kind);
// Launches the march-only build for cull->mode `mode` and prepass planes
// `kind` (fine_march.cu).
cudaError_t launch_fine_march(const FineLaunch& L, int mode, bool relax,
                              int kind);

}  // namespace rmt
