// The fine kernel (march + shade + AA mean) of the cone-prepass renderer:
// the device code that the K1/K2 sources (_build.py K12_SOURCES, every one
// with -fmad=false) instantiate, one group of builds each (launch_fine_hard
// below); prepass.cu's header describes the kernel. The march
// functions take the scene as a function of the point (scene_eval.cuh
// WordScene), and the unpacked fine pass K4 (fine_unpacked.cuh) shares
// them.
//
// Every K2 build rounds each operation on its own, as the plain torch
// versions do: a soft ray's closest approach is the argmin over its
// samples, and on a grazing ray two samples can lie within an ulp of each
// other, so a contracted FMA anywhere in the march or the scene would move
// t_min by a whole step and the surface term with it (a quarter of a
// sample's colour); a hard ray's slack that lands within rounding of
// min_dist would stop one step apart.
#pragma once

#include <cstdint>
#include <type_traits>

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

// The interval bounds of more than MAX_NI near intervals, read and written
// in place in the 2*ni interval planes (starts, then ends; block offset po,
// plane size `plane`) through L1: the PRE 4 builds of the fine passes
// (intervals_wide.cu) and every interval build of the coarse scan (KIND 2),
// so that no build caps n_intervals. The builds for at most MAX_NI keep
// them in registers (ShiftIntervals).
struct PlaneIntervals {
  float* base;  // the block's word of plane 0
  size_t plane;
  int ni;

  __device__ __forceinline__ void load(const float* planes, size_t plane_,
                                       size_t po, int ni_) {
    base = const_cast<float*>(planes) + po;
    plane = plane_;
    ni = ni_;
  }
  __device__ __forceinline__ float& st(int q) const { return base[q * plane]; }
  __device__ __forceinline__ float& en(int q) const {
    return base[(ni + q) * plane];
  }
  // The end of interval idx and the start of interval idx + 1 (FAR_T past
  // the last).
  __device__ __forceinline__ void bounds(int idx, float& e, float& ns) const {
    e = idx < ni ? en(idx) : FAR_T;
    ns = idx + 1 < ni ? st(idx + 1) : FAR_T;
  }
  // The interval scan's steps (coarse.cuh interval_scan).
  __device__ __forceinline__ void clear() const {
    for (int q = 0; q < ni; ++q) st(q) = en(q) = FAR_T;
  }
  __device__ __forceinline__ void mark(int idx, bool opening, bool closing,
                                       bool hit_c, bool overflow,
                                       float t) const {
    if (idx < ni) {
      if (opening) st(idx) = t;
      if (closing) en(idx) = t;
      if (hit_c) en(idx) = FAR_T;
    }
    if (overflow) en(ni - 1) = FAR_T;
  }
  __device__ __forceinline__ void reopen(int idx) const {
    if (idx < ni) en(idx) = FAR_T;
  }
};

// At most MAX_NI near intervals in registers (K2's PRE 2 builds): the
// current interval's end at en[0] and the next one's start at st[1]; a jump
// to the next interval shifts both arrays down. No index depends on the
// ray, so the arrays stay in registers (a compare against the ray's
// interval index lets the compiler fold the selects into an indexed load
// from local memory).
struct ShiftIntervals {
  mutable float st[MAX_NI], en[MAX_NI];

  __device__ __forceinline__ void load(const float* planes, size_t plane,
                                       size_t po, int ni) {
#pragma unroll
    for (int n = 0; n < MAX_NI; ++n) {
      st[n] = n < ni ? planes[n * plane + po] : FAR_T;
      en[n] = n < ni ? planes[(ni + n) * plane + po] : FAR_T;
    }
  }
  __device__ __forceinline__ void bounds(int, float& e, float& ns) const {
    e = en[0];
    ns = st[1];
  }
  __device__ __forceinline__ void advance() const {
#pragma unroll
    for (int n = 0; n + 1 < MAX_NI; ++n) {
      st[n] = st[n + 1];
      en[n] = en[n + 1];
    }
    st[MAX_NI - 1] = en[MAX_NI - 1] = FAR_T;
  }
};

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
template <class Scene>
__device__ __forceinline__ float soft_march(const Scene& scene, const Ray& r,
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
    const float d = scene(px, py, pz);
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
// The bounds come from `planes`: ShiftIntervals (at most MAX_NI intervals,
// in registers) or PlaneIntervals (PRE 4, in place). scene(px, py, pz) is
// the scene function (WordScene).
template <bool RELAX, class Scene, class Planes>
__device__ __forceinline__ float interval_march(const Scene& scene,
                                                const Ray& r,
                                                const RenderParams& p,
                                                float live, float& t,
                                                float t_cap,
                                                const Planes& planes) {
  float hit = 0.0f;
  float prev_r = 0.0f, step_len = 0.0f, omega = p.relax;
  int idx = 0;
  for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
    const float d = scene(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
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
      planes.bounds(idx, e, ns);
      if (t2 > e && ns > FAR_TEST) {
        t = t2;
        live = 0.0f;  // no interval left: a miss
      } else if (t2 > e) {
        t = fmaxf(t2, ns);
        ++idx;
        if constexpr (std::is_same<Planes, ShiftIntervals>::value)
          planes.advance();
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
template <bool RELAX, class Scene>
__device__ __forceinline__ float legacy_march(const Scene& scene,
                                              const Ray& r,
                                              const RenderParams& p,
                                              float live, float& t,
                                              float t_cap) {
  float hit = 0.0f;
  if constexpr (RELAX) {
    float prev_r = 0.0f, step_len = 0.0f, omega = p.relax;
    for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
      const float d = scene(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
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
      const float d = scene(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
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
// 1049): k in {(+,-,-), (-,-,+), (-,+,-), (+,+,+)}, summed in that order,
// in a loop that is not unrolled: one copy of the scene function instead of
// four (nvcc's time and the instruction cache), the same operations in the
// same order (a tap's sign times e or d is exact).
template <class Scene>
__device__ __forceinline__ void tet_normal(const Scene& scene, float e,
                                           float px, float py, float pz,
                                           float& nx, float& ny, float& nz) {
  nx = 0.0f;
  ny = 0.0f;
  nz = 0.0f;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const float sx = (k == 0 || k == 3) ? 1.0f : -1.0f;
    const float sy = k >= 2 ? 1.0f : -1.0f;
    const float sz = (k == 1 || k == 3) ? 1.0f : -1.0f;
    const float d = scene(px + sx * e, py + sy * e, pz + sz * e);
    nx = nx + sx * d;
    ny = ny + sy * d;
    nz = nz + sz * d;
  }
}

// Lambert's diffuse term of the surface point p with normal n against the
// point light, floored at the ambient term; with MATS, alb takes the
// albedo the tape's colour walk carries to p (scene.color: gated by the
// tile's leaf mask under culling, as the reference's colour pass is).
template <bool MATS, class Scene>
__device__ __forceinline__ float lambert(const Scene& scene,
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
  if constexpr (MATS) scene.color(px, py, pz, p.albedo, alb);
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
// bcols] at t0_in; 3 none: the soft build; 4 the interval planes of more
// than MAX_NI intervals, read in place (intervals_wide.cu). MO is the
// march-only build
// (pallas_prepass.py:1621-1640, launched at 1827): it writes t_out and
// hit_out, flat in pixel-major AA-ray order, and skips the taps, the
// shading and the image. STK is the value stack's route (scene_eval.cuh:
// REG_STACK, a register, or STK_SMEM, the dynamic shared memory of
// FineLaunch::stack_bytes); the scene is read from its packed words.
template <int MODE, bool RELAX, bool MATS, int PRE, bool MO, int STK>
__global__ void fine_kernel(SceneWords sw, const float* __restrict__ cam,
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
    const WordScene<MODE, STK> scene{sw, cv, tile};
    float t, hit = 0.0f;
    float s_min = 0.0f, t_min = 0.0f;
    if constexpr (PRE == 3) {
      hit = soft_march(scene, r, bound, p, sp.infl, t, s_min, t_min);
    } else {
      float live;
      if constexpr (PRE == 2 || PRE == 4) {
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
      if constexpr (PRE == 2 || PRE == 4) {
        // The block's intervals, FAR_T past the last: in registers, or
        // (more than MAX_NI) read in place.
        const size_t po = (size_t)(i / bp.block) * bp.bcols + j / bp.block;
        const size_t plane = (size_t)bp.brows * bp.bcols;
        std::conditional_t<PRE == 2, ShiftIntervals, PlaneIntervals> planes;
        planes.load(t0_in, plane, po, bp.ni);
        hit = interval_march<RELAX>(scene, r, p, live, t, t_cap, planes);
      } else {
        hit = legacy_march<RELAX>(scene, r, p, live, t, t_cap);
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
      tet_normal(scene, p.eps, px, py, pz, nx, ny, nz);
      diff = lambert<MATS>(scene, p, px, py, pz, nx, ny, nz, alb);
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

struct FineLaunch;
// Launches the PRE 4 build (more than MAX_NI intervals) of fine_kernel
// <MODE, RELAX, MATS, 4, MO, STK>: defined and instantiated in
// intervals_wide.cu.
template <int MODE, bool RELAX, bool MATS, bool MO, int STK>
void fine_wide(const FineLaunch& L);

// Whether a build reads the value stack: every one but the compact item
// lists' without materials (MODE 1 folds its lists; the colour walk of a
// painted scene reads the gated tape).
__host__ __device__ constexpr bool uses_stack(int mode, bool mats) {
  return mode != 1 || mats;
}

// The fine kernel's launch, dispatched to its build by template flags: the
// prepass planes `kind` (0 pixel or none, 1 block, 2 at most MAX_NI
// intervals, 3 more), and the stack route stk (STK).
struct FineLaunch {
  dim3 grid, block;
  cudaStream_t st;
  SceneWords sw;
  int stk;
  const float *cam, *bound;
  RenderParams p;
  CullView cv;
  const float *t0_in, *status_in;
  float *img, *t_out, *hit_out;
  BlockParams bp;
  SoftParams sp;

  template <int MODE, bool RELAX, bool MATS, int PRE, bool MO, int STK>
  void launch() const {
    const auto k = fine_kernel<MODE, RELAX, MATS, PRE, MO, STK>;
    const size_t smem = stack_smem_bytes<MATS, STK>(sw, block.x);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    k<<<grid, block, smem, st>>>(sw, cam, bound, p, cv, t0_in, status_in, img,
                                 t_out, hit_out, bp, sp);
  }
  template <int MODE, bool RELAX, bool MATS, int PRE, bool MO, int STK>
  void run() const {
    if constexpr (PRE == 4) fine_wide<MODE, RELAX, MATS, MO, STK>(*this);
    else launch<MODE, RELAX, MATS, PRE, MO, STK>();
  }
  template <int MODE, bool RELAX, bool MATS, int PRE, bool MO = false>
  void go() const {
    if constexpr (!uses_stack(MODE, MATS)) {
      run<MODE, RELAX, MATS, PRE, MO, REG_STACK>();
    } else if (stk == REG_STACK) {
      run<MODE, RELAX, MATS, PRE, MO, REG_STACK>();
    } else {
      run<MODE, RELAX, MATS, PRE, MO, STK_SMEM>();
    }
  }
  template <int MODE, bool RELAX, bool MATS, bool MO = false>
  void pre(int kind) const {
    if (kind == 3) go<MODE, RELAX, MATS, 4, MO>();
    else if (kind == 2) go<MODE, RELAX, MATS, 2, MO>();
    else if (kind == 1) go<MODE, RELAX, MATS, 1, MO>();
    else go<MODE, RELAX, MATS, 0, MO>();
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
  template <int MODE>
  void march_flags(bool relax, int kind) const {
    if (relax) pre<MODE, true, false, true>(kind);
    else pre<MODE, false, false, true>(kind);
  }
};

// The kernels' MODE for cull->mode `mode` on a static (dyn false) or dynamic
// tape: a dynamic tape takes MODE 3 (un-culled) or 4 (gated); -1 where no
// build exists (a dynamic tape has no item lists).
inline int build_mode(int mode, bool dyn) {
  if (!dyn) return mode >= 0 && mode <= 2 ? mode : -1;
  return mode == 0 ? 3 : (mode == 2 ? 4 : -1);
}

// Launches the soft build (PRE 3) of MODE `mode` (fine_soft.cu).
cudaError_t launch_fine_soft(const FineLaunch& L, int mode, bool mats);

// Launches the hard build of MODE for relax, mats and the prepass planes
// `kind` (fine_kernel<MODE, RELAX, MATS, PRE, false, STK>), or (march_only)
// its march-only build. Each MODE's builds are instantiated in one source
// (the extern templates below), so that nvcc compiles the groups in
// parallel: hard MODE 0 in prepass.cu, 1 and 2 in fine_culled.cu, 3 in
// prepass_dyn.cu, 4 in fine_dyn_gated.cu; march-only MODE 0-2 in
// fine_march.cu, 3 and 4 in fine_march_dyn.cu.
template <int MODE>
cudaError_t launch_fine_hard(const FineLaunch& L, bool relax, bool mats,
                             int kind) {
  L.flags<MODE>(relax, mats, kind);
  return cudaGetLastError();
}
template <int MODE>
cudaError_t launch_fine_march(const FineLaunch& L, bool relax, int kind) {
  L.march_flags<MODE>(relax, kind);
  return cudaGetLastError();
}
#define RMT_FINE_MODE(M)                                                    \
  extern template cudaError_t launch_fine_hard<M>(const FineLaunch&, bool, \
                                                  bool, int);              \
  extern template cudaError_t launch_fine_march<M>(const FineLaunch&, bool, \
                                                   int);
RMT_FINE_MODE(0)
RMT_FINE_MODE(1)
RMT_FINE_MODE(2)
RMT_FINE_MODE(3)
RMT_FINE_MODE(4)
#undef RMT_FINE_MODE

}  // namespace rmt
