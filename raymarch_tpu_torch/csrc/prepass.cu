// Cone-prepass forward render: the coarse (cone) kernel, the chained pixel
// cone kernel and the fine (march + shade + AA mean) kernel, with a plain C
// interface for ctypes.
//
// coarse_kernel replaces raymarch_tpu/ops/pallas_prepass.py:
// make_pallas_image_render_aa.coarse_kernel (885): one cone ray per pixel
// centre (KIND 0: B = 1, no intervals) or per B x B block (KIND 1, its centre
// at pixel coordinate (b + 0.5) * B), stopped at d < min_dist + omega*t,
// stepped by (d - omega*t)/(1+omega), clipped by the scene's bounding sphere
// (_cone_march_tile 130, _bound_clip 107); or (KIND 2) the centre ray's scan
// of the whole scene that records up to ni near intervals per block
// (_cone_interval_march_tile 191).
//
// coarse_px_kernel replaces coarse_px_kernel (969): with prepass_chain and
// B > 1, one cone ray per pixel at the pixel cone angle, from its block's
// stop distance (_cone_march_tile with t_in/live_in, 152-154), through the
// whole tape: un-culled, as the reference's.
//
// fine_kernel replaces fine_packed_kernel (1521) in its hard forward form
// (no soft mode, no march_only): every AA ray sphere-
// traces from its pixel's t0 (_fine_march_tile 477, plain or, with
// relax > 1, over-relaxed), or (PRE 2) through its block's near intervals,
// jumping the gaps (_fine_march_interval_tile 296); hit rays
// take 4-tap tetrahedron normals (pallas_march._tet_taps 1049), Lambert
// shading, the analytic checker floor on a miss, sqrt gamma, and the AA mean.
// Block planes (PRE 1 and 2) are read at block (i / B, j / B): the
// reference's repeat of the planes to pixel resolution (1397-1406) as an
// index map.
//
// With leaf culling (cfg.leaf_cull) both kernels evaluate the scene of a
// point through its pixel's tile (scene_distance_tile): the compact plan's
// item lists of the tile (O(active leaves) per point) or, for a scene
// without a residual-free plan, the gated tape with the tile's leaf mask.
// Each kernel has its own tile grid; every ray (and tap) is evaluated with
// the list of the tile whose cone holds it.
// Given residual pointers it also writes each AA ray's march end t and hit
// flag (emit_th=True, 1850-1862), which the fused backward replays; the
// image does not depend on whether they are written. A painted scene
// (spec.has_materials) takes each hit ray's albedo from one more walk of
// the static tape at its hit point (scene_color, pallas_prepass.py:
// 1669-1681), gated by its tile's leaf mask under culling in either mode,
// as the reference's colour pass is; a material-free build carries none of
// it (the MATS template flag).
//
// What bounds them on an H100: neither reads or writes much memory (the
// fine kernel writes 12 bytes per pixel, the coarse kernel 8), so both are
// bound by f32 instruction issue in the scene interpreter and by warp
// divergence: a warp runs until its slowest ray exits. The Pallas kernels
// blocked that exit check over 128x128-ray tiles; here the unit is a warp
// of 32 rays, and the fine kernel puts a pixel's S AA samples in S adjacent
// lanes so a warp holds 32/S neighbouring pixels whose rays end together.
// Per ray the results do not depend on the tiling: the Pallas loops mask
// every step with `k < max_iter` (the interval scan runs 2 * max_iter
// steps unblocked), so a per-thread loop that stops when its ray stops
// gives the same (t, hit, status) and the same intervals. The AA mean is reduced in
// registers with warp shuffles (S = 64, aa_samples = 8: one shuffle tree
// per warp, then the two warps' sums through shared memory); nothing
// per-sample reaches device memory.
//
// Rounding notes: 1.0f / sqrtf(x) stands in for jax.lax.rsqrt (the
// correctly-rounded quotient of a correctly-rounded root, closer to the
// reference's f32 result than the approximate rsqrtf). The checker floor
// rounds half to even with rintf, as jnp.round does. nvcc's default FMA
// contraction is left on. "No interval" is the reference's finite 3.0e38,
// tested with < 9.0e37, never INFINITY.
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
constexpr int COARSE_THREADS = 128;
// A multiple of 64: a pixel's 64 samples (aa_samples = 8) share a block.
constexpr int FINE_THREADS = 128;
constexpr float FAR_TEST = 9.0e37f;

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

    const int tile = MODE != 0 ? tile_of(cv, i, j) : 0;
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
    const int tile = MODE != 0 ? tile_of(cv, i, j) : 0;
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

// One thread per pixel of the band (prepass_chain, B > 1): the pixel's cone
// ray at omega_px over the whole tape, started at max(its bound-clip start,
// its block's t0) and dead where its block's status is 0
// (_cone_march_tile 152-154). Writes t0 and status f32[rows, width].
__global__ void coarse_px_kernel(SceneView sc, const float* __restrict__ cam,
                                 const float* __restrict__ bound,
                                 RenderParams p,
                                 const float* __restrict__ t_blk,
                                 const float* __restrict__ status_blk,
                                 float* __restrict__ t0_out,
                                 float* __restrict__ status_out,
                                 BlockParams bp) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
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
  const float near =
      cone_march<0>(sc, uncull, 0, r, p, bp.omega_px, bp.inv1w_px, live, t, t_cap);
  const size_t o = (size_t)i * p.width + j;
  t0_out[o] = t;
  status_out[o] = near;
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

// One thread per AA ray. Lane q of a row is (pixel j, sample s) with
// q = j * S + s, so a pixel's S samples sit in S adjacent lanes of one warp
// (S divides 32, or is 64 and fills two warps; the wrapper checks). Writes the image f32[rows, width, 3]
// and, when t_out is not null, the residuals t and hit f32[rows, width, S].
// MODE is the culling mode, RELAX whether cfg.relax > 1, MATS whether the
// scene carries materials, PRE the prepass planes: 0 t0_in and status_in
// f32[rows, width] (or none with no_prepass), 1 the same at block
// resolution f32[brows, bcols], 2 the 2*ni interval planes f32[2*ni, brows,
// bcols] at t0_in.
template <int MODE, bool RELAX, bool MATS, int PRE>
__global__ void fine_kernel(SceneView sc, const float* __restrict__ cam,
                            const float* __restrict__ bound, RenderParams p,
                            CullView cv, const float* __restrict__ t0_in,
                            const float* __restrict__ status_in,
                            float* __restrict__ img,
                            float* __restrict__ t_out,
                            float* __restrict__ hit_out, BlockParams bp) {
  const int S = p.naa * p.naa;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int j = q / S;
  const int s = q - j * S;
  // Threads past the row's end still run the shuffles below, with zeros.
  const bool valid = j < p.width && i < p.rows;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (valid) {
    const int a = s / p.naa;
    const int b = s - a * p.naa;
    const float fa = ((float)a + 0.5f) / (float)p.naa - 0.5f;
    const float fb = ((float)b + 0.5f) / (float)p.naa - 0.5f;
    // Screen coordinates, f32 op order of pallas_prepass.py:1553-1562.
    const float x =
        2.0f * ((float)j + 0.5f) / (float)p.width - 1.0f + fa * p.c2w;
    const float y =
        1.0f - 2.0f * ((float)i + 0.5f + __ldg(cam + 7)) / (float)p.height +
        fb * p.c2h;
    const Ray r = view_ray(cam, p, x, y);
    const size_t o = (size_t)i * p.width + j;

    float t, live;
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
      t = t0_in[o];
      live = status_in[o];
    }
    float t_cap = 3.0e38f;
    if (p.use_bound) {
      // Only the exit cap matters: the start comes from the prepass.
      float l = live, t_unused = t;
      bound_clip(bound, r, p.min_dist, l, t_unused, t_cap);
    }
    const int tile = MODE != 0 ? tile_of(cv, i, j) : 0;
    float hit = 0.0f;
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
    } else if constexpr (RELAX) {
      // Over-relaxed stepping (_fine_march_tile 491-525): step omega*d;
      // when consecutive safe spheres stop overlapping the step overshot,
      // so step back by (1 - relax)*step and drop the ray to omega = 1. Hit
      // and escape are tested only at samples that did not overshoot.
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
    if (t_out != nullptr) {
      const size_t ri = ((size_t)i * p.width + j) * S + s;
      t_out[ri] = t;
      hit_out[ri] = hit;
    }

    // A miss takes diff = 0 and the default albedo (shade_miss, 1683-1694).
    float diff = 0.0f;
    float alb[3] = {p.albedo[0], p.albedo[1], p.albedo[2]};
    if (hit > 0.0f) {
      const float px = r.ox + r.dx * t;
      const float py = r.oy + r.dy * t;
      const float pz = r.oz + r.dz * t;
      // Tetrahedron taps: k in {(+,-,-), (-,-,+), (-,+,-), (+,+,+)}.
      const float e = p.eps;
      const float d0 = scene_distance_tile<MODE>(sc, cv, tile, px + e, py - e, pz - e);
      const float d1 = scene_distance_tile<MODE>(sc, cv, tile, px - e, py - e, pz + e);
      const float d2 = scene_distance_tile<MODE>(sc, cv, tile, px - e, py + e, pz - e);
      const float d3 = scene_distance_tile<MODE>(sc, cv, tile, px + e, py + e, pz + e);
      float nx = 0.0f, ny = 0.0f, nz = 0.0f;
      nx = nx + d0; ny = ny - d0; nz = nz - d0;
      nx = nx - d1; ny = ny - d1; nz = nz + d1;
      nx = nx - d2; ny = ny + d2; nz = nz - d2;
      nx = nx + d3; ny = ny + d3; nz = nz + d3;
      const float ninv = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz + 1e-20f);
      const float tlx = px - p.light[0];
      const float tly = py - p.light[1];
      const float tlz = pz - p.light[2];
      const float linv =
          1.0f / sqrtf(tlx * tlx + tly * tly + tlz * tlz + 1e-20f);
      diff = (nx * tlx + ny * tly + nz * tlz) * (ninv * linv);
      diff = fmaxf(diff, p.ambient);
      if constexpr (MATS) {
        scene_color(sc, px, py, pz, p.albedo, alb,
                    MODE != 0 ? cv.masks + (size_t)tile * cv.n_words
                              : nullptr);
      }
    }

    // Analytic checkerboard floor on a miss (wgsl:117-128).
    const bool dy_ok = fabsf(r.dy) > 1e-8f;
    const float dy_safe = dy_ok ? r.dy : 1e-8f;
    const float ft = (p.floor_y - r.oy) / dy_safe;
    const float fx = fminf(fmaxf(r.ox + r.dx * ft, -1e7f), 1e7f);
    const float fz = fminf(fmaxf(r.oz + r.dz * ft, -1e7f), 1e7f);
    const int ipx = (int)rintf(fx + 0.5f);
    const int ipz = (int)rintf(fz + 0.5f);
    const float parity = (float)((ipx ^ ipz) & 1);
    const float on_floor = (ft > 0.0f && dy_ok) ? 1.0f : 0.0f;
    const float miss = 1.0f - hit;
    const float fr = (p.floor_base[0] + p.floor_checker * parity) * on_floor;
    const float fg = (p.floor_base[1] + p.floor_checker * parity) * on_floor;
    const float fbl = (p.floor_base[2] + p.floor_checker * parity) * on_floor;
    cr = sqrtf(fmaxf(hit * (alb[0] * diff) + miss * fr, 0.0f) + 1e-12f);
    cg = sqrtf(fmaxf(hit * (alb[1] * diff) + miss * fg, 0.0f) + 1e-12f);
    cb = sqrtf(fmaxf(hit * (alb[2] * diff) + miss * fbl, 0.0f) + 1e-12f);
  }

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

  template <int MODE, bool RELAX, bool MATS, int PRE>
  void go() const {
    fine_kernel<MODE, RELAX, MATS, PRE><<<grid, block, 0, st>>>(
        sc, cam, bound, p, cv, t0_in, status_in, img, t_out, hit_out, bp);
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
};

}  // namespace rmt

extern "C" {

// The launchers return the cudaError_t of the launch (0 = success). t_out
// and hit_out may be null (no residuals); cull->mode 0 renders unculled;
// mats != 0 shades with the scene's materials. With block->ni > 0 the
// coarse pass writes, and the fine pass reads, the 2*ni interval planes at
// t0 (status null).
int rmt_coarse_launch(const float* leaf_params, const int* row_kind,
                      const int* tape, int n_instr, const float* op_param,
                      const float* cam, const float* bound,
                      const rmt::RenderParams* params,
                      const rmt::CullView* cull, float* t0_out,
                      float* status_out, const rmt::BlockParams* block_params,
                      void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::BlockParams bp = *block_params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  if (bp.ni > rmt::MAX_NI) return (int)cudaErrorInvalidValue;
  const int kind = bp.ni > 0 ? 2 : (bp.block > 1 ? 1 : 0);
  const int cols = kind == 0 ? p.width : bp.bcols;
  const dim3 block(rmt::COARSE_THREADS);
  const dim3 grid((cols + rmt::COARSE_THREADS - 1) / rmt::COARSE_THREADS,
                  kind == 0 ? p.rows : bp.brows);
  cudaStream_t st = (cudaStream_t)stream;
#define RMT_COARSE(MODE, KIND)                                           \
  rmt::coarse_kernel<MODE, KIND><<<grid, block, 0, st>>>(sc, cam, bound, p, \
                                                         *cull, t0_out,    \
                                                         status_out, bp)
  switch (cull->mode * 3 + kind) {
    case 0: RMT_COARSE(0, 0); break;
    case 1: RMT_COARSE(0, 1); break;
    case 2: RMT_COARSE(0, 2); break;
    case 3: RMT_COARSE(1, 0); break;
    case 4: RMT_COARSE(1, 1); break;
    case 5: RMT_COARSE(1, 2); break;
    case 6: RMT_COARSE(2, 0); break;
    case 7: RMT_COARSE(2, 1); break;
    case 8: RMT_COARSE(2, 2); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RMT_COARSE
  return (int)cudaGetLastError();
}

int rmt_coarse_px_launch(const float* leaf_params, const int* row_kind,
                         const int* tape, int n_instr, const float* op_param,
                         const float* cam, const float* bound,
                         const rmt::RenderParams* params, const float* t_blk,
                         const float* status_blk, float* t0_out,
                         float* status_out,
                         const rmt::BlockParams* block_params, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::BlockParams bp = *block_params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  const dim3 block(rmt::COARSE_THREADS);
  const dim3 grid((p.width + rmt::COARSE_THREADS - 1) / rmt::COARSE_THREADS,
                  p.rows);
  rmt::coarse_px_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      sc, cam, bound, p, t_blk, status_blk, t0_out, status_out, bp);
  return (int)cudaGetLastError();
}

int rmt_fine_launch(const float* leaf_params, const int* row_kind,
                    const int* tape, int n_instr, const float* op_param,
                    const float* cam, const float* bound,
                    const rmt::RenderParams* params,
                    const rmt::CullView* cull, const float* t0_in,
                    const float* status_in, float* img, float* t_out,
                    float* hit_out, int mats,
                    const rmt::BlockParams* block_params, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::BlockParams bp = *block_params;
  if (bp.ni > rmt::MAX_NI) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)p.width * p.naa * p.naa;
  rmt::FineLaunch L;
  L.grid = dim3((unsigned)((lanes + rmt::FINE_THREADS - 1) / rmt::FINE_THREADS),
                p.rows);
  L.block = dim3(rmt::FINE_THREADS);
  L.st = (cudaStream_t)stream;
  L.sc = rmt::make_scene(leaf_params, row_kind, tape, n_instr, op_param,
                         p.max_dist);
  L.cam = cam;
  L.bound = bound;
  L.p = p;
  L.cv = *cull;
  L.t0_in = t0_in;
  L.status_in = status_in;
  L.img = img;
  L.t_out = t_out;
  L.hit_out = hit_out;
  L.bp = bp;
  const int kind = p.no_prepass ? 0
                   : bp.ni > 0   ? 2
                   : (bp.block > 1 && !bp.chain) ? 1
                                                : 0;
  const bool relax = p.relax > 1.0f;
  switch (cull->mode) {
    case 0: L.flags<0>(relax, mats != 0, kind); break;
    case 1: L.flags<1>(relax, mats != 0, kind); break;
    case 2: L.flags<2>(relax, mats != 0, kind); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
