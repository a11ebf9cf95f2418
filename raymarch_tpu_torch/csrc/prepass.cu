// Cone-prepass forward render: the coarse (cone) kernel and the fine
// (march + shade + AA mean) kernel, with a plain C interface for ctypes.
//
// coarse_kernel replaces raymarch_tpu/ops/pallas_prepass.py:
// make_pallas_image_render_aa.coarse_kernel (885) with prepass_block=1 and no
// intervals: one cone ray per pixel centre, stopped at
// d < min_dist + omega*t, stepped by (d - omega*t)/(1+omega), clipped by the
// scene's bounding sphere (_cone_march_tile 130, _bound_clip 107).
//
// fine_kernel replaces fine_packed_kernel (1521) in its hard forward form
// (no soft mode, no march_only): every AA ray sphere-
// traces from its pixel's t0 (_fine_march_tile 477, plain or, with
// relax > 1, over-relaxed), hit rays
// take 4-tap tetrahedron normals (pallas_march._tet_taps 1049), Lambert
// shading, the analytic checker floor on a miss, sqrt gamma, and the AA mean.
//
// With leaf culling (cfg.leaf_cull) both kernels evaluate the scene of a
// point through its pixel's tile (scene_distance_tile): the compact plan's
// item lists of the tile (O(active leaves) per point) or, for a scene
// without a residual-free plan, the gated tape with the tile's leaf mask.
// Each kernel has its own tile grid; every ray (and tap) is evaluated with
// the list of the tile whose cone holds it.
// Given residual pointers it also writes each AA ray's march end t and hit
// flag (emit_th=True, 1850-1862), which the fused backward replays; the
// image does not depend on whether they are written.
//
// What bounds them on an H100: neither reads or writes much memory (the
// fine kernel writes 12 bytes per pixel, the coarse kernel 8), so both are
// bound by f32 instruction issue in the scene interpreter and by warp
// divergence: a warp runs until its slowest ray exits. The Pallas kernels
// blocked that exit check over 128x128-ray tiles; here the unit is a warp
// of 32 rays, and the fine kernel puts a pixel's S AA samples in S adjacent
// lanes so a warp holds 32/S neighbouring pixels whose rays end together.
// Per ray the results do not depend on the tiling: the Pallas loops mask
// every step with `k < max_iter`, so a per-thread loop that stops when its
// ray stops gives the same (t, hit, status). The AA mean is reduced in
// registers with warp shuffles; nothing per-sample reaches device memory.
//
// Rounding notes: 1.0f / sqrtf(x) stands in for jax.lax.rsqrt (the
// correctly-rounded quotient of a correctly-rounded root, closer to the
// reference's f32 result than the approximate rsqrtf). The checker floor
// rounds half to even with rintf, as jnp.round does. nvcc's default FMA
// contraction is left on.
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

// One thread per pixel of the band: writes t0 and status, f32[rows, width].
// MODE is the culling mode (CullView::mode).
template <int MODE>
__global__ void coarse_kernel(SceneView sc, const float* __restrict__ cam,
                              const float* __restrict__ bound, RenderParams p,
                              CullView cv, float* __restrict__ t0_out,
                              float* __restrict__ status_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
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
}

// One thread per AA ray. Lane q of a row is (pixel j, sample s) with
// q = j * S + s, so a pixel's S samples sit in S adjacent lanes of one warp
// (S divides 32; the wrapper checks). Writes the image f32[rows, width, 3]
// and, when t_out is not null, the residuals t and hit f32[rows, width, S].
// MODE is the culling mode, RELAX whether cfg.relax > 1.
template <int MODE, bool RELAX>
__global__ void fine_kernel(SceneView sc, const float* __restrict__ cam,
                            const float* __restrict__ bound, RenderParams p,
                            CullView cv, const float* __restrict__ t0_in,
                            const float* __restrict__ status_in,
                            float* __restrict__ img,
                            float* __restrict__ t_out,
                            float* __restrict__ hit_out) {
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
    if (p.no_prepass) {
      t = 0.0f;
      live = 1.0f;
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
    if constexpr (RELAX) {
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
    cr = sqrtf(fmaxf(hit * (p.albedo[0] * diff) + miss * fr, 0.0f) + 1e-12f);
    cg = sqrtf(fmaxf(hit * (p.albedo[1] * diff) + miss * fg, 0.0f) + 1e-12f);
    cb = sqrtf(fmaxf(hit * (p.albedo[2] * diff) + miss * fbl, 0.0f) + 1e-12f);
  }

  // AA mean over the pixel's S adjacent lanes, in registers.
  for (int off = S >> 1; off > 0; off >>= 1) {
    cr += __shfl_xor_sync(0xffffffffu, cr, off);
    cg += __shfl_xor_sync(0xffffffffu, cg, off);
    cb += __shfl_xor_sync(0xffffffffu, cb, off);
  }
  if (valid && s == 0) {
    float* out = img + ((size_t)i * p.width + j) * 3;
    out[0] = cr * p.inv_s;
    out[1] = cg * p.inv_s;
    out[2] = cb * p.inv_s;
  }
}

constexpr int COARSE_THREADS = 128;
constexpr int FINE_THREADS = 128;

}  // namespace rmt

extern "C" {

// Both launchers return the cudaError_t of the launch (0 = success). t_out
// and hit_out may be null (no residuals); cull->mode 0 renders unculled.
int rmt_coarse_launch(const float* leaf_params, const int* row_kind,
                      const int* tape, int n_instr, const float* op_param,
                      const float* cam, const float* bound,
                      const rmt::RenderParams* params,
                      const rmt::CullView* cull, float* t0_out,
                      float* status_out, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  const dim3 block(rmt::COARSE_THREADS);
  const dim3 grid((p.width + rmt::COARSE_THREADS - 1) / rmt::COARSE_THREADS,
                  p.rows);
  cudaStream_t st = (cudaStream_t)stream;
  switch (cull->mode) {
    case 0:
      rmt::coarse_kernel<0><<<grid, block, 0, st>>>(sc, cam, bound, p, *cull,
                                                    t0_out, status_out);
      break;
    case 1:
      rmt::coarse_kernel<1><<<grid, block, 0, st>>>(sc, cam, bound, p, *cull,
                                                    t0_out, status_out);
      break;
    case 2:
      rmt::coarse_kernel<2><<<grid, block, 0, st>>>(sc, cam, bound, p, *cull,
                                                    t0_out, status_out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int rmt_fine_launch(const float* leaf_params, const int* row_kind,
                    const int* tape, int n_instr, const float* op_param,
                    const float* cam, const float* bound,
                    const rmt::RenderParams* params,
                    const rmt::CullView* cull, const float* t0_in,
                    const float* status_in, float* img, float* t_out,
                    float* hit_out, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  const long long lanes = (long long)p.width * p.naa * p.naa;
  const dim3 block(rmt::FINE_THREADS);
  const dim3 grid((unsigned)((lanes + rmt::FINE_THREADS - 1) / rmt::FINE_THREADS),
                  p.rows);
  cudaStream_t st = (cudaStream_t)stream;
  const bool relax = p.relax > 1.0f;
#define RMT_FINE(MODE, RELAX)                                              \
  rmt::fine_kernel<MODE, RELAX><<<grid, block, 0, st>>>(                   \
      sc, cam, bound, p, *cull, t0_in, status_in, img, t_out, hit_out)
  switch (cull->mode * 2 + (relax ? 1 : 0)) {
    case 0: RMT_FINE(0, false); break;
    case 1: RMT_FINE(0, true); break;
    case 2: RMT_FINE(1, false); break;
    case 3: RMT_FINE(1, true); break;
    case 4: RMT_FINE(2, false); break;
    case 5: RMT_FINE(2, true); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RMT_FINE
  return (int)cudaGetLastError();
}

}  // extern "C"
