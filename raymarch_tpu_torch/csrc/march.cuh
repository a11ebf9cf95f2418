// The flat-layout march kernels, one thread per ray, served by one kernel
// template over the packed scene words (scene_eval.cuh SceneWords), with a
// plain C interface for ctypes (march.cu).
//
// Replaces three kernels of raymarch_tpu/ops/pallas_march.py:
// - K5 make_pallas_ray_march.kernel (1297, launched at 1348): explicit rays
//   origins, dirs f32[N, 3] -> t, hit f32[N], steps i32[N] (SRC 0, OUT 0);
// - K6 make_pallas_image_march.kernel (1390, launched at 1475): the rays of
//   every AA sample of a width x height image generated in the kernel from
//   cam f32[8] -> the same three outputs over N = aa^2 * H * W (SRC 1,
//   OUT 0);
// - K7 make_pallas_image_render.kernel (1566, launched at 1691): raygen,
//   march, 4-tap tetrahedron normals, Lambert against the fixed light,
//   per-hit albedo on painted scenes (MATS), the checker floor on a miss
//   and sqrt gamma -> r, g, b f32[N] per AA sample (SRC 1, OUT 1), or the
//   mean of each pixel's S = aa^2 gamma-corrected samples, the image
//   f32[H, W, 3] that make_renderer(backend="pallas_full") returns (SRC 1,
//   OUT 2; the reference takes that mean outside its kernel,
//   raymarch_tpu/ops/march.py:488-507).
// Ray r of an image is r = (i * W + j) * S + s, pixel-major with the
// sample fastest (raymarch_tpu/ops/raygen.py), so a warp holds a few
// neighbouring pixels' samples, whose rays end together. N is any count:
// there is no padding to the reference's 16,384-ray tiles.
//
// The march is exact sphere tracing (_march_tile, 1088-1214), from t = 0
// on every ray: with bound_accel a valid scene bounding sphere gives a miss
// test (a ray that misses it, or leaves it behind the origin, takes no
// step) and the exit cap t_cap = t_exit + min_dist, and no start. The
// reference's kernels start at the sphere's entry, max(t_enter, 0)
// (1117-1131), where a grazing ray samples other points and can stop on
// another surface; from t = 0 hit and t are those without the bound, as
// raymarch_tpu/config.py promises, and only steps drop. A ray escapes on
// d > max_dist or t > t_cap, and a hit wins on the boundary; steps counts
// the iterations in which the ray was live, at most max_iter. RELAX
// (cfg.relax > 1) takes the over-relaxed steps and their fallback
// (1133-1176), from t = 0 as well: an overshot step is stepped back by
// (1 - relax) * step (a negative step) and counts as a step; hit and escape
// are tested only at samples that did not overshoot. The reference blocks
// its exit test over a tile and K steps, but masked lanes are no-ops, so a
// loop per ray that stops when its ray stops gives the same t, hit and
// steps on every ray. K7's surface point is o + d * t * hit (1620-1622): a
// miss shades at the origin and its surface term enters multiplied by 0, so
// the kernel skips a miss's taps, exactly.
//
// The scene function is K1/K2's (scene_eval.cuh WordScene, un-culled:
// MODE 0, or 3 on a dynamic tape): one 16-byte word an instruction, float4
// leaf rows, the
// value stack's top in a register and the slots below it on route STK
// (REG_STACK, a register, for a stack depth <= 2; STK_SMEM, a column of
// the block's dynamic shared memory, deeper: cuda_march.stack_route). DYN
// reads a dynamic tape (compile_scene(static=False)), packed per frame: the
// top starts at max_dist and a NOP is skipped. The reference's macro
// streams (tape.py:macroize_streams) are a TPU layout the port does not
// use.
//
// Rounding: the sources of these builds compile with -fmad=false
// (_build.py), so every product and sum rounds on its own, as in the plain
// torch versions (ops/cuda_march.py:ray_march_plain, image_march_plain,
// image_render_plain, image_pixels_plain): t, hit and steps then agree with
// them on every ray, where one contracted FMA moves a grazing ray's march by
// a step.
//
// What bounds them on an H100: K5 reads 24 bytes and K5/K6 write 12 bytes
// per ray (398 MB at 1080p / 16 AA for K6), K7 12 bytes a ray or, the pixel
// build, 12 a pixel, against the f32 operations of the march: operations,
// and warp divergence (a warp runs until its slowest ray ends). Everything
// per ray stays in registers, the words and leaf rows are read through the
// read-only cache, uniformly across a warp. A launch of K5 over a 2^20-ray
// chunk (make_renderer(chunk=1 << 20)) takes 0.050 ms of device time on
// config 2 against the 0.032 ms a chunk of one 33 M-ray launch: its last
// rays (up to 63 steps) run step after step on an emptying card. Persistent
// warps that refill finished lanes from runs of consecutive rays did not
// shorten that tail and cost 1.35-1.6x on the 33 M-ray launch (PERF.md
// §6).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "fine.cuh"
#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

// Threads a block of the per-ray builds; the pixel build's blocks hold
// whole pixels (pixel_threads).
constexpr int MARCH_THREADS = 128;
// The most threads a block of the pixel build takes: a pixel of S = aa^2
// samples fills one block when S > MARCH_THREADS, so aa <= 32.
constexpr int PIXEL_MAX_THREADS = 1024;

// Threads a block of the pixel build for S samples a pixel:
// floor(MARCH_THREADS / S) whole pixels, one when S > MARCH_THREADS.
__host__ __device__ constexpr int pixel_threads(int S) {
  return S >= MARCH_THREADS ? S : (MARCH_THREADS / S) * S;
}

// Sphere tracing of one ray from the camera or its origin -> hit; t ends
// where the ray does, steps counts its live iterations.
template <bool RELAX, class Scene>
__device__ __forceinline__ float march_ray(const Scene& scene, const Ray& r,
                                           const float* __restrict__ bound,
                                           const RenderParams& p, float& t,
                                           int& steps) {
  float live = 1.0f, t_cap = FAR_T, hit = 0.0f;
  t = 0.0f;
  steps = 0;
  if (p.use_bound) {
    // Only the miss test and the exit cap: every live ray starts at t = 0,
    // so the bound changes no sample a ray takes before it hits.
    float t_unused = 0.0f;
    bound_clip(bound, r, p.min_dist, live, t_unused, t_cap);
  }
  if constexpr (RELAX) {
    float prev_r = 0.0f, step_len = 0.0f, omega = p.relax;
    for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
      const float d = scene(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);
      ++steps;
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
      ++steps;
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

// The gamma-corrected colour of one marched AA ray (pallas_march.py:
// 1617-1667): the surface point o + d * t * hit, the 4-tap normal, Lambert
// against the fixed light floored at the ambient term, the albedo the tape
// carries to the hit point (MATS), the floor on a miss, sqrt gamma.
template <bool MATS, class Scene>
__device__ __forceinline__ void shade_ray(const Scene& scene, const Ray& r,
                                          float t, float hit,
                                          const RenderParams& p, float& cr,
                                          float& cg, float& cb) {
  const float px = r.ox + r.dx * t * hit;
  const float py = r.oy + r.dy * t * hit;
  const float pz = r.oz + r.dz * t * hit;
  float diff = 0.0f;
  float alb[3] = {p.albedo[0], p.albedo[1], p.albedo[2]};
  if (hit > 0.0f) {
    float nx, ny, nz;
    tet_normal(scene, p.eps, px, py, pz, nx, ny, nz);
    const float ninv = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz + 1e-20f);
    nx = nx * ninv;
    ny = ny * ninv;
    nz = nz * ninv;
    const float tlx = px - p.light[0];
    const float tly = py - p.light[1];
    const float tlz = pz - p.light[2];
    const float linv = 1.0f / sqrtf(tlx * tlx + tly * tly + tlz * tlz + 1e-20f);
    diff = nx * tlx * linv + ny * tly * linv + nz * tlz * linv;
    diff = fmaxf(diff, p.ambient);
    if constexpr (MATS) scene.color(px, py, pz, p.albedo, alb);
  }
  float fc[3];
  floor_colour(r, p, fc);
  const float miss = 1.0f - hit;
  cr = sqrtf(fmaxf(hit * (alb[0] * diff) + miss * fc[0], 0.0f) + 1e-12f);
  cg = sqrtf(fmaxf(hit * (alb[1] * diff) + miss * fc[1], 0.0f) + 1e-12f);
  cb = sqrtf(fmaxf(hit * (alb[2] * diff) + miss * fc[2], 0.0f) + 1e-12f);
}

// Dynamic shared memory of the pixel build's sums (OUT 2, where S does not
// divide 32), after the stack's columns: three floats a thread.
template <int OUT>
__host__ __device__ inline size_t march_sum_bytes(int threads, int S) {
  return OUT == 2 && 32 % S != 0 ? (size_t)3 * threads * sizeof(float) : 0;
}

// SRC 0: ray q reads origins/dirs f32[n, 3]; SRC 1: ray q is AA sample s of
// pixel (i, j), q = (i * W + j) * S + s, from the camera. OUT 0 writes t,
// hit (o0, o1) and steps; OUT 1 the gamma-corrected r, g, b (o0, o1, o2) of
// each ray; OUT 2 the mean of each pixel's S colours into o0 = f32[H, W, 3].
// The pixel build's blocks hold whole pixels (pixel_threads): where S
// divides 32 a pixel's samples are S aligned lanes of one warp, summed by
// xor shuffles as K2 sums them (fine.cuh); any other S (9, 25, 64, ...)
// straddles or spans warps, so the block sums through shared memory after
// one barrier, in sample order, by the pixel's first thread.
template <int SRC, int OUT, bool DYN, bool RELAX, bool MATS, int STK>
__global__ void march_kernel(SceneWords sw, const float* __restrict__ origins,
                             const float* __restrict__ dirs,
                             const float* __restrict__ cam,
                             const float* __restrict__ bound, RenderParams p,
                             int n, float* __restrict__ o0,
                             float* __restrict__ o1, float* __restrict__ o2,
                             int* __restrict__ steps_out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const CullView whole{};  // MODE 0 and 3 read no tile lists or masks
  const WordScene<DYN ? 3 : 0, STK> scene{sw, whole, 0};
  if constexpr (OUT != 2) {
    if (q >= n) return;
    Ray r;
    if constexpr (SRC == 0) {
      r.ox = __ldg(origins + 3 * q + 0);
      r.oy = __ldg(origins + 3 * q + 1);
      r.oz = __ldg(origins + 3 * q + 2);
      r.dx = __ldg(dirs + 3 * q + 0);
      r.dy = __ldg(dirs + 3 * q + 1);
      r.dz = __ldg(dirs + 3 * q + 2);
    } else {
      const int S = p.naa * p.naa;
      const long long pix = q / S;
      const int s = (int)(q - pix * S);
      const int i = (int)(pix / p.width);
      const int j = (int)(pix - (long long)i * p.width);
      float x, y;
      aa_screen_xy(cam, p, i, j, s, x, y);
      r = view_ray(cam, p, x, y);
    }
    float t;
    int steps;
    const float hit = march_ray<RELAX>(scene, r, bound, p, t, steps);
    if constexpr (OUT == 0) {
      o0[q] = t;
      o1[q] = hit;
      steps_out[q] = steps;
    } else {
      float cr, cg, cb;
      shade_ray<MATS>(scene, r, t, hit, p, cr, cg, cb);
      o0[q] = cr;
      o1[q] = cg;
      o2[q] = cb;
    }
  } else {
    // Threads past the last ray still take part in the sums, with zeros.
    const int S = p.naa * p.naa;
    const int s = (int)(threadIdx.x % S);
    const long long pix = q / S;
    float cr = 0.0f, cg = 0.0f, cb = 0.0f;
    if (q < n) {
      const int i = (int)(pix / p.width);
      const int j = (int)(pix - (long long)i * p.width);
      float x, y;
      aa_screen_xy(cam, p, i, j, s, x, y);
      const Ray r = view_ray(cam, p, x, y);
      float t;
      int steps;
      const float hit = march_ray<RELAX>(scene, r, bound, p, t, steps);
      shade_ray<MATS>(scene, r, t, hit, p, cr, cg, cb);
    }
    if (32 % S == 0) {
      for (int off = S >> 1; off > 0; off >>= 1) {
        cr += __shfl_xor_sync(0xffffffffu, cr, off);
        cg += __shfl_xor_sync(0xffffffffu, cg, off);
        cb += __shfl_xor_sync(0xffffffffu, cb, off);
      }
    } else {
      extern __shared__ float rmt_stack[];
      float* sums = rmt_stack + stack_smem_bytes<MATS, STK>(sw, blockDim.x) /
                                    sizeof(float);
      sums[threadIdx.x] = cr;
      sums[blockDim.x + threadIdx.x] = cg;
      sums[2 * blockDim.x + threadIdx.x] = cb;
      __syncthreads();
      if (s == 0) {
        for (int k = 1; k < S; ++k) {
          cr += sums[threadIdx.x + k];
          cg += sums[blockDim.x + threadIdx.x + k];
          cb += sums[2 * blockDim.x + threadIdx.x + k];
        }
      }
    }
    if (s == 0 && q < n) {
      float* out = o0 + pix * 3;
      out[0] = cr * p.inv_s;
      out[1] = cg * p.inv_s;
      out[2] = cb * p.inv_s;
    }
  }
}

// One launch of march_kernel, dispatched to its build by template flags.
struct MarchLaunch {
  unsigned grid;
  int threads;
  cudaStream_t st;
  SceneWords sw;
  int stk;
  const float *origins, *dirs, *cam, *bound;
  RenderParams p;
  int n;
  float *o0, *o1, *o2;
  int* steps;

  template <int SRC, int OUT, bool DYN, bool RELAX, bool MATS, int STK>
  cudaError_t go() const {
    const auto k = march_kernel<SRC, OUT, DYN, RELAX, MATS, STK>;
    const size_t smem = stack_smem_bytes<MATS, STK>(sw, threads) +
                        march_sum_bytes<OUT>(threads, p.naa * p.naa);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    k<<<grid, threads, smem, st>>>(sw, origins, dirs, cam, bound, p, n, o0, o1,
                                   o2, steps);
    return cudaGetLastError();
  }
  template <int SRC, int OUT, bool DYN, bool RELAX, bool MATS>
  cudaError_t route() const {
    if (stk == REG_STACK) return go<SRC, OUT, DYN, RELAX, MATS, REG_STACK>();
    return go<SRC, OUT, DYN, RELAX, MATS, STK_SMEM>();
  }
  template <int SRC, int OUT, bool MATS>
  cudaError_t flags(bool dyn, bool relax) const {
    if (dyn) {
      return relax ? route<SRC, OUT, true, true, MATS>()
                   : route<SRC, OUT, true, false, MATS>();
    }
    return relax ? route<SRC, OUT, false, true, MATS>()
                 : route<SRC, OUT, false, false, MATS>();
  }
};

// The builds of each output, one source each so that nvcc compiles them in
// parallel: K5 and K6 in march.cu, K7 per AA ray in march_render.cu, K7's
// pixel build in march_pixel.cu.
cudaError_t launch_march_rays(const MarchLaunch& L, bool rays, bool dyn,
                              bool relax);
cudaError_t launch_march_render(const MarchLaunch& L, bool mats, bool dyn,
                                bool relax);
cudaError_t launch_march_pixels(const MarchLaunch& L, bool mats, bool dyn,
                                bool relax);

}  // namespace rmt
