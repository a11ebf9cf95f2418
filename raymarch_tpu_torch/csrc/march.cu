// The flat-layout march kernels, one thread per ray, served by one kernel
// template, with a plain C interface for ctypes.
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
//   and sqrt gamma -> r, g, b f32[N] per AA sample; the caller takes the AA
//   mean (SRC 1, OUT 1).
// Ray r of an image is r = (i * W + j) * S + s, pixel-major with the
// sample fastest (raymarch_tpu/ops/raygen.py), so a warp holds a few
// neighbouring pixels' samples, whose rays end together. N is any count:
// there is no padding to the reference's 16,384-ray tiles.
//
// The march is exact sphere tracing (_march_tile, 1088-1214): with
// bound_accel the scene's bounding sphere sets t0 and the exit cap t_cap
// when it is valid; a ray escapes on d > max_dist or t > t_cap, and a hit
// wins on the boundary; steps counts the iterations in which the ray was
// live, at most max_iter. RELAX (cfg.relax > 1) takes the over-relaxed
// steps and their fallback (1133-1176): an overshot step is stepped back by
// (1 - relax) * step (a negative step) and counts as a step; hit and escape
// are tested only at samples that did not overshoot. The reference blocks
// its exit test over a tile and K steps, but masked lanes are no-ops, so a
// loop per ray that stops when its ray stops gives the same t, hit and
// steps on every ray. K7's surface point is o + d * t * hit (1620-1622): a
// miss shades at the origin and its surface term enters multiplied by 0, so
// the kernel skips a miss's taps, exactly.
//
// DYN interprets a dynamic tape (compile_scene(static=False)): the frame's
// tape_ops / tape_arg / out_slot, uploaded like leaf_params, with the stack
// started at max_dist and NOP the identity (scene_eval.cuh). The reference's
// macro streams (tape.py:macroize_streams) are a TPU layout the port does
// not use.
//
// Rounding: this file is compiled with -fmad=false (_build.py), so every
// product and sum rounds on its own, as in the plain torch versions
// (ops/cuda_march.py:ray_march_plain, image_march_plain,
// image_render_plain): t, hit and steps then agree with them on every ray,
// where one contracted FMA moves a grazing ray's march by a step.
//
// What bounds them on an H100: K5 reads 24 bytes and K5/K6 write 12 bytes
// per ray, K7 12 (398 MB at 1080p / 16 AA for K6), against ~10^11 f32
// operations of the scene interpreter at that size: operations, and warp
// divergence (a warp runs until its slowest ray ends). The design keeps
// everything per ray in registers (the interpreter's stack in local
// memory) and reads the tape and the leaf rows through the read-only
// cache, uniformly across a warp.
#include <cstdint>

#include <cuda_runtime.h>

#include "fine.cuh"
#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

constexpr int MARCH_THREADS = 128;

// Sphere tracing of one ray from the camera or its origin -> hit; t ends
// where the ray does, steps counts its live iterations.
template <bool DYN, bool RELAX>
__device__ __forceinline__ float march_ray(const SceneView& sc, const Ray& r,
                                           const float* __restrict__ bound,
                                           const RenderParams& p, float& t,
                                           int& steps) {
  float live = 1.0f, t_cap = FAR_T, hit = 0.0f;
  t = 0.0f;
  steps = 0;
  if (p.use_bound) bound_clip(bound, r, p.min_dist, live, t, t_cap);
  if constexpr (RELAX) {
    float prev_r = 0.0f, step_len = 0.0f, omega = p.relax;
    for (int k = 0; k < p.max_iter && live > 0.0f; ++k) {
      const float d = scene_distance<DYN>(sc, r.ox + r.dx * t, r.oy + r.dy * t,
                                          r.oz + r.dz * t);
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
      const float d = scene_distance<DYN>(sc, r.ox + r.dx * t, r.oy + r.dy * t,
                                          r.oz + r.dz * t);
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

// SRC 0: ray q reads origins/dirs f32[n, 3]; SRC 1: ray q is AA sample s of
// pixel (i, j), q = (i * W + j) * S + s, from the camera. OUT 0 writes t,
// hit (o0, o1) and steps; OUT 1 the gamma-corrected r, g, b (o0, o1, o2).
template <int SRC, int OUT, bool DYN, bool RELAX, bool MATS>
__global__ void march_kernel(SceneView sc, const float* __restrict__ origins,
                             const float* __restrict__ dirs,
                             const float* __restrict__ cam,
                             const float* __restrict__ bound, RenderParams p,
                             int n, float* __restrict__ o0,
                             float* __restrict__ o1, float* __restrict__ o2,
                             int* __restrict__ steps_out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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
  const float hit = march_ray<DYN, RELAX>(sc, r, bound, p, t, steps);
  if constexpr (OUT == 0) {
    o0[q] = t;
    o1[q] = hit;
    steps_out[q] = steps;
  } else {
    const float px = r.ox + r.dx * t * hit;
    const float py = r.oy + r.dy * t * hit;
    const float pz = r.oz + r.dz * t * hit;
    float diff = 0.0f;
    float alb[3] = {p.albedo[0], p.albedo[1], p.albedo[2]};
    if (hit > 0.0f) {
      // Tetrahedron taps: k in {(+,-,-), (-,-,+), (-,+,-), (+,+,+)}.
      const float e = p.eps;
      const float d0 = scene_distance<DYN>(sc, px + e, py - e, pz - e);
      const float d1 = scene_distance<DYN>(sc, px - e, py - e, pz + e);
      const float d2 = scene_distance<DYN>(sc, px - e, py + e, pz - e);
      const float d3 = scene_distance<DYN>(sc, px + e, py + e, pz + e);
      float nx = 0.0f, ny = 0.0f, nz = 0.0f;
      nx = nx + d0; ny = ny - d0; nz = nz - d0;
      nx = nx - d1; ny = ny - d1; nz = nz + d1;
      nx = nx - d2; ny = ny + d2; nz = nz - d2;
      nx = nx + d3; ny = ny + d3; nz = nz + d3;
      const float ninv = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz + 1e-20f);
      nx = nx * ninv;
      ny = ny * ninv;
      nz = nz * ninv;
      const float tlx = px - p.light[0];
      const float tly = py - p.light[1];
      const float tlz = pz - p.light[2];
      const float linv =
          1.0f / sqrtf(tlx * tlx + tly * tly + tlz * tlz + 1e-20f);
      diff = nx * tlx * linv + ny * tly * linv + nz * tlz * linv;
      diff = fmaxf(diff, p.ambient);
      if constexpr (MATS) scene_color<DYN>(sc, px, py, pz, p.albedo, alb);
    }
    float fc[3];
    floor_colour(r, p, fc);
    const float miss = 1.0f - hit;
    o0[q] = sqrtf(fmaxf(hit * (alb[0] * diff) + miss * fc[0], 0.0f) + 1e-12f);
    o1[q] = sqrtf(fmaxf(hit * (alb[1] * diff) + miss * fc[1], 0.0f) + 1e-12f);
    o2[q] = sqrtf(fmaxf(hit * (alb[2] * diff) + miss * fc[2], 0.0f) + 1e-12f);
  }
}

struct MarchLaunch {
  dim3 grid, block;
  cudaStream_t st;
  SceneView sc;
  const float *origins, *dirs, *cam, *bound;
  RenderParams p;
  int n;
  float *o0, *o1, *o2;
  int* steps;

  template <int SRC, int OUT, bool DYN, bool RELAX, bool MATS>
  void go() const {
    march_kernel<SRC, OUT, DYN, RELAX, MATS><<<grid, block, 0, st>>>(
        sc, origins, dirs, cam, bound, p, n, o0, o1, o2, steps);
  }
  template <int SRC, int OUT, bool MATS>
  void flags(bool dyn, bool relax) const {
    if (dyn) {
      if (relax) go<SRC, OUT, true, true, MATS>();
      else go<SRC, OUT, true, false, MATS>();
    } else {
      if (relax) go<SRC, OUT, false, true, MATS>();
      else go<SRC, OUT, false, false, MATS>();
    }
  }
};

}  // namespace rmt

extern "C" {

// Launches K5 (origins and dirs given, out 0), K6 (no rays, out 0) or K7
// (no rays, out 1) over n rays; returns the cudaError_t of the launch (0 =
// success). tape = i32[3, n_instr]: the static tape, or with dyn != 0 the
// frame's dynamic tape (opcodes, leaf rows, stack slots). out 0 writes t,
// hit (o0, o1) and steps; out 1 writes r, g, b (o0, o1, o2), with mats != 0
// the albedo of a painted scene.
int rmt_march_launch(const float* leaf_params, const int* row_kind,
                     const int* tape, int n_instr, const float* op_param,
                     int dyn, int mats, const float* origins,
                     const float* dirs, const float* cam, const float* bound,
                     const rmt::RenderParams* params, int n, int out,
                     float* o0, float* o1, float* o2, int* steps,
                     void* stream) {
  if (n <= 0) return 0;
  const bool rays = origins != nullptr;
  if ((rays && (dirs == nullptr || out != 0)) || (!rays && cam == nullptr) ||
      out < 0 || out > 1)
    return (int)cudaErrorInvalidValue;
  rmt::MarchLaunch L;
  L.p = *params;
  L.grid = dim3((unsigned)((n + rmt::MARCH_THREADS - 1) / rmt::MARCH_THREADS));
  L.block = dim3(rmt::MARCH_THREADS);
  L.st = (cudaStream_t)stream;
  L.sc = rmt::make_scene(leaf_params, row_kind, tape, n_instr, op_param,
                         L.p.max_dist);
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
  if (rays) L.flags<0, 0, false>(dyn != 0, relax);
  else if (out == 0) L.flags<1, 0, false>(dyn != 0, relax);
  else if (mats) L.flags<1, 1, true>(dyn != 0, relax);
  else L.flags<1, 1, false>(dyn != 0, relax);
  return (int)cudaGetLastError();
}

}  // extern "C"
