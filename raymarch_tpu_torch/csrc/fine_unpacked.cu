// The unpacked fine pass (K4): every AA sample of a pixel marches, shades
// and joins the pixel's AA mean in sample order, in one thread per pixel.
//
// fine_unpacked_kernel replaces raymarch_tpu/ops/pallas_prepass.py:
// make_pallas_image_render_aa.fine_kernel (1010, the two_d layout,
// launched at 1504), whose grid is (pixel tile, AA sample) with the sample
// innermost. It serves what the AA-packed fine kernel (fine.cuh, K2) does
// not: cfg.aa_shared_normals, whose normal cache lives across the samples of
// a pixel (1125-1136, 1206-1232), and AA grids whose S = aa^2 samples do not
// pack into a warp (aa = 3, 5, 6, 7), where K2 averages over adjacent lanes.
//
// Each sample is K2's AA ray: it marches from the same prepass planes (PRE
// 1: the legacy (t0, status) planes read at block (i / B, j / B), B = 1
// after the chained pixel pass, or no prepass at all; PRE 2: the block's
// near intervals, through fine.cuh's interval_march), plainly or, with
// RELAX, over-relaxed; it takes the 4 tetrahedron taps at its hit point,
// Lambert shading with the albedo of the tape's colour walk (MATS), the
// checker floor on a miss and sqrt gamma, as K2 does. The pixel's colour is
// the sum over its samples in order, times 1/S, as the reference's
// accumulator (r_ref += cr, then * (1/S) at s == S - 1). With `shared`, the
// first sample in sample order that hits computes the normal at its own hit
// point and every later hitting sample of the pixel reuses it, with its own
// hit point for the light direction. With residual pointers it also writes
// each sample's march end t and hit flag at (i * W + j) * S + s: the layout
// K8 (fused_bwd.cu) reads after K2. MODE is the culling mode of
// scene_eval.cuh: 0-2 on a static tape, 3-4 the DYN builds.
//
// What bounds it on an H100: f32 instruction issue in the scene
// interpreter, as K2; a thread walks its pixel's S rays one after another,
// so a warp holds 32 pixels and waits for its slowest pixel's S marches.
// The design is the simple one (the first-hit rule falls out of the sample
// loop); it reads 8 bytes of planes per pixel and writes 12 (plus 8 per
// sample with residuals). Built with nvcc's default FMA contraction, as
// K2's hard builds.
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

  // The pixel's prepass: the same for all of its samples.
  float t_start = 0.0f, live0 = 1.0f;
  float st[MAX_NI], en[MAX_NI];
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
      hit = interval_march<MODE, RELAX>(sc, cv, tile, r, p, st, en, live0, t,
                                        t_cap);
    } else {
      hit = legacy_march<MODE, RELAX>(sc, cv, tile, r, p, live0, t, t_cap);
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
        tet_normal<MODE>(sc, cv, tile, p.eps, px, py, pz, nx, ny, nz);
        have_normal = true;
      }
      diff = lambert<MODE, MATS>(sc, cv, tile, p, px, py, pz, nx, ny, nz, alb);
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
  template <int MODE>
  void flags(bool relax, bool mats, bool intervals) const {
    if (relax) {
      if (mats) intervals ? go<MODE, true, true, 2>() : go<MODE, true, true, 1>();
      else intervals ? go<MODE, true, false, 2>() : go<MODE, true, false, 1>();
    } else {
      if (mats) intervals ? go<MODE, false, true, 2>() : go<MODE, false, true, 1>();
      else intervals ? go<MODE, false, false, 2>() : go<MODE, false, false, 1>();
    }
  }
};

}  // namespace rmt

extern "C" {

// Returns the cudaError_t of the launch (0 = success). dyn != 0 reads `tape`
// as the frame's dynamic tape (cull->mode 0 or 2); t_out and hit_out may be
// null (no residuals); shared != 0 shares each pixel's first hit normal.
int rmt_fine_unpacked_launch(const float* leaf_params, const int* row_kind,
                             const int* tape, int n_instr,
                             const float* op_param, int dyn, const float* cam,
                             const float* bound,
                             const rmt::RenderParams* params,
                             const rmt::CullView* cull, const float* t0_in,
                             const float* status_in, float* img, float* t_out,
                             float* hit_out, int mats, int shared,
                             const rmt::BlockParams* block_params,
                             void* stream) {
  rmt::UnpackedLaunch L;
  L.p = *params;
  L.bp = *block_params;
  if (L.bp.ni > rmt::MAX_NI || (t_out == nullptr) != (hit_out == nullptr))
    return (int)cudaErrorInvalidValue;
  L.block = dim3(rmt::UNPACKED_THREADS);
  L.grid = dim3((L.p.width + rmt::UNPACKED_THREADS - 1) / rmt::UNPACKED_THREADS,
                L.p.rows);
  L.st = (cudaStream_t)stream;
  L.sc = rmt::make_scene(leaf_params, row_kind, tape, n_instr, op_param,
                         L.p.max_dist);
  L.cam = cam;
  L.bound = bound;
  L.cv = *cull;
  L.t0_in = t0_in;
  L.status_in = status_in;
  L.img = img;
  L.t_out = t_out;
  L.hit_out = hit_out;
  L.shared = shared;
  const bool relax = L.p.relax > 1.0f;
  const bool intervals = !L.p.no_prepass && L.bp.ni > 0;
  const bool m = mats != 0;
  switch (dyn ? (cull->mode == 0 ? 3 : cull->mode == 2 ? 4 : -1) : cull->mode) {
    case 0: L.flags<0>(relax, m, intervals); break;
    case 1: L.flags<1>(relax, m, intervals); break;
    case 2: L.flags<2>(relax, m, intervals); break;
    case 3: L.flags<3>(relax, m, intervals); break;
    case 4: L.flags<4>(relax, m, intervals); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
