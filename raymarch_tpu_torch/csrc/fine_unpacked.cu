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
// near intervals, through fine.cuh's interval_march; PRE 4 more than MAX_NI
// of them, read in place, in intervals_wide.cu), plainly or, with
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

#include "fine_unpacked.cuh"

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
  if ((t_out == nullptr) != (hit_out == nullptr))
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
  const int pre = L.p.no_prepass || L.bp.ni == 0 ? 1
                  : L.bp.ni > rmt::MAX_NI         ? 4
                                                  : 2;
  const bool m = mats != 0;
  switch (rmt::build_mode(cull->mode, dyn != 0)) {
    case 0: L.flags<0>(relax, m, pre); break;
    case 1: L.flags<1>(relax, m, pre); break;
    case 2: L.flags<2>(relax, m, pre); break;
    case 3: L.flags<3>(relax, m, pre); break;
    case 4: L.flags<4>(relax, m, pre); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
