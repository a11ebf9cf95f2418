// The unpacked fine pass (K4): every AA sample of a pixel marches and
// shades in a lane of its own, and the pixel's AA mean sums them in sample
// order; MODE 0's builds and the plain C interface for ctypes.
//
// fine_unpacked_kernel replaces raymarch_tpu/ops/pallas_prepass.py:
// make_pallas_image_render_aa.fine_kernel (1010, the two_d layout,
// launched at 1504), whose grid is (pixel tile, AA sample) with the sample
// innermost. It serves what the AA-packed fine kernel (fine.cuh, K2) does
// not: cfg.aa_shared_normals, whose normal cache lives across the samples of
// a pixel (1125-1136, 1206-1232), and AA grids whose S = aa^2 samples do not
// pack into a warp (aa = 3, 5, 6, 7), where K2 averages over adjacent lanes.
//
// Lane map (fine_unpacked.cuh): thread q of a block is lane q % lanes of
// pixel q / lanes, a block holding whole pixels of one row as K7's pixel
// build does (march.cuh pixel_threads): lanes = S, so a pixel sits in one
// warp where S divides 32 (aa 1, 2, 4) and straddles or fills warps
// otherwise; past 128 samples (aa > 11) each lane walks ceil(S / lanes)
// samples in sample order, so a block has at most 128 threads, the
// kernel's launch bound (7 blocks an SM, 72 registers a thread, where no
// build spills). Each sample is K2's AA ray: it marches from the same prepass
// planes (PRE 1: the legacy (t0, status) planes read at block (i / B, j /
// B), B = 1 after the chained pixel pass, or no prepass at all; PRE 2: the
// block's near intervals in registers, fine.cuh ShiftIntervals; PRE 4 more
// than MAX_NI of them, read in place), plainly or, with RELAX,
// over-relaxed, through fine.cuh's legacy_march and interval_march; Lambert
// shading with the albedo of the tape's colour walk (MATS), the checker
// floor on a miss and sqrt gamma, as K2. With residual pointers lane s
// writes its sample's march end t and hit flag at (i * W + j) * S + s, the
// layout K8 (fused_bwd.cu) reads after K2: coalesced stores.
//
// Normals: without `shared` every hit sample takes the 4 tetrahedron taps
// at its own hit point, in one loop. With `shared` the first
// sample in sample order that hits computes the normal at its own hit point
// and every later hitting sample of the pixel reuses it, with its own hit
// point for the light direction and its own albedo: a ballot over the
// pixel's lanes finds that sample where the pixel sits in one warp, a slot
// in shared memory after a barrier elsewhere; its hit point goes to lanes
// 0-3 of the pixel, each takes one tap, and every lane sums the four in
// tet_normal's order (the normal a single lane's loop gives, bit for bit,
// at one warp evaluation instead of four). The pixel's colour is the sum
// over its samples in sample order, times 1/S, as the reference's
// accumulator (r_ref += cr, then * (1/S) at s == S - 1): each lane writes
// its colour to shared memory, and after a barrier (the warp's, where the
// pixel sits in one) lanes 0-2 of the pixel sum one channel each. MODE is
// the culling mode of scene_eval.cuh: 0-2 on a static
// tape, 3-4 the DYN builds; a group of pixels may cross a list tile's
// edge (aa 3: 14 pixels a block), and each lane reads its own pixel's tile.
//
// The scene function is K1/K2's (scene_eval.cuh WordScene over the packed
// words, float4 leaf rows), the value stack's top in a register and the
// slots below it on route STK (a register up to depth REG_STACK, else a
// column of the block's dynamic shared memory, before the colour sums).
// Every K4 source builds with -fmad=false (_build.py K4_SOURCES): each
// operation rounds as in fine_unpacked_plain, so t and hit equal the plain
// version's ray for ray.
//
// What bounds it on an H100: f32 instruction issue in the scene evaluator
// and warp divergence (a warp runs until its slowest sample ends), as K2;
// it reads 8 bytes of planes per pixel and writes 12 (plus 8 per sample
// with residuals).
#include <cuda_runtime.h>

#include "fine_unpacked.cuh"

namespace rmt {

template cudaError_t launch_unpacked<0>(const UnpackedLaunch&, bool, bool, int);

}  // namespace rmt

extern "C" {

// Returns the cudaError_t of the launch (0 = success). words =
// i32[n_instr, 4]: the packed static tape, or with dyn != 0 the frame's
// packed dynamic tape (cull->mode 0 or 2); leaf_params 16-byte aligned; stk
// the value stack's route for a tape of stack depth stack_depth. t_out and
// hit_out may be null (no residuals); shared != 0 shares each pixel's first
// hit normal; max_lanes caps the lanes a pixel (cuda_prepass.py
// unpacked_lanes: 128, fewer where a deep stack's columns would not fit).
int rmt_fine_unpacked_launch(const float* leaf_params, const int* row_kind,
                             const int* words, int n_instr,
                             const float* op_param, int dyn, int stk,
                             int stack_depth, const float* cam,
                             const float* bound,
                             const rmt::RenderParams* params,
                             const rmt::CullView* cull, const float* t0_in,
                             const float* status_in, float* img, float* t_out,
                             float* hit_out, int mats, int shared,
                             int max_lanes,
                             const rmt::BlockParams* block_params,
                             void* stream) {
  rmt::UnpackedLaunch L;
  L.p = *params;
  L.bp = *block_params;
  const int S = L.p.naa * L.p.naa;
  if ((t_out == nullptr) != (hit_out == nullptr) || S < 1 || max_lanes < 1 ||
      max_lanes > rmt::UNPACKED_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  if (!rmt::make_words(leaf_params, row_kind, words, n_instr, op_param,
                       L.p.max_dist, stk, stack_depth, &L.sw))
    return (int)cudaErrorInvalidValue;
  L.u = rmt::pixel_lanes(S, max_lanes, shared != 0);
  // A pixel over warps takes its shared normal's taps on lanes 0-3.
  if (32 % L.u.lanes != 0 && L.u.lanes < 4) return (int)cudaErrorInvalidValue;
  L.threads = L.u.pixels * L.u.lanes;
  L.grid = dim3((L.p.width + L.u.pixels - 1) / L.u.pixels, L.p.rows);
  L.st = (cudaStream_t)stream;
  L.stk = stk;
  L.cam = cam;
  L.bound = bound;
  L.cv = *cull;
  L.t0_in = t0_in;
  L.status_in = status_in;
  L.img = img;
  L.t_out = t_out;
  L.hit_out = hit_out;
  const bool relax = L.p.relax > 1.0f;
  const int pre = L.p.no_prepass || L.bp.ni == 0 ? 1
                  : L.bp.ni > rmt::MAX_NI         ? 4
                                                  : 2;
  const bool m = mats != 0;
  switch (rmt::build_mode(cull->mode, dyn != 0)) {
    case 0: return (int)rmt::launch_unpacked<0>(L, relax, m, pre);
    case 1: return (int)rmt::launch_unpacked<1>(L, relax, m, pre);
    case 2: return (int)rmt::launch_unpacked<2>(L, relax, m, pre);
    case 3: return (int)rmt::launch_unpacked<3>(L, relax, m, pre);
    case 4: return (int)rmt::launch_unpacked<4>(L, relax, m, pre);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
