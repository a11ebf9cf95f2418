// The compact O(active) backward of the fused render for every compact plan
// without residual subtrees: the gradient of sum(img * g_img) with respect
// to the leaf bank, the op words and the camera, from the forward's per-ray
// residuals (t, hit) and the fine kernel's per-tile item lists. Plain C
// interface for ctypes.
//
// compact_bwd_kernel replaces raymarch_tpu/ops/pallas_grad.py:
// _make_compact_bwd.bwd_kernel (256, launched at 1181; design 114-161). The
// scene of a point is the min over SOURCES: (0) the free pool, a hard-union
// min fold; (1) the seg1 chain, free prefix groups and one ordered fold;
// (2+) each stream group, the min over its <= 8 segments' ordered folds. A
// point's cotangent goes to its winning source, chosen by strict < in that
// order (src_mask, 491-505), and within it:
//   - pool: to the one leaf that wins the fold (strict <, in list order,
//     391-420), through that leaf's adjoint;
//   - chain or stream: the fold acc_{j+1} = step(acc_j, leaf_j, mode_j, k_j)
//     is replayed forward, recording each acc_j (and, for a stream, the
//     winning segment: the one whose fold the running min kept, 683-712),
//     then swept in reverse carrying the accumulator's cotangent: each
//     item's fold-step adjoint gives the leaf's cotangent (through the
//     leaf adjoint of scene_grad.cuh), the next accumulator cotangent and,
//     for a smooth item, the blend radius's gradient into op word kidx
//     (sweep_group 714, sweep_chain 792). A stream sweep skips the items of
//     the other segments.
// Per AA ray that hit, with g the pixel's cotangent over S:
//   1. rebuild the ray from cam (225-241) and the hit point p = o + d t;
//   2. evaluate every source at the 4 tetrahedron taps and at p (pass 1):
//      each point's value, winning source and pool winner row;
//   3. run the shading adjoint (as fused_bwd.cu does): tap k's value takes
//      k . g_n and goes through its winning source's adjoint at p + eps k;
//      the light vector adds g_p; g_t = g_p . d;
//   4. at p, record the winning source once and sweep it twice (149-152):
//      with a unit cotangent for fdot = grad_x F . d, then with the clamped
//      weight w = -g_t / fdot for the parameters and the camera;
//   5. on a painted scene (pool-only plans, as the dispatch guarantees) the
//      shading reads the albedo of the hit point's pool winner, flag *
//      albedo + (1 - flag) * cfg.albedo, and its cotangent lands on that
//      row's albedo and flag words (978-997);
//   6. the camera gets g_p through o and through d t.
// A ray that missed contributes exactly zero and returns at once. Per-tile
// source gating (gated3, 849) is per thread here: a ray records and sweeps
// only its own winning source.
//
// The SOFT builds (soft-coverage mode, 256-330, 509-571, 1043-1130) read
// the closest-approach residuals (s_min, t_min) too and run every ray that
// hit or whose coverage exceeds 1e-4 * min(1, beta) (soft_work,
// scene_grad.cuh): the taps sit at the hit point, at o + d t_min on a miss
// or at the origin where alpha <= 1e-4, the coverage blend's adjoint gives
// the cotangent g_s of s_min, the implicit term runs on hit rays only, and
// the envelope sweep evaluates the sources at a sixth point, o + d t_min,
// and pushes g_s through its winning source (pool leaf, re-recorded chain
// or stream group), its position cotangent reaching o and, times t_min, d.
// Soft mode never takes a painted plan (the dispatch sends it to K8).
//
// History: recorded, never recomputed. Each thread owns a slice of a
// device-memory scratch of hist_len floats, hist_len = the plan's total
// ordered span (every seg1 and stream group's items, each group at its own
// base: list column - hist_off), not the reference's largest single group
// nor its 64-item VMEM cap (ROADMAP §3.1). Item h of a thread lives at
// hist[h * n_threads + thread], so a warp's records of one item are
// adjacent. The wrapper caps the grid so that the scratch stays within its
// budget (the grid-stride loop covers every ray at any grid size). The
// history never enters the register file.
//
// The kernel is built once per (ORDERED, MATS, SOFT), SOFT without MATS: a
// pool-only plan runs the build without the replays and sweeps (as fast as
// the pool-only kernel before the ordered branches were added), a painted
// pool the one with the albedo routing. ptxas (sm_90a, -O3, -fmad=false;
// the report _build.py keeps and chip_smoke.py prints): 76 registers
// (pool), 78 (painted pool), 92 (ordered), 94 (ordered, painted), 81 (pool,
// soft), 96 (ordered, soft); a 144-byte stack frame and 0 bytes of spill
// stores and loads in each.
//
// The fold replay repeats scene_distance_compact's operation order
// (fold_step, the min folds, strict < at each segment flush), so the
// recorded accumulators are the values the sweeps differentiate.
//
// Accumulation: each block keeps one partial row of nscal = 16 n_leaves +
// n_instr + 7 words in shared memory (4.6 KB at 64 leaves), filled with
// shared-memory atomics, and writes it to partials[block]; the fused
// backward's bwd_finalize_kernel then sums the rows in block order. The
// order of the atomics within a block varies from run to run, so the
// result is not bitwise reproducible; it varies in the last bits of the
// block sums. A block's 227 KB of shared memory caps the bank at ~3,500
// leaves (the wrapper raises above it).
//
// What bounds it on an H100: instruction throughput in the source
// evaluations (5 points x the tile's active leaves per hit ray), the replays
// and sweeps of the winning ordered sources, and the shared atomics of the
// winner rows; it reads 8 bytes of residuals and 12 of cotangent per ray,
// touches its history slice, and writes one row per block.
#include <cuda_runtime.h>

#include "render_common.cuh"
#include "scene_grad.cuh"

namespace rmt {

constexpr int CBWD_THREADS = 128;

// A tile's group g of the plan program: list column, active count, source
// (0 pool, 1 seg1 chain, 2 stream) and ordered flag.
struct Group {
  int off, n, source, ordered;
};

__device__ __forceinline__ Group group_of(const CullView& cv, const int* cnt,
                                          int g) {
  Group r;
  r.off = __ldg(cv.prog + 4 * g + 0);
  r.n = __ldg(cnt + __ldg(cv.prog + 4 * g + 1));
  r.source = __ldg(cv.prog + 4 * g + 2);
  r.ordered = __ldg(cv.prog + 4 * g + 3);
  return r;
}

// The pool fold of a tile's lists at q: the distance, and in `win` the row
// that first reached it (-1 when every leaf of the tile is culled: the
// point then reads CULL_FAR, a constant).
__device__ __forceinline__ float pool_fold(const SceneView& sc,
                                           const CullView& cv, int tile, V3 q,
                                           int& win) {
  const int* lst = cv.lists + (size_t)tile * cv.n_items;
  const int* cnt = cv.counts + (size_t)tile * cv.n_counts;
  float d = CULL_FAR;
  win = -1;
  for (int g = 0; g < cv.n_prog; ++g) {
    const Group G = group_of(cv, cnt, g);
    if (G.source != 0) continue;
    for (int j = 0; j < G.n; ++j) {
      const int row = __ldg(lst + G.off + j);
      const float dv = entry_distance(sc, row, q.x, q.y, q.z);
      if (dv < d) {
        d = dv;
        win = row;
      }
    }
  }
  return d;
}

// The seg1 chain at q (free prefix groups, then the ordered fold), in the
// order of scene_distance_compact; with REC it records each item's incoming
// accumulator.
template <bool REC>
__device__ float chain_fold(const SceneView& sc, const CullView& cv, int tile,
                            V3 q, const History& h) {
  const int* lst = cv.lists + (size_t)tile * cv.n_items;
  const int* cnt = cv.counts + (size_t)tile * cv.n_counts;
  float acc = CULL_FAR;
  for (int g = 0; g < cv.n_prog; ++g) {
    const Group G = group_of(cv, cnt, g);
    if (G.source != 1) continue;
    for (int j = 0; j < G.n; ++j) {
      const int e = __ldg(lst + G.off + j);
      if (REC) h.at(G.off + j) = acc;
      const float dv = entry_distance(sc, e & 1023, q.x, q.y, q.z);
      acc = G.ordered ? fold_step(sc, acc, e, dv) : fminf(acc, dv);
    }
  }
  return acc;
}

// Stream group g at q: the min over its segments' folds, each segment's
// fold flushed at its segment-id change by strict < (the first of equal
// segments wins); `bsid` gets the winning segment's id (-1 when no item is
// active). With REC it records each item's incoming accumulator.
template <bool REC>
__device__ float stream_fold(const SceneView& sc, const CullView& cv, int tile,
                             int g, V3 q, const History& h, int& bsid) {
  const int* lst = cv.lists + (size_t)tile * cv.n_items;
  const int* cnt = cv.counts + (size_t)tile * cv.n_counts;
  const Group G = group_of(cv, cnt, g);
  float best = CULL_FAR, acc_seg = CULL_FAR;
  int prev = -1;
  bsid = -1;
  for (int j = 0; j < G.n; ++j) {
    const int e = __ldg(lst + G.off + j);
    const int sid = (e >> 15) & 7;
    if (sid != prev) {
      if (acc_seg < best) {
        best = acc_seg;
        bsid = prev;
      }
      acc_seg = CULL_FAR;
    }
    if (REC) h.at(G.off + j) = acc_seg;
    acc_seg =
        fold_step(sc, acc_seg, e, entry_distance(sc, e & 1023, q.x, q.y, q.z));
    prev = sid;
  }
  if (acc_seg < best) {
    best = acc_seg;
    bsid = prev;
  }
  return best;
}

// A point's value, its winning source (0 pool, 1 chain, 2 + g for the
// stream group at program row g) and its pool winner row.
struct PointEval {
  float d;
  int src;
  int win;
};

template <bool ORDERED>
__device__ PointEval eval_point(const SceneView& sc, const CullView& cv,
                                int tile, V3 q, const History& h) {
  PointEval r;
  r.d = pool_fold(sc, cv, tile, q, r.win);
  r.src = 0;
  if constexpr (!ORDERED) return r;
  bool chain = false;
  for (int g = 0; g < cv.n_prog; ++g) {
    const int source = __ldg(cv.prog + 4 * g + 2);
    if (source == 1) chain = true;
  }
  if (chain) {
    const float v = chain_fold<false>(sc, cv, tile, q, h);
    if (v < r.d) {
      r.d = v;
      r.src = 1;
    }
  }
  for (int g = 0; g < cv.n_prog; ++g) {
    if (__ldg(cv.prog + 4 * g + 2) != 2) continue;
    int bsid;
    const float v = stream_fold<false>(sc, cv, tile, g, q, h, bsid);
    if (v < r.d) {
      r.d = v;
      r.src = 2 + g;
    }
  }
  return r;
}

// Adjoint of fold_step (scene_eval.cuh): the cotangent g of its result
// gives those of the accumulator (ga), of the leaf distance (gd) and of the
// op word of a smooth item (gk). Ties split as in scene_grad.cuh.
__device__ __forceinline__ void fold_step_adj(const SceneView& sc, float acc,
                                              int e, float dv, float g,
                                              float& ga, float& gd,
                                              float& gk) {
  const int mode = (e >> 13) & 3;
  const bool is_sub = mode >= 2;
  if (is_sub) {
    float gnd;
    max_adj(acc, -dv, g, ga, gnd);
    gd = -gnd;
  } else {
    min_adj(acc, dv, g, ga, gd);
  }
  gk = 0.0f;
  if ((mode & 1) == 0) return;
  const int ki = e >> 18;
  const float kp = __ldg(sc.op_param + (ki - 1 > 0 ? ki - 1 : 0));
  const float kk = fmaxf(kp, 1e-8f);
  const float diff = is_sub ? acc + dv : acc - dv;
  const float m = fmaxf(kk - fabsf(diff), 0.0f);
  const float h = m / kk;
  // result = hard -/+ corr, corr = h * h * kk * 0.25, h = m / kk
  const float gcorr = is_sub ? g : -g;
  const float gh = gcorr * 0.5f * h * kk;
  float gkk = gcorr * 0.25f * h * h;
  const float gm = gh / kk;
  gkk -= gh * h / kk;
  float gx, unused;
  max_adj(kk - fabsf(diff), 0.0f, gm, gx, unused);
  gkk += gx;
  const float gdiff = -gx * sgn(diff);
  ga += gdiff;
  gd += is_sub ? gdiff : -gdiff;
  float unused2;
  max_adj(kp, 1e-8f, gkk, gk, unused2);
}

// Reverse sweep of group g's recorded fold at q, carrying the accumulator
// cotangent `cot` from the fold's result back to its start; with bsid >= 0
// only the items of that stream segment. Adds the leaf and op gradients
// (ACC) and the position cotangent to gq; returns the start's cotangent.
template <bool ACC>
__device__ float sweep_group(const SceneView& sc, const CullView& cv,
                             int tile, int g, V3 q, int bsid, float cot,
                             const History& h, int op_base, BlockAcc& acc,
                             V3& gq) {
  const int* lst = cv.lists + (size_t)tile * cv.n_items;
  const int* cnt = cv.counts + (size_t)tile * cv.n_counts;
  const Group G = group_of(cv, cnt, g);
  for (int j = G.n - 1; j >= 0 && cot != 0.0f; --j) {
    const int e = __ldg(lst + G.off + j);
    if (bsid >= 0 && ((e >> 15) & 7) != bsid) continue;
    const int row = e & 1023;
    const float a = h.at(G.off + j);
    const float dv = entry_distance(sc, row, q.x, q.y, q.z);
    float ga, gd, gk = 0.0f;
    if (G.ordered) {
      fold_step_adj(sc, a, e, dv, cot, ga, gd, gk);
    } else {
      min_adj(a, dv, cot, ga, gd);
    }
    if (gd != 0.0f)
      gq = add(gq, leaf_adjoint<ACC>(sc.leaf_params + row * LEAF_PARAM_WIDTH,
                                     __ldg(sc.row_kind + row), q, gd,
                                     row * LEAF_PARAM_WIDTH, acc));
    if (ACC && G.ordered && (e >> 18) > 0 && gk != 0.0f)
      acc(op_base + (e >> 18) - 1, gk);
    cot = ga;
  }
  return cot;
}

// Replays the winning ordered source `src` (1 chain, 2 + g stream) at q
// into the history; returns a stream's winning segment (else -1).
__device__ int record_source(const SceneView& sc, const CullView& cv,
                             int tile, int src, V3 q, const History& h) {
  int bsid = -1;
  if (src == 1) {
    chain_fold<true>(sc, cv, tile, q, h);
  } else {
    stream_fold<true>(sc, cv, tile, src - 2, q, h, bsid);
  }
  return bsid;
}

// cot * dF/dp at q through the point's winning source (recorded first when
// it is ordered); with ACC also cot * dF/dtheta into the block row.
template <bool ACC, bool ORDERED>
__device__ V3 source_adjoint(const SceneView& sc, const CullView& cv,
                             int tile, const PointEval& pe, int bsid, V3 q,
                             float cot, const History& h, int op_base,
                             BlockAcc& acc) {
  V3 gq = v3(0.0f, 0.0f, 0.0f);
  if (pe.src == 0) {
    if (pe.win < 0) return gq;
    return leaf_adjoint<ACC>(sc.leaf_params + pe.win * LEAF_PARAM_WIDTH,
                             __ldg(sc.row_kind + pe.win), q, cot,
                             pe.win * LEAF_PARAM_WIDTH, acc);
  }
  if constexpr (!ORDERED) return gq;
  if (pe.src == 1) {
    for (int g = cv.n_prog - 1; g >= 0; --g) {
      if (__ldg(cv.prog + 4 * g + 2) != 1) continue;
      cot = sweep_group<ACC>(sc, cv, tile, g, q, -1, cot, h, op_base, acc, gq);
    }
  } else {
    sweep_group<ACC>(sc, cv, tile, pe.src - 2, q, bsid, cot, h, op_base, acc,
                     gq);
  }
  return gq;
}

// Grid-stride over the AA rays of the band, in the fine kernel's lane order
// (row i, then q = j * S + s). Writes one partial row of nscal words per
// block. ORDERED: the plan has a seg1 chain or stream groups (else the pool
// is its only source, and the build carries no replay or sweep); MATS: the
// scene is painted; SOFT: soft coverage, with the residuals at soft.
template <bool ORDERED, bool MATS, bool SOFT>
__global__ void compact_bwd_kernel(SceneView sc, CullView cv,
                                   const float* __restrict__ cam,
                                   RenderParams p, float clamp,
                                   const float* __restrict__ t_in,
                                   const float* __restrict__ hit_in,
                                   const float* __restrict__ g_img, int nscal,
                                   int op_base, int cam_base,
                                   float* __restrict__ hist, int hist_off,
                                   float* __restrict__ partials, SoftRes soft) {
  extern __shared__ float acc_s[];
  for (int k = threadIdx.x; k < nscal; k += blockDim.x) acc_s[k] = 0.0f;
  __syncthreads();
  BlockAcc acc{acc_s};

  const long long step = (long long)gridDim.x * blockDim.x;
  const long long me = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const History h{hist + me, step, hist_off};
  const int S = p.naa * p.naa;
  const long long row_lanes = (long long)p.width * S;
  const long long total = row_lanes * p.rows;
  for (long long gl = me; gl < total; gl += step) {
    const float hit = __ldg(hit_in + gl);
    float s_min = 0.0f, t_min = 0.0f, alpha = 1.0f;
    if constexpr (SOFT) {
      s_min = __ldg(soft.s_min + gl);
      t_min = __ldg(soft.t_min + gl);
      alpha = soft_alpha(s_min, p.min_dist, soft.beta_inv);
      if (!soft_work(hit, alpha, soft.gate)) continue;
    } else if (!(hit > 0.0f)) {
      continue;
    }
    const int i = (int)(gl / row_lanes);
    const int qi = (int)(gl - (long long)i * row_lanes);
    const int j = qi / S;
    const int s = qi - j * S;
    const int tile = tile_of(cv, i, j);
    const float t = __ldg(t_in + gl);
    const float* gi = g_img + ((size_t)i * p.width + j) * 3;
    const float gcol[3] = {__ldg(gi + 0) * p.inv_s, __ldg(gi + 1) * p.inv_s,
                           __ldg(gi + 2) * p.inv_s};

    // --- ray: the fine kernel's raygen -------------------------------------
    float x, y;
    aa_screen_xy(cam, p, i, j, s, x, y);
    float vx = x * p.tan_aspect;
    float vy = y * p.tanf;
    float vz = -1.0f;
    const float inv_norm = 1.0f / sqrtf(vx * vx + vy * vy + vz * vz);
    const V3 vn = v3(vx * inv_norm, vy * inv_norm, vz * inv_norm);
    const Ray r = view_ray(cam, p, x, y);
    const V3 d = v3(r.dx, r.dy, r.dz);
    // The surface point: o + d t on a hit; soft, o + d t_min on a miss and
    // o where alpha <= 1e-4 (shade_soft's guard).
    const bool live = !SOFT || alpha > 1e-4f;
    const float te = (!SOFT || hit > 0.5f) ? t : t_min;
    V3 pt = v3(r.ox, r.oy, r.oz);
    if (live) pt = v3(r.ox + r.dx * te, r.oy + r.dy * te, r.oz + r.dz * te);
    // The implicit term runs at the hit point of a hit ray (pt then).
    const bool implicit = !SOFT || hit > 0.0f;

    // --- pass 1: every source at the taps and the hit point ----------------
    const float e = p.eps;
    const V3 taps[4] = {v3(1.0f, -1.0f, -1.0f), v3(-1.0f, -1.0f, 1.0f),
                        v3(-1.0f, 1.0f, -1.0f), v3(1.0f, 1.0f, 1.0f)};
    V3 qk[4];
    PointEval ek[4];
    V3 n = v3(0.0f, 0.0f, 0.0f);
    for (int k = 0; k < 4; ++k) {
      qk[k] = v3(pt.x + taps[k].x * e, pt.y + taps[k].y * e,
                 pt.z + taps[k].z * e);
      ek[k] = eval_point<ORDERED>(sc, cv, tile, qk[k], h);
      n = add(n, scale(taps[k], ek[k].d));
    }
    PointEval eh{CULL_FAR, 0, -1};
    if (implicit) eh = eval_point<ORDERED>(sc, cv, tile, pt, h);

    // --- primal shading: normal, Lambert, the hit point's albedo -----------
    const float ninv =
        1.0f / sqrtf(n.x * n.x + n.y * n.y + n.z * n.z + 1e-20f);
    const V3 tl = v3(pt.x - p.light[0], pt.y - p.light[1], pt.z - p.light[2]);
    const float linv =
        1.0f / sqrtf(tl.x * tl.x + tl.y * tl.y + tl.z * tl.z + 1e-20f);
    const float dotv = dot(n, tl);
    const float sn = ninv * linv;
    const float diff0 = dotv * sn;
    const float diff = fmaxf(diff0, p.ambient);
    float alb[3] = {p.albedo[0], p.albedo[1], p.albedo[2]};
    const bool painted = MATS && eh.win >= 0;
    if (painted) {
      const float* P = sc.leaf_params + eh.win * LEAF_PARAM_WIDTH;
      const float fl = __ldg(P + LEAF_MAT_FLAG);
      for (int c = 0; c < 3; ++c)
        alb[c] = fl * __ldg(P + LEAF_ALBEDO + c) + (1.0f - fl) * p.albedo[c];
    }

    // --- adjoint of the shading --------------------------------------------
    float gdiff = 0.0f;
    float galb[3];
    float fc[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (SOFT) floor_colour(r, p, fc);
    const float galpha =
        colour_adj<SOFT>(gcol, alb, diff, alpha, fc, gdiff, galb);
    float gsm = 0.0f;  // the cotangent of s_min
    if constexpr (SOFT)
      gsm = alpha_adj(s_min, p.min_dist, soft.beta_inv, alpha, galpha);
    float gdiff0, gamb;
    max_adj(diff0, p.ambient, gdiff, gdiff0, gamb);
    const float gdot = gdiff0 * sn;
    const float gsn = gdiff0 * dotv;
    const float gN2 = -0.5f * ninv * ninv * ninv * (gsn * linv);
    const float gL2 = -0.5f * linv * linv * linv * (gsn * ninv);
    const V3 gn = add(scale(tl, gdot), scale(n, 2.0f * gN2));
    V3 gp = add(scale(n, gdot), scale(tl, 2.0f * gL2));  // through the light
    for (int k = 0; k < 4; ++k) {
      const int bsid = ORDERED && ek[k].src > 0
                           ? record_source(sc, cv, tile, ek[k].src, qk[k], h)
                           : -1;
      gp = add(gp, source_adjoint<true, ORDERED>(sc, cv, tile, ek[k], bsid,
                                                 qk[k], dot(taps[k], gn), h,
                                                 op_base, acc));
    }
    const float gt = dot(gp, d);
    V3 go = gp;
    V3 gd = live ? scale(gp, te) : v3(0.0f, 0.0f, 0.0f);

    // --- implicit-function term at the hit point ---------------------------
    if (implicit) {
      const int bsid_h = ORDERED && eh.src > 0
                             ? record_source(sc, cv, tile, eh.src, pt, h)
                             : -1;
      const V3 gradF = source_adjoint<false, ORDERED>(
          sc, cv, tile, eh, bsid_h, pt, 1.0f, h, op_base, acc);
      const float fdot = dot(gradF, d);
      const float denom =
          fabsf(fdot) > clamp ? fdot : (fdot >= 0.0f ? clamp : -clamp);
      const float w = -gt / denom;
      const V3 gq = source_adjoint<true, ORDERED>(sc, cv, tile, eh, bsid_h,
                                                  pt, w, h, op_base, acc);
      go = add(go, gq);
      gd = add(gd, scale(gq, t));
    }

    // --- envelope sweep at the frozen closest approach (soft) --------------
    if constexpr (SOFT) {
      if (gsm != 0.0f) {
        const V3 pe = v3(r.ox + r.dx * t_min, r.oy + r.dy * t_min,
                         r.oz + r.dz * t_min);
        const PointEval ee = eval_point<ORDERED>(sc, cv, tile, pe, h);
        const int bsid_e = ORDERED && ee.src > 0
                               ? record_source(sc, cv, tile, ee.src, pe, h)
                               : -1;
        const V3 gq = source_adjoint<true, ORDERED>(sc, cv, tile, ee, bsid_e,
                                                    pe, gsm, h, op_base, acc);
        go = add(go, gq);
        gd = add(gd, scale(gq, t_min));
      }
    }

    // --- the winner's albedo and flag words (painted pools) ----------------
    if (painted) {
      const float* P = sc.leaf_params + eh.win * LEAF_PARAM_WIDTH;
      const float fl = __ldg(P + LEAF_MAT_FLAG);
      const int base = eh.win * LEAF_PARAM_WIDTH;
      float gfl = 0.0f;
      for (int c = 0; c < 3; ++c) {
        acc(base + LEAF_ALBEDO + c, fl * galb[c]);
        gfl += (__ldg(P + LEAF_ALBEDO + c) - p.albedo[c]) * galb[c];
      }
      acc(base + LEAF_MAT_FLAG, gfl);
    }

    // --- camera: o = cam[0:3], d = rotate(cam[3:7], vn) --------------------
    const float qw = __ldg(cam + 3);
    const V3 qu = v3(__ldg(cam + 4), __ldg(cam + 5), __ldg(cam + 6));
    V3 gvn, gu;
    float gw;
    qrot_adj(qw, qu, vn, gd, gvn, gw, gu);
    acc(cam_base + 0, go.x);
    acc(cam_base + 1, go.y);
    acc(cam_base + 2, go.z);
    acc(cam_base + 3, gw);
    acc(cam_base + 4, gu.x);
    acc(cam_base + 5, gu.y);
    acc(cam_base + 6, gu.z);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nscal; k += blockDim.x)
    partials[(size_t)blockIdx.x * nscal + k] = acc_s[k];
}

// Launches one instantiation of compact_bwd_kernel on as many blocks as
// the card keeps resident (at most max_blocks, at most one per 128 rays).
template <bool ORDERED, bool MATS, bool SOFT>
cudaError_t launch_compact_bwd(const SceneView& sc, const CullView& cv,
                               const float* cam, const RenderParams& p,
                               float clamp, const float* t_in,
                               const float* hit_in, const float* g_img,
                               int nscal, int op_base, int cam_base,
                               float* hist, int hist_off, float* partials,
                               int max_blocks, int* n_blocks,
                               const SoftRes& soft, cudaStream_t stream) {
  long long grid = 0;
  const cudaError_t err = launch_resident(
      compact_bwd_kernel<ORDERED, MATS, SOFT>, CBWD_THREADS,
      (size_t)nscal * sizeof(float), p, max_blocks, stream, &grid, sc, cv, cam,
      p, clamp, t_in, hit_in, g_img, nscal, op_base, cam_base, hist, hist_off,
      partials, soft);
  *n_blocks = (int)grid;
  return err;
}

}  // namespace rmt

extern "C" {

// Launches compact_bwd_kernel into partials (max_blocks * nscal floats) and
// writes the number of blocks launched to *n_blocks; the caller sums the
// rows with rmt_bwd_finalize_launch. hist holds max_blocks * CBWD_THREADS *
// hist_len floats, and is null exactly when hist_len is 0 (a pool-only plan:
// the build without the ordered sources). mats != 0 routes the albedo of a
// painted pool; a soft argument with non-null residuals (s_min, t_min) runs
// the soft build (never with mats). Returns the first failing cudaError_t
// (0 = success).
int rmt_compact_bwd_launch(const float* leaf_params, const int* row_kind,
                           const int* tape, int n_instr, const float* op_param,
                           const rmt::CullView* cull, const float* cam,
                           const rmt::RenderParams* params, float clamp,
                           const float* t_in, const float* hit_in,
                           const float* g_img, int nscal, int op_base,
                           int cam_base, int mats, const rmt::SoftRes* soft,
                           float* hist, int hist_off, float* partials,
                           int max_blocks, int* n_blocks, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  cudaStream_t st = (cudaStream_t)stream;
  const rmt::SoftRes sr = *soft;
  const bool is_soft = sr.s_min != nullptr;
  if (is_soft != (sr.t_min != nullptr) || (is_soft && mats != 0))
    return (int)cudaErrorInvalidValue;
#define RMT_CBWD(ORDERED, MATS, SOFT)                                        \
  rmt::launch_compact_bwd<ORDERED, MATS, SOFT>(                              \
      sc, *cull, cam, p, clamp, t_in, hit_in, g_img, nscal, op_base,         \
      cam_base, hist, hist_off, partials, max_blocks, n_blocks, sr, st)
  cudaError_t err;
  switch ((is_soft ? 4 : 0) + (hist != nullptr ? 2 : 0) + (mats != 0 ? 1 : 0)) {
    case 0: err = RMT_CBWD(false, false, false); break;
    case 1: err = RMT_CBWD(false, true, false); break;
    case 2: err = RMT_CBWD(true, false, false); break;
    case 3: err = RMT_CBWD(true, true, false); break;
    case 4: err = RMT_CBWD(false, false, true); break;
    default: err = RMT_CBWD(true, false, true); break;
  }
#undef RMT_CBWD
  return (int)err;
}

}  // extern "C"
