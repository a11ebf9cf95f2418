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
// A ray that missed contributes exactly zero. Per-tile source gating
// (gated3, 849) is per warp here: a warp records and sweeps only the
// sources its rays win.
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
// The design for the H100. Measured with parts of the body disabled
// (PERF.md), per-lane shared-memory atomics took 60% of a pool plan's time
// and the sweeps of the ordered folds 61-68% of an ordered plan's. A
// block works on one fine tile at a time, taken from a queue: it stages
// the tile's counts and active list entries in shared memory, and every
// point of its rays reads them from there, as every lane of a warp reads
// the same entry (a broadcast). Its warps walk the tile's rays in the fine
// kernel's order (pixel rows of the tile, then pixels, then samples: 32
// lanes are 2 pixels' 16 samples), and each warp stays converged through a
// ray's backward: a lane with no work runs with a zero cotangent. So every
// add of a gradient word is a warp's (scene_grad.cuh WarpRow): the lanes
// are grouped by leaf row (a pool's winners may differ), each group's 16
// words are summed by a transposed shuffle reduction and added with one
// atomic instruction; the camera words stay in registers until the end.
// The row sits in shared memory or, where nscal exceeds ROW_SMEM (ops/
// cuda_grad.py), in the output in device memory: no bank size caps the
// plan. An ordered source that any lane of a warp needs is replayed by the
// whole warp, each lane at its own point, into the history, one float per
// item (the accumulator entering it), and swept in reverse.
//
// History: each thread owns a slice of hist_len floats, hist_len = the
// plan's total ordered span (every seg1 and stream group's items, each
// group at its own base: list column - hist_off), not the reference's
// largest single group nor its 64-item VMEM cap (ROADMAP §3.1): in shared
// memory (a slice of 256 bytes for 64 items) or, past REC_SMEM, in device
// memory, where the wrapper caps the grid so that the scratch stays within
// L2. Item h of a thread lives at hist[h * n_threads + thread], so a warp's
// records of one item are adjacent.
//
// The kernel is built once per (ORDERED, MATS, SOFT), SOFT without MATS: a
// pool-only plan runs the build without the replays and sweeps, a painted
// pool the one with the albedo routing.
//
// The fold replay repeats scene_distance_compact's operation order
// (fold_step, the min folds, strict < at each segment flush), so the
// recorded accumulators are the values the sweeps differentiate.
//
// The order of the atomics varies from run to run, so the result is not
// bitwise reproducible; it varies in the last bits of the sums.
//
// What bounds it on an H100: instruction throughput in the source
// evaluations (5 points x the tile's active leaves per hit ray) and the
// replays and sweeps of the winning ordered sources; it reads 8 bytes of
// residuals and 12 of cotangent per ray and the tile's lists once per
// block, and writes one row per block.
#include <cuda_runtime.h>

#include "render_common.cuh"
#include "scene_grad.cuh"

namespace rmt {

constexpr int CBWD_THREADS = 128;

// One fine tile's plan data as a block reads it: the tile's list row and
// counts (staged in shared memory, or in place in device memory) and the
// plan program i32[n_prog, 4] (group offset, count index, source 0 pool /
// 1 seg1 chain / 2 stream, ordered flag).
struct TileLists {
  const int* lst;
  const int* cnt;
  const int* prog;
  int n_prog;
  bool has_chain;
};

// Group g of the tile: list column, active count, source, ordered flag.
struct Group {
  int off, n, source, ordered;
};

__device__ __forceinline__ Group group_of(const TileLists& tl, int g) {
  Group r;
  r.off = tl.prog[4 * g + 0];
  r.n = tl.cnt[tl.prog[4 * g + 1]];
  r.source = tl.prog[4 * g + 2];
  r.ordered = tl.prog[4 * g + 3];
  return r;
}

// The pool fold of the tile's lists at q: the distance, and in `win` the
// row that first reached it (-1 when every leaf of the tile is culled: the
// point then reads CULL_FAR, a constant).
__device__ __forceinline__ float pool_fold(const SceneView& sc,
                                           const TileLists& tl, V3 q,
                                           int& win) {
  float d = CULL_FAR;
  win = -1;
  for (int g = 0; g < tl.n_prog; ++g) {
    const Group G = group_of(tl, g);
    if (G.source != 0) continue;
    for (int j = 0; j < G.n; ++j) {
      const int row = tl.lst[G.off + j];
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
__device__ float chain_fold(const SceneView& sc, const TileLists& tl, V3 q,
                            const History& h) {
  float acc = CULL_FAR;
  for (int g = 0; g < tl.n_prog; ++g) {
    const Group G = group_of(tl, g);
    if (G.source != 1) continue;
    for (int j = 0; j < G.n; ++j) {
      const int e = tl.lst[G.off + j];
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
__device__ float stream_fold(const SceneView& sc, const TileLists& tl, int g,
                             V3 q, const History& h, int& bsid) {
  const Group G = group_of(tl, g);
  float best = CULL_FAR, acc_seg = CULL_FAR;
  int prev = -1;
  bsid = -1;
  for (int j = 0; j < G.n; ++j) {
    const int e = tl.lst[G.off + j];
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
__device__ PointEval eval_point(const SceneView& sc, const TileLists& tl,
                                V3 q, const History& h) {
  PointEval r;
  r.d = pool_fold(sc, tl, q, r.win);
  r.src = 0;
  if constexpr (!ORDERED) return r;
  if (tl.has_chain) {
    const float v = chain_fold<false>(sc, tl, q, h);
    if (v < r.d) {
      r.d = v;
      r.src = 1;
    }
  }
  for (int g = 0; g < tl.n_prog; ++g) {
    if (tl.prog[4 * g + 2] != 2) continue;
    int bsid;
    const float v = stream_fold<false>(sc, tl, g, q, h, bsid);
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
// only the items of that stream segment (the others pass it on). Adds the
// leaf and op gradients (ACC) and the position cotangent to gq; returns the
// start's cotangent. The whole warp walks the group's items while any lane
// carries a cotangent (the items are the tile's, the same in every lane).
template <bool ACC>
__device__ float sweep_group(const SceneView& sc, const TileLists& tl, int g,
                             V3 q, int bsid, float cot, const History& h,
                             int op_base, const WarpRow& acc, V3& gq) {
  const Group G = group_of(tl, g);
  for (int j = G.n - 1; j >= 0 && acc.any(cot != 0.0f); --j) {
    const int e = tl.lst[G.off + j];
    const bool other = bsid >= 0 && ((e >> 15) & 7) != bsid;
    const int row = e & 1023;
    const float a = h.at(G.off + j);
    const float dv = entry_distance(sc, row, q.x, q.y, q.z);
    const float c = other ? 0.0f : cot;
    float ga, gd, gk = 0.0f;
    if (G.ordered) {
      fold_step_adj(sc, a, e, dv, c, ga, gd, gk);
    } else {
      min_adj(a, dv, c, ga, gd);
    }
    if (other) ga = cot;
    if (acc.any(gd != 0.0f)) {
      Row16 r;
      gq = add(gq, leaf_adjoint<ACC>(sc.leaf_params + row * LEAF_PARAM_WIDTH,
                                     __ldg(sc.row_kind + row), q, gd, 0, r));
      if (ACC) acc.leaf(row * LEAF_PARAM_WIDTH, gd != 0.0f, r.w);
    }
    if (ACC && G.ordered && (e >> 18) > 0 && acc.any(gk != 0.0f))
      acc.word(op_base + (e >> 18) - 1, gk != 0.0f, gk);
    cot = ga;
  }
  return cot;
}

// cot * dF/dp at q through each lane's winning source pe, the whole warp
// together; with ACC also cot * dF/dtheta into the row. An ordered source
// that any lane of the warp wins is replayed by every lane at its own q
// into the history (unless `recorded`: the same point's second sweep),
// then swept, with a zero cotangent in the lanes that do not win it. bsid
// keeps a lane's winning stream segment from its replay.
template <bool ACC, bool ORDERED>
__device__ V3 source_adjoint(const SceneView& sc, const TileLists& tl,
                             const PointEval& pe, int& bsid, bool recorded,
                             V3 q, float cot, const History& h, int op_base,
                             const WarpRow& acc) {
  V3 gq = v3(0.0f, 0.0f, 0.0f);
  const bool pool = pe.src == 0 && pe.win >= 0;
  if (acc.any(pool)) {
    Row16 r;
    if (pool)
      gq = leaf_adjoint<ACC>(sc.leaf_params + pe.win * LEAF_PARAM_WIDTH,
                             __ldg(sc.row_kind + pe.win), q, cot, 0, r);
    if (ACC)
      acc.leaf(pe.win * LEAF_PARAM_WIDTH, pool && cot != 0.0f, r.w);
  }
  if constexpr (!ORDERED) return gq;
  if (acc.any(pe.src == 1)) {
    if (!recorded) chain_fold<true>(sc, tl, q, h);
    float c = pe.src == 1 ? cot : 0.0f;
    for (int g = tl.n_prog - 1; g >= 0; --g) {
      if (tl.prog[4 * g + 2] != 1) continue;
      c = sweep_group<ACC>(sc, tl, g, q, -1, c, h, op_base, acc, gq);
    }
  }
  for (int g = 0; g < tl.n_prog; ++g) {
    if (tl.prog[4 * g + 2] != 2) continue;
    const bool mine = pe.src == 2 + g;
    if (!acc.any(mine)) continue;
    if (!recorded) {
      int b;
      stream_fold<true>(sc, tl, g, q, h, b);
      if (mine) bsid = b;
    }
    sweep_group<ACC>(sc, tl, g, q, mine ? bsid : -1, mine ? cot : 0.0f, h,
                     op_base, acc, gq);
  }
  return gq;
}

// The backward of one AA ray through its tile's compact scene (see the
// file's header), the whole warp together: leaf and op words into acc,
// camera words into gcam. gcol is zero in a lane with no work (soft:
// alpha and implicit false there too).
template <bool ORDERED, bool MATS, bool SOFT>
__device__ __forceinline__ void compact_ray(
    const SceneView& sc, const TileLists& tl, const float* __restrict__ cam,
    const RenderParams& p, float clamp, int op_base, int i, int j, int s,
    float t, float hit, float s_min, float t_min, float alpha,
    const float (&gcol)[3], const SoftRes& soft, const History& h,
    const WarpRow& acc, float (&gcam)[7]) {
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

  // --- pass 1: every source at the taps (and, painted, the hit point) ---
  const float e = p.eps;
  const V3 taps[4] = {v3(1.0f, -1.0f, -1.0f), v3(-1.0f, -1.0f, 1.0f),
                      v3(-1.0f, 1.0f, -1.0f), v3(1.0f, 1.0f, 1.0f)};
  V3 qk[4];
  PointEval ek[4];
  V3 n = v3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 4; ++k) {
    qk[k] = v3(pt.x + taps[k].x * e, pt.y + taps[k].y * e,
               pt.z + taps[k].z * e);
    ek[k] = eval_point<ORDERED>(sc, tl, qk[k], h);
    n = add(n, scale(taps[k], ek[k].d));
  }
  PointEval eh{CULL_FAR, 0, -1};
  if (MATS && implicit) eh = eval_point<ORDERED>(sc, tl, pt, h);

  // --- primal shading: normal, Lambert, the hit point's albedo -----------
  const float ninv = 1.0f / sqrtf(n.x * n.x + n.y * n.y + n.z * n.z + 1e-20f);
  const V3 tl3 = v3(pt.x - p.light[0], pt.y - p.light[1], pt.z - p.light[2]);
  const float linv =
      1.0f / sqrtf(tl3.x * tl3.x + tl3.y * tl3.y + tl3.z * tl3.z + 1e-20f);
  const float dotv = dot(n, tl3);
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
  const V3 gn = add(scale(tl3, gdot), scale(n, 2.0f * gN2));
  V3 gp = add(scale(n, gdot), scale(tl3, 2.0f * gL2));  // through the light
  for (int k = 0; k < 4; ++k) {
    int bsid = -1;
    gp = add(gp, source_adjoint<true, ORDERED>(sc, tl, ek[k], bsid, false,
                                               qk[k], dot(taps[k], gn), h,
                                               op_base, acc));
  }
  const float gt = dot(gp, d);
  V3 go = gp;
  V3 gd = live ? scale(gp, te) : v3(0.0f, 0.0f, 0.0f);

  // --- implicit-function term at the hit point: one record, two sweeps ---
  if (acc.any(implicit)) {
    if (!MATS) eh = eval_point<ORDERED>(sc, tl, pt, h);
    int bsid = -1;
    const V3 gradF = source_adjoint<false, ORDERED>(
        sc, tl, eh, bsid, false, pt, implicit ? 1.0f : 0.0f, h, op_base, acc);
    const float fdot = dot(gradF, d);
    const float denom =
        fabsf(fdot) > clamp ? fdot : (fdot >= 0.0f ? clamp : -clamp);
    const float w = implicit ? -gt / denom : 0.0f;
    const V3 gq = source_adjoint<true, ORDERED>(sc, tl, eh, bsid, true, pt, w,
                                                h, op_base, acc);
    go = add(go, gq);
    gd = add(gd, scale(gq, t));
  }

  // --- envelope sweep at the frozen closest approach (soft) --------------
  if constexpr (SOFT) {
    if (acc.any(gsm != 0.0f)) {
      const V3 pe = v3(r.ox + r.dx * t_min, r.oy + r.dy * t_min,
                       r.oz + r.dz * t_min);
      const PointEval ee = eval_point<ORDERED>(sc, tl, pe, h);
      int bsid = -1;
      const V3 gq = source_adjoint<true, ORDERED>(sc, tl, ee, bsid, false, pe,
                                                  gsm, h, op_base, acc);
      go = add(go, gq);
      gd = add(gd, scale(gq, t_min));
    }
  }

  // --- the winner's albedo and flag words (painted pools) ----------------
  if (MATS && acc.any(painted)) {
    Row16 rw;
    if (painted) {
      const float* P = sc.leaf_params + eh.win * LEAF_PARAM_WIDTH;
      const float fl = __ldg(P + LEAF_MAT_FLAG);
      float gfl = 0.0f;
      for (int c = 0; c < 3; ++c) {
        rw(LEAF_ALBEDO + c, fl * galb[c]);
        gfl += (__ldg(P + LEAF_ALBEDO + c) - p.albedo[c]) * galb[c];
      }
      rw(LEAF_MAT_FLAG, gfl);
    }
    acc.leaf(eh.win * LEAF_PARAM_WIDTH, painted, rw.w);
  }

  // --- camera: o = cam[0:3], d = rotate(cam[3:7], vn) --------------------
  const float qw = __ldg(cam + 3);
  const V3 qu = v3(__ldg(cam + 4), __ldg(cam + 5), __ldg(cam + 6));
  V3 gvn, gu;
  float gw;
  qrot_adj(qw, qu, vn, gd, gvn, gw, gu);
  gcam[0] += go.x;
  gcam[1] += go.y;
  gcam[2] += go.z;
  gcam[3] += gw;
  gcam[4] += gu.x;
  gcam[5] += gu.y;
  gcam[6] += gu.z;
}

// The routes of one launch (ops/cuda_grad.py compact_bwd chooses): where
// the row, the history and the tile's lists sit.
struct CompactShape {
  int nscal, op_base, cam_base;
  int hist_off, hist_len;
  int row_smem;    // 1: the block's row in shared memory; 0: the output
  int hist_smem;   // 1: the history in shared memory; 0: in hist
  int stage;       // 1: each tile's counts and active lists staged
};

// Blocks take fine tiles from the queue *tile_next (zeroed by the
// launcher) until none is left; see the file's header. ORDERED: the plan
// has a seg1 chain or stream groups (else the pool is its only source, and
// the build carries no replay or sweep); MATS: the scene is painted; SOFT:
// soft coverage, with the residuals at soft.
template <bool ORDERED, bool MATS, bool SOFT>
__global__ void compact_bwd_kernel(SceneView sc, CullView cv,
                                   const float* __restrict__ cam,
                                   RenderParams p, float clamp,
                                   const float* __restrict__ t_in,
                                   const float* __restrict__ hit_in,
                                   const float* __restrict__ g_img,
                                   CompactShape sh, float* hist,
                                   float* row_out, int* tile_next,
                                   float* __restrict__ partials, SoftRes soft) {
  extern __shared__ float smem[];
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int row_floats = sh.row_smem ? sh.nscal : 0;
  float* s_hist = smem + row_floats;
  int* s_prog = reinterpret_cast<int*>(s_hist + (sh.hist_smem ? sh.hist_len * T : 0));
  int* s_cnt = s_prog + 4 * cv.n_prog;
  int* s_lst = s_cnt + cv.n_counts;
  for (int k = tid; k < row_floats; k += T) smem[k] = 0.0f;
  TileLists tl{nullptr, nullptr, cv.prog, cv.n_prog, false};
  if (sh.stage) {
    for (int k = tid; k < 4 * cv.n_prog; k += T) s_prog[k] = cv.prog[k];
    tl.prog = s_prog;
  }
  for (int g = 0; g < cv.n_prog; ++g)
    tl.has_chain = tl.has_chain || __ldg(cv.prog + 4 * g + 2) == 1;
  const WarpRow acc{row_out ? row_out : smem};
  const long long me = (long long)blockIdx.x * T + tid;
  const History h = sh.hist_smem
                        ? History{s_hist + tid, T, sh.hist_off}
                        : History{hist + me, (long long)gridDim.x * T, sh.hist_off};

  float gcam[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int S = p.naa * p.naa;
  const int side = cv.tile;
  const int n_tiles = ((p.rows + side - 1) / side) * cv.n_tx;
  const int tile_rays = side * side * S;
  const int lane = tid & 31;
  for (;;) {
    __syncthreads();  // the last tile's lists are no longer read
    if (tid == 0) s_tile = atomicAdd(tile_next, 1);
    __syncthreads();
    const int tile = s_tile;
    if (tile >= n_tiles) break;
    const int* lst = cv.lists + (size_t)tile * cv.n_items;
    const int* cnt = cv.counts + (size_t)tile * cv.n_counts;
    if (sh.stage) {
      for (int k = tid; k < cv.n_counts; k += T) s_cnt[k] = cnt[k];
      __syncthreads();
      for (int g = 0; g < cv.n_prog; ++g) {
        const int off = s_prog[4 * g + 0], n = s_cnt[s_prog[4 * g + 1]];
        for (int k = tid; k < n; k += T) s_lst[off + k] = lst[off + k];
      }
      __syncthreads();
      tl.lst = s_lst;
      tl.cnt = s_cnt;
    } else {
      tl.lst = lst;
      tl.cnt = cnt;
    }
    const int ty = tile / cv.n_tx, tx = tile - ty * cv.n_tx;
    for (int r0 = tid - lane; r0 < tile_rays; r0 += T) {
      const int rr = r0 + lane;
      const int pi = rr / (side * S);
      const int rem = rr - pi * side * S;
      const int pj = rem / S;
      const int s = rem - pj * S;
      const bool valid = ty * side + pi < p.rows && tx * side + pj < p.width;
      // An edge tile's lanes past the band read a valid ray and do no work.
      const int i = valid ? ty * side + pi : 0;
      const int j = valid ? tx * side + pj : 0;
      const long long gl = ((long long)i * p.width + j) * S + s;
      const float hit = __ldg(hit_in + gl);
      float s_min = 0.0f, t_min = 0.0f, alpha = 1.0f;
      bool work;
      if constexpr (SOFT) {
        s_min = __ldg(soft.s_min + gl);
        t_min = __ldg(soft.t_min + gl);
        alpha = soft_alpha(s_min, p.min_dist, soft.beta_inv);
        work = valid && soft_work(hit, alpha, soft.gate);
      } else {
        work = valid && hit > 0.0f;
      }
      if (!__any_sync(FULL_MASK, work)) continue;
      const float* gi = g_img + ((size_t)i * p.width + j) * 3;
      const float sc_ = work ? p.inv_s : 0.0f;
      const float gcol[3] = {__ldg(gi + 0) * sc_, __ldg(gi + 1) * sc_,
                             __ldg(gi + 2) * sc_};
      compact_ray<ORDERED, MATS, SOFT>(sc, tl, cam, p, clamp, sh.op_base, i, j,
                                       s, __ldg(t_in + gl),
                                       work ? hit : 0.0f, s_min, t_min, alpha,
                                       gcol, soft, h, acc, gcam);
    }
  }
  acc.camera(sh.cam_base, gcam);
  if (row_out) return;
  __syncthreads();
  for (int k = tid; k < sh.nscal; k += T)
    partials[(size_t)blockIdx.x * sh.nscal + k] = smem[k];
}

// Launches one instantiation of compact_bwd_kernel on as many blocks as
// the card keeps resident (at most max_blocks).
template <bool ORDERED, bool MATS, bool SOFT>
cudaError_t launch_compact_bwd(const SceneView& sc, const CullView& cv,
                               const float* cam, const RenderParams& p,
                               float clamp, const float* t_in,
                               const float* hit_in, const float* g_img,
                               const CompactShape& sh, float* hist,
                               float* out, int* tile_next, float* partials,
                               int max_blocks, int* n_blocks,
                               const SoftRes& soft, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(sh.row_smem ? sh.nscal : 0) +
       (sh.hist_smem ? (size_t)sh.hist_len * CBWD_THREADS : 0) +
       (sh.stage ? (size_t)4 * cv.n_prog + cv.n_counts + cv.n_items : 0)) *
      4;
  long long grid = 0;
  const cudaError_t err = launch_resident(
      compact_bwd_kernel<ORDERED, MATS, SOFT>, CBWD_THREADS, smem, p,
      max_blocks, stream, &grid, sc, cv, cam, p, clamp, t_in, hit_in, g_img,
      sh, sh.hist_smem ? nullptr : hist, sh.row_smem ? nullptr : out,
      tile_next, partials, soft);
  *n_blocks = (int)grid;
  return err;
}

}  // namespace rmt

extern "C" {

// Launches compact_bwd_kernel. shape: nscal, op_base, cam_base, hist_off,
// hist_len, row_smem, hist_smem, stage (CompactShape). The block rows go to
// partials (max_blocks * nscal floats) when row_smem, and *n_blocks gets
// the number of blocks launched (the caller sums the rows with
// rmt_bwd_finalize_launch); else the launcher zeroes out f32[nscal] and the
// kernel adds into it. hist holds max_blocks * CBWD_THREADS * hist_len
// floats when the history is not in shared memory; tile_next is one int of
// scratch. mats != 0 routes the albedo of a painted pool; a soft argument
// with non-null residuals (s_min, t_min) runs the soft build (never with
// mats). Returns the first failing cudaError_t (0 = success).
int rmt_compact_bwd_launch(const float* leaf_params, const int* row_kind,
                           const int* tape, int n_instr, const float* op_param,
                           const rmt::CullView* cull, const float* cam,
                           const rmt::RenderParams* params, float clamp,
                           const float* t_in, const float* hit_in,
                           const float* g_img, const int* shape, int mats,
                           const rmt::SoftRes* soft, float* hist,
                           int* tile_next, float* partials, int max_blocks,
                           int* n_blocks, float* out, void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  const rmt::CompactShape sh{shape[0], shape[1], shape[2], shape[3],
                             shape[4], shape[5], shape[6], shape[7]};
  cudaStream_t st = (cudaStream_t)stream;
  const rmt::SoftRes sr = *soft;
  const bool is_soft = sr.s_min != nullptr;
  if (is_soft != (sr.t_min != nullptr) || (is_soft && mats != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(tile_next, 0, sizeof(int), st);
  if (err == cudaSuccess && !sh.row_smem)
    err = cudaMemsetAsync(out, 0, (size_t)sh.nscal * 4, st);
  if (err != cudaSuccess) return (int)err;
  *n_blocks = 0;
#define RMT_CBWD(ORDERED, MATS, SOFT)                                          \
  rmt::launch_compact_bwd<ORDERED, MATS, SOFT>(                                \
      sc, *cull, cam, p, clamp, t_in, hit_in, g_img, sh, hist, out, tile_next, \
      partials, max_blocks, n_blocks, sr, st)
  switch ((is_soft ? 4 : 0) + (sh.hist_len > 0 ? 2 : 0) + (mats != 0 ? 1 : 0)) {
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
