// The compact O(active) backward of the fused render for pool-only compact
// plans: the gradient of sum(img * g_img) with respect to the leaf bank, the
// op words and the camera, from the forward's per-ray residuals (t, hit) and
// the fine kernel's per-tile item lists. Plain C interface for ctypes.
//
// compact_bwd_kernel replaces raymarch_tpu/ops/pallas_grad.py:
// _make_compact_bwd.bwd_kernel (256, launched at 1181) for plans whose only
// source is the free pool: hard unions of any leaf types, rotated or not.
// There the scene is d = min over the tile's active leaves, and its
// transpose is winner-masked: every evaluation point's cotangent goes to the
// one leaf that wins the fold (strict <, in list order, as pool_fold does at
// 391-420). Per AA ray that hit, with g the pixel's cotangent over S:
//   1. rebuild the ray from cam (the kernel's own raygen, 225-241) and the
//      hit point p = o + d t;
//   2. fold the tile's list at the 4 tetrahedron taps and at p, keeping
//      each point's value and winner row;
//   3. run the shading adjoint (as fused_bwd.cu does): tap k's value gets
//      k . g_n and goes through the winner's leaf adjoint at p + eps k; the
//      light vector adds g_p; g_t = g_p . d; the implicit-function term
//      fdot = grad_x d_win(p) . d, clamped to +-grad_denom_clamp,
//      w = -g_t / fdot, and one more winner-leaf adjoint at p with seed w;
//   4. the camera gets g_p through o and through d t.
// A ray that missed contributes exactly zero and returns at once. The leaf
// adjoints are those of scene_grad.cuh (all 7 types, quaternions).
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
// What bounds it on an H100: instruction issue in the list folds (5 points
// x the tile's active leaves per hit ray) and the leaf adjoints (6 per hit
// ray), and the shared atomics of the winner rows; it reads 8 bytes of
// residuals and 12 of cotangent per ray and writes one row per block.
#include <cuda_runtime.h>

#include "render_common.cuh"
#include "scene_grad.cuh"

namespace rmt {

constexpr int CBWD_THREADS = 128;

// Adds to the block's partial row in shared memory.
struct BlockAcc {
  float* row;
  __device__ __forceinline__ void operator()(int k, float v) const {
    atomicAdd(row + k, v);
  }
};

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
    const int off = __ldg(cv.prog + 4 * g + 0);
    const int n = __ldg(cnt + __ldg(cv.prog + 4 * g + 1));
    for (int j = 0; j < n; ++j) {
      const int row = __ldg(lst + off + j);
      const float dv = entry_distance(sc, row, q.x, q.y, q.z);
      if (dv < d) {
        d = dv;
        win = row;
      }
    }
  }
  return d;
}

template <bool ACC>
__device__ __forceinline__ V3 winner_adjoint(const SceneView& sc, int win,
                                             V3 q, float g, BlockAcc& acc) {
  if (win < 0) return v3(0.0f, 0.0f, 0.0f);
  return leaf_adjoint<ACC>(sc.leaf_params + win * LEAF_PARAM_WIDTH,
                           __ldg(sc.row_kind + win), q, g,
                           win * LEAF_PARAM_WIDTH, acc);
}

// Grid-stride over the AA rays of the band, in the fine kernel's lane order
// (row i, then q = j * S + s). Writes one partial row of nscal words per
// block.
__global__ void compact_bwd_kernel(SceneView sc, CullView cv,
                                   const float* __restrict__ cam,
                                   RenderParams p, float clamp,
                                   const float* __restrict__ t_in,
                                   const float* __restrict__ hit_in,
                                   const float* __restrict__ g_img, int nscal,
                                   int cam_base, float* __restrict__ partials) {
  extern __shared__ float acc_s[];
  for (int k = threadIdx.x; k < nscal; k += blockDim.x) acc_s[k] = 0.0f;
  __syncthreads();
  BlockAcc acc{acc_s};

  const int S = p.naa * p.naa;
  const long long row_lanes = (long long)p.width * S;
  const long long total = row_lanes * p.rows;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long gl = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gl < total; gl += step) {
    if (!(__ldg(hit_in + gl) > 0.0f)) continue;
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
    const int a_ = s / p.naa;
    const int b_ = s - a_ * p.naa;
    const float fa = ((float)a_ + 0.5f) / (float)p.naa - 0.5f;
    const float fb = ((float)b_ + 0.5f) / (float)p.naa - 0.5f;
    const float x =
        2.0f * ((float)j + 0.5f) / (float)p.width - 1.0f + fa * p.c2w;
    const float y =
        1.0f - 2.0f * ((float)i + 0.5f + __ldg(cam + 7)) / (float)p.height +
        fb * p.c2h;
    float vx = x * p.tan_aspect;
    float vy = y * p.tanf;
    float vz = -1.0f;
    const float inv_norm = 1.0f / sqrtf(vx * vx + vy * vy + vz * vz);
    const V3 vn = v3(vx * inv_norm, vy * inv_norm, vz * inv_norm);
    const Ray r = view_ray(cam, p, x, y);
    const V3 d = v3(r.dx, r.dy, r.dz);
    const V3 pt = v3(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t);

    // --- primal: taps through the tile's list, normal, Lambert -------------
    const float e = p.eps;
    const V3 taps[4] = {v3(1.0f, -1.0f, -1.0f), v3(-1.0f, -1.0f, 1.0f),
                        v3(-1.0f, 1.0f, -1.0f), v3(1.0f, 1.0f, 1.0f)};
    V3 qk[4];
    int wk[4];
    V3 n = v3(0.0f, 0.0f, 0.0f);
    for (int k = 0; k < 4; ++k) {
      qk[k] = v3(pt.x + taps[k].x * e, pt.y + taps[k].y * e,
                 pt.z + taps[k].z * e);
      const float dv = pool_fold(sc, cv, tile, qk[k], wk[k]);
      n = add(n, scale(taps[k], dv));
    }
    const float ninv =
        1.0f / sqrtf(n.x * n.x + n.y * n.y + n.z * n.z + 1e-20f);
    const V3 tl = v3(pt.x - p.light[0], pt.y - p.light[1], pt.z - p.light[2]);
    const float linv =
        1.0f / sqrtf(tl.x * tl.x + tl.y * tl.y + tl.z * tl.z + 1e-20f);
    const float dotv = dot(n, tl);
    const float sn = ninv * linv;
    const float diff0 = dotv * sn;
    const float diff = fmaxf(diff0, p.ambient);

    // --- adjoint of the shading --------------------------------------------
    float gdiff = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float v = p.albedo[c] * diff;
      const float col = sqrtf(fmaxf(v, 0.0f) + 1e-12f);
      float gv, unused;
      max_adj(v, 0.0f, gcol[c] * 0.5f / col, gv, unused);
      gdiff += gv * p.albedo[c];
    }
    float gdiff0, gamb;
    max_adj(diff0, p.ambient, gdiff, gdiff0, gamb);
    const float gdot = gdiff0 * sn;
    const float gsn = gdiff0 * dotv;
    const float gN2 = -0.5f * ninv * ninv * ninv * (gsn * linv);
    const float gL2 = -0.5f * linv * linv * linv * (gsn * ninv);
    const V3 gn = add(scale(tl, gdot), scale(n, 2.0f * gN2));
    V3 gp = add(scale(n, gdot), scale(tl, 2.0f * gL2));  // through the light
    for (int k = 0; k < 4; ++k)
      gp = add(gp, winner_adjoint<true>(sc, wk[k], qk[k], dot(taps[k], gn),
                                        acc));
    const float gt = dot(gp, d);
    V3 go = gp;
    V3 gd = scale(gp, t);

    // --- implicit-function term at the hit point ---------------------------
    int wh;
    pool_fold(sc, cv, tile, pt, wh);
    const V3 gradF = winner_adjoint<false>(sc, wh, pt, 1.0f, acc);
    const float fdot = dot(gradF, d);
    const float denom =
        fabsf(fdot) > clamp ? fdot : (fdot >= 0.0f ? clamp : -clamp);
    const float w = -gt / denom;
    const V3 gq = winner_adjoint<true>(sc, wh, pt, w, acc);
    go = add(go, gq);
    gd = add(gd, scale(gq, t));

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

}  // namespace rmt

extern "C" {

// Launches compact_bwd_kernel into partials (max_blocks * nscal floats) and
// writes the number of blocks launched to *n_blocks; the caller sums the
// rows with rmt_bwd_finalize_launch. Returns the first failing cudaError_t
// (0 = success).
int rmt_compact_bwd_launch(const float* leaf_params, const int* row_kind,
                           const int* tape, int n_instr, const float* op_param,
                           const rmt::CullView* cull, const float* cam,
                           const rmt::RenderParams* params, float clamp,
                           const float* t_in, const float* hit_in,
                           const float* g_img, int nscal, int cam_base,
                           float* partials, int max_blocks, int* n_blocks,
                           void* stream) {
  const rmt::RenderParams p = *params;
  const rmt::SceneView sc = rmt::make_scene(leaf_params, row_kind, tape,
                                            n_instr, op_param, p.max_dist);
  const int threads = rmt::CBWD_THREADS;
  const size_t smem = (size_t)nscal * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rmt::compact_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, rmt::compact_bwd_kernel, threads, smem)) != cudaSuccess)
    return (int)err;
  const long long total = (long long)p.width * p.naa * p.naa * p.rows;
  const long long chunks = (total + threads - 1) / threads;
  long long grid = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  if (grid > max_blocks) grid = max_blocks;
  if (grid > chunks) grid = chunks;
  if (grid < 1) grid = 1;
  rmt::compact_bwd_kernel<<<(unsigned)grid, threads, smem,
                            (cudaStream_t)stream>>>(
      sc, *cull, cam, p, clamp, t_in, hit_in, g_img, nscal, cam_base,
      partials);
  *n_blocks = (int)grid;
  return (int)cudaGetLastError();
}

}  // extern "C"
