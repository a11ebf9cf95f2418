// The unpacked fine pass K4: the device code that the K4 sources
// (_build.py K4_SOURCES, one MODE each) instantiate; fine_unpacked.cu's
// header describes the kernel.
#pragma once

#include <type_traits>

#include <cuda_runtime.h>

#include "fine.cuh"
#include "render_common.cuh"
#include "scene_eval.cuh"

namespace rmt {

// A block holds whole pixels of a row, floor(UNPACKED_THREADS / lanes) of
// them (march.cuh pixel_threads), or one pixel whose lanes walk several
// samples each; a pixel takes at most UNPACKED_MAX_LANES lanes, so a block
// has at most 128 threads.
constexpr int UNPACKED_THREADS = 128;
constexpr int UNPACKED_MAX_LANES = 128;

// Blocks an SM keeps of a build, the launch bound: 7 (at most 72
// registers a thread) where that leaves no spill; the compact item lists'
// builds (MODE 1) and the relaxed builds with materials need 80-91
// registers, and take 5. Measured on the H100 (PERF.md §6): K4 at 16
// AA 1.047 -> 0.961 ms from 75 registers to 72; 8 blocks (64 registers)
// spilled in 97 of 114 builds.
__host__ __device__ constexpr int unpacked_min_blocks(int mode, bool mats,
                                                      bool relax) {
  return mode == 1 || (mats && relax) ? 5 : 7;
}
// The opt-in shared memory of a block on the H100.
constexpr size_t UNPACKED_SMEM_MAX = 227 * 1024;

// The lane map of S samples a pixel with at most max_lanes lanes a pixel;
// mirrored by ops/cuda_prepass.py:unpacked_shape.
struct PixelLanes {
  int lanes;   // lanes a pixel: ceil(S / k), k = ceil(S / max_lanes)
  int rounds;  // samples a lane: ceil(S / lanes); lane l takes l, l + lanes, ...
  int pixels;  // pixels a block
  int shared;  // cfg.aa_shared_normals
};

__host__ __device__ inline PixelLanes pixel_lanes(int S, int max_lanes,
                                                  int shared) {
  const int k = (S + max_lanes - 1) / max_lanes;
  PixelLanes u;
  u.lanes = (S + k - 1) / k;
  u.rounds = (S + u.lanes - 1) / u.lanes;
  // A pixel of several rounds takes a block alone.
  u.pixels = u.rounds > 1 || u.lanes >= UNPACKED_THREADS ? 1 : UNPACKED_THREADS / u.lanes;
  u.shared = shared;
  return u;
}

// Dynamic shared memory of a block after the stack's columns: the colour
// of each of its pixels' samples (3 floats a sample, channel-major), and a
// pixel's first-hit slot, the hit point of that sample and its four taps.
__host__ __device__ inline size_t unpacked_exchange_bytes(const PixelLanes& u,
                                                          int S) {
  return ((size_t)3 * u.pixels * S + (size_t)8 * u.pixels) * sizeof(float);
}

// Tetrahedron tap k of tet_normal (fine.cuh) at (px, py, pz): k in
// {(+,-,-), (-,-,+), (-,+,-), (+,+,+)}.
__device__ __forceinline__ void tap_signs(int k, float& sx, float& sy,
                                          float& sz) {
  sx = (k == 0 || k == 3) ? 1.0f : -1.0f;
  sy = k >= 2 ? 1.0f : -1.0f;
  sz = (k == 1 || k == 3) ? 1.0f : -1.0f;
}
template <class Scene>
__device__ __forceinline__ float tap(const Scene& scene, float e, int k,
                                     float px, float py, float pz) {
  float sx, sy, sz;
  tap_signs(k, sx, sy, sz);
  return scene(px + sx * e, py + sy * e, pz + sz * e);
}
// The four taps' sum in tet_normal's order.
__device__ __forceinline__ void tap_sum(const float (&d)[4], float& nx,
                                        float& ny, float& nz) {
  nx = 0.0f;
  ny = 0.0f;
  nz = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float sx, sy, sz;
    tap_signs(k, sx, sy, sz);
    nx = nx + sx * d[k];
    ny = ny + sy * d[k];
    nz = nz + sz * d[k];
  }
}

// Thread q of a block is lane l = q % lanes of the block's pixel q / lanes
// (band row i = blockIdx.y, column j); the lane takes AA samples
// s = l, l + lanes, ... in rounds (one round unless S > max_lanes). Writes
// the image f32[rows, width, 3] and, when t_out is not null, the residuals
// t and hit f32[rows, width, S]. Every thread reaches every barrier and
// shuffle, past the row's end too.
template <int MODE, bool RELAX, bool MATS, int PRE, int STK>
__global__ void __launch_bounds__(UNPACKED_THREADS,
                                  unpacked_min_blocks(MODE, MATS, RELAX))
    fine_unpacked_kernel(SceneWords sw, const float* __restrict__ cam,
                         const float* __restrict__ bound, RenderParams p,
                         CullView cv, const float* __restrict__ t0_in,
                         const float* __restrict__ status_in,
                         float* __restrict__ img, float* __restrict__ t_out,
                         float* __restrict__ hit_out, BlockParams bp,
                         PixelLanes u) {
  const int S = p.naa * p.naa;
  const int L = u.lanes;
  const int pl = threadIdx.x / L;
  const int l = threadIdx.x - pl * L;
  const int i = blockIdx.y;
  const int j = blockIdx.x * u.pixels + pl;
  const bool valid = j < p.width;
  const int tile = mode_culled(MODE) && valid ? tile_of(cv, i, j) : 0;
  const WordScene<MODE, STK> scene{sw, cv, tile};
  // A pixel's lanes lie in one warp: its first hit and its taps go by
  // ballot and shuffles; else through its slots in shared memory.
  const bool in_warp = 32 % L == 0;
  const int base = (threadIdx.x & 31) - l;  // in_warp: the pixel's first lane

  extern __shared__ float rmt_stack[];
  float* sums = rmt_stack + stack_smem_bytes<MATS, STK>(sw, blockDim.x) /
                                sizeof(float);
  const int slots = u.pixels * S;
  int* first = reinterpret_cast<int*>(sums + 3 * slots);  // [pixels]
  float* hp = sums + 3 * slots + u.pixels;                // [pixels][3]
  float* taps = hp + 3 * u.pixels;                        // [pixels][4]
  if (u.shared && !in_warp) {
    if (l == 0) first[pl] = L;
    __syncthreads();
  }

  float nx = 0.0f, ny = 0.0f, nz = 0.0f;  // the pixel's shared normal
  bool have_normal = false;
  for (int rd = 0; rd < u.rounds; ++rd) {
    const int s = rd * L + l;
    const bool live_lane = valid && s < S;
    Ray r{};
    float t = 0.0f, hit = 0.0f;
    if (live_lane) {
      float x, y;
      aa_screen_xy(cam, p, i, j, s, x, y);
      r = view_ray(cam, p, x, y);
      // The pixel's prepass: the same for all of its samples, at its
      // block (i / B, j / B); B = 1 for pixel planes (and after the
      // chained pass), without a division.
      const int pb = PRE == 1 && bp.chain ? 1 : bp.block;
      const int pcols = PRE == 1 && bp.chain ? p.width : bp.bcols;
      const size_t po = pb <= 1 ? (size_t)i * pcols + j : (size_t)(i / pb) * pcols + j / pb;
      float live = 1.0f;
      if constexpr (PRE == 2 || PRE == 4) {
        // A ray lives iff its block has a first interval, and starts there
        // (pallas_prepass.py:1118-1122).
        const float s0 = t0_in[po];
        live = s0 < FAR_TEST ? 1.0f : 0.0f;
        t = live > 0.0f ? s0 : 0.0f;
      } else if (!p.no_prepass) {
        t = t0_in[po];
        live = status_in[po];
      }
      float t_cap = FAR_T;
      if (p.use_bound) {
        // Only the exit cap matters: the start comes from the prepass.
        float l_unused = live, t_unused = t;
        bound_clip(bound, r, p.min_dist, l_unused, t_unused, t_cap);
      }
      if constexpr (PRE == 2 || PRE == 4) {
        // The block's intervals, FAR_T past the last: in registers, or
        // (more than MAX_NI) read in place.
        std::conditional_t<PRE == 2, ShiftIntervals, PlaneIntervals> planes;
        planes.load(t0_in, (size_t)bp.brows * bp.bcols, po, bp.ni);
        hit = interval_march<RELAX>(scene, r, p, live, t, t_cap, planes);
      } else {
        hit = legacy_march<RELAX>(scene, r, p, live, t, t_cap);
      }
      if (t_out != nullptr) {
        const size_t ri = ((size_t)i * p.width + j) * S + s;
        t_out[ri] = t;
        hit_out[ri] = hit;
      }
    }
    const float px = r.ox + r.dx * t;
    const float py = r.oy + r.dy * t;
    const float pz = r.oz + r.dz * t;

    float mx = 0.0f, my = 0.0f, mz = 0.0f;  // the normal this sample shades with
    if (u.shared) {
      // The first sample in sample order that hits takes the taps at its
      // own hit point (this round's first hitting lane, while the pixel has
      // no normal); later hitting samples reuse its normal. Lane k < 4 of
      // the pixel takes tap k at that point, and every lane sums the four
      // in tet_normal's order: the normal a single lane's taps give, bit
      // for bit, at one warp evaluation instead of four.
      const bool hits = live_lane && hit > 0.0f;
      if (in_warp) {
        const unsigned ball = __ballot_sync(0xffffffffu, hits);
        const unsigned grp =
            L == 32 ? ball : (ball >> base) & ((1u << L) - 1u);
        const bool tapping = !have_normal && grp != 0u;
        if (__any_sync(0xffffffffu, tapping)) {
          const int src = base + (grp ? __ffs(grp) - 1 : 0);
          const float hx = __shfl_sync(0xffffffffu, px, src);
          const float hy = __shfl_sync(0xffffffffu, py, src);
          const float hz = __shfl_sync(0xffffffffu, pz, src);
          if (L >= 4) {
            const float d = tapping && l < 4 ? tap(scene, p.eps, l, hx, hy, hz) : 0.0f;
            float dk[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) dk[k] = __shfl_sync(0xffffffffu, d, base + k);
            if (tapping) tap_sum(dk, nx, ny, nz);
          } else if (tapping) {  // one sample a pixel: its lane takes the taps
            tet_normal(scene, p.eps, hx, hy, hz, nx, ny, nz);
          }
          have_normal = have_normal || tapping;
        }
      } else {
        // A pixel over several warps (at least 4 lanes: the launcher
        // checks): its first hit, hit point and taps through its slots in
        // shared memory.
        if (hits) atomicMin(first + pl, l);
        __syncthreads();
        const int f = first[pl];
        const bool tapping = !have_normal && f < L;
        if (tapping && l == f) {
          hp[3 * pl + 0] = px;
          hp[3 * pl + 1] = py;
          hp[3 * pl + 2] = pz;
        }
        __syncthreads();
        if (l == 0) first[pl] = L;  // every read of the slot came before
        if (tapping && l < 4)
          taps[4 * pl + l] = tap(scene, p.eps, l, hp[3 * pl], hp[3 * pl + 1], hp[3 * pl + 2]);
        __syncthreads();
        if (tapping) {
          float dk[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) dk[k] = taps[4 * pl + k];
          tap_sum(dk, nx, ny, nz);
          have_normal = true;
        }
      }
      mx = nx;
      my = ny;
      mz = nz;
    } else if (live_lane && hit > 0.0f) {
      tet_normal(scene, p.eps, px, py, pz, mx, my, mz);
    }

    if (live_lane) {
      float diff = 0.0f;
      float alb[3] = {p.albedo[0], p.albedo[1], p.albedo[2]};
      if (hit > 0.0f) diff = lambert<MATS>(scene, p, px, py, pz, mx, my, mz, alb);
      float fc[3];
      floor_colour(r, p, fc);
      const float miss = 1.0f - hit;
      const int o = pl * S + s;
      sums[o] = sqrtf(fmaxf(hit * (alb[0] * diff) + miss * fc[0], 0.0f) + 1e-12f);
      sums[slots + o] = sqrtf(fmaxf(hit * (alb[1] * diff) + miss * fc[1], 0.0f) + 1e-12f);
      sums[2 * slots + o] = sqrtf(fmaxf(hit * (alb[2] * diff) + miss * fc[2], 0.0f) + 1e-12f);
    }
  }

  // The AA mean in sample order (the reference's accumulator: r_ref +=
  // cr, then * (1/S)): lane c < 3 of the pixel sums channel c of its
  // samples' colours (lane 0 all three where the pixel has one lane).
  if (in_warp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  if (valid) {
    for (int ch = l; ch < 3; ch += L) {
      const float* c = sums + ch * slots + pl * S;
      float a = c[0];
      for (int k = 1; k < S; ++k) a = a + c[k];
      img[((size_t)i * p.width + j) * 3 + ch] = a * p.inv_s;
    }
  }
}

// K4's launch, dispatched to its build by template flags: the prepass
// planes `pre` (1 pixel or block planes, or none; 2 at most MAX_NI
// intervals; 4 more) and the stack route stk (STK).
struct UnpackedLaunch {
  dim3 grid;
  int threads;
  cudaStream_t st;
  SceneWords sw;
  int stk;
  const float *cam, *bound;
  RenderParams p;
  CullView cv;
  const float *t0_in, *status_in;
  float *img, *t_out, *hit_out;
  BlockParams bp;
  PixelLanes u;

  template <int MODE, bool RELAX, bool MATS, int PRE, int STK>
  cudaError_t go() const {
    const auto k = fine_unpacked_kernel<MODE, RELAX, MATS, PRE, STK>;
    const size_t smem = stack_smem_bytes<MATS, STK>(sw, threads) +
                        unpacked_exchange_bytes(u, p.naa * p.naa);
    if (smem > UNPACKED_SMEM_MAX) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    k<<<grid, threads, smem, st>>>(sw, cam, bound, p, cv, t0_in, status_in,
                                   img, t_out, hit_out, bp, u);
    return cudaGetLastError();
  }
  template <int MODE, bool RELAX, bool MATS, int PRE>
  cudaError_t route() const {
    if constexpr (!uses_stack(MODE, MATS)) {
      return go<MODE, RELAX, MATS, PRE, REG_STACK>();
    } else {
      if (stk == REG_STACK) return go<MODE, RELAX, MATS, PRE, REG_STACK>();
      return go<MODE, RELAX, MATS, PRE, STK_SMEM>();
    }
  }
  template <int MODE, bool RELAX, bool MATS>
  cudaError_t pre(int pre_) const {
    if (pre_ == 4) return route<MODE, RELAX, MATS, 4>();
    if (pre_ == 2) return route<MODE, RELAX, MATS, 2>();
    return route<MODE, RELAX, MATS, 1>();
  }
  template <int MODE>
  cudaError_t flags(bool relax, bool mats, int pre_) const {
    if (relax) return mats ? pre<MODE, true, true>(pre_) : pre<MODE, true, false>(pre_);
    return mats ? pre<MODE, false, true>(pre_) : pre<MODE, false, false>(pre_);
  }
};

// The builds of culling mode MODE (0-2 static, 3-4 DYN), one source each
// (_build.py K4_SOURCES) so that nvcc compiles them in parallel:
// fine_unpacked.cu (MODE 0, and the C interface), fine_unpacked_lists.cu
// (1), fine_unpacked_gated.cu (2), fine_unpacked_dyn.cu (3),
// fine_unpacked_dyn_gated.cu (4).
template <int MODE>
cudaError_t launch_unpacked(const UnpackedLaunch& L, bool relax, bool mats,
                            int pre) {
  return L.flags<MODE>(relax, mats, pre);
}
#define RMT_UNPACKED_MODE(M)                                       \
  extern template cudaError_t launch_unpacked<M>(const UnpackedLaunch&, \
                                                 bool, bool, int);
RMT_UNPACKED_MODE(0)
RMT_UNPACKED_MODE(1)
RMT_UNPACKED_MODE(2)
RMT_UNPACKED_MODE(3)
RMT_UNPACKED_MODE(4)
#undef RMT_UNPACKED_MODE

}  // namespace rmt
