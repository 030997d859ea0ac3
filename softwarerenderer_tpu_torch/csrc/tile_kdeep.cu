// Single-pass K-deep tile kernel: the K best fragments of every pixel in
// one fold, then each layer's winner resolved and interpolated.
//
// Replaces softwarerenderer_tpu/ops/pallas_tile.py:_kernel_kdeep.  Each
// pixel keeps its K best (depth, triangle id) pairs in lexicographic order,
// later ids winning ties, slot 0 the best.  Slots start at (-inf, -1)
// (pallas_tile.py:694-695); a fragment is admitted when it is inside, its
// depth is not NaN or -inf and it is not in front of the framebuffer seed,
// d >= fbd (:717), and is bubbled through the sorted slots with the
// compares of :741-746.  Each layer's winner payload row is then read once
// and interpolated exactly as the single-winner kernel does
// (tile_common.cuh), into G-buffer planes [layer * kpi, (layer + 1) * kpi).
// The K layers equal K passes of depth peeling without any stop: layer k is
// the best fragment strictly below layer k - 1.
//
// What bounds it on the card: the fold is arithmetic (globals + segment
// length edge tests per pixel, 23 FP32 operations each, without FMA; see
// tile_raster.cu) and the resolve a payload-row gather per pixel and layer;
// with K (kpi + 2) planes written, the bytes bound a sparse frame.
//
// The design is tile_raster.cu's opaque mode with K slots a pixel, and each
// part does here what it does there:
//   * The TPU kernel streams the triangles twice (a top-K fold, then a
//     one-hot matmul resolve per layer); here the K slots stay in registers
//     during one fold and the winners' rows are read once at the end.
//   * A block of 256 threads owns 1,024 pixels of a tile, 4 a thread; a
//     tile of any tile_h x tile_w runs as ceil(tile_h * tile_w / 1024)
//     blocks, the ragged last one filled with a stand-in pixel that is
//     folded and never written, so the fold loop is bounded per warp.
//   * Blocks take tiles longest list first (tile_order, computed on the
//     device by the wrapper): a one-dimensional grid, block b folds part
//     b % blocks_per_tile of tile tile_order[b / blocks_per_tile].
//   * Set-up rows are staged as 16-float Rows with the edge differences
//     taken once per triangle, read back as four 16-byte broadcast loads
//     (tile_common.cuh); where 256 is a multiple of tile_w a thread's four
//     pixels lie in one column and each edge's a * (px - x) is taken once
//     per triangle.
//   * The inside test comes first; the depth, the admit compares and the
//     slot insertion sit behind a branch that a triangle covering none of
//     the thread's pixels skips, as most do.
//   * 2K slot registers a pixel bound the blocks an SM: kBlocks below, set
//     from what ptxas reports for each K, with no spill.

#include <limits.h>

#include "tile_common.cuh"

namespace {

using tile::kThreads;
using tile::kMaxPlan;
using tile::kRow;
using tile::Row;

constexpr int kMaxK = 8;
constexpr int kPix = 4;                     // pixels per thread
constexpr int kBlockPx = kThreads * kPix;   // pixels per block

// Blocks of 256 threads an SM: the registers a thread may use are
// 65,536 / (256 * blocks), rounded down to a multiple of 8.
constexpr int blocks_per_sm(int K) { return K <= 1 ? 4 : K <= 2 ? 3 : 2; }

// The (depth, id) order of the fold: does (d, i) rank above (sd, si)?
__device__ __forceinline__ bool above(float d, int i, float sd, int si) {
  return d > sd || (d == sd && i > si);
}

// Fold list[begin, begin + len) into the K sorted slots of the first wn
// pixels of the thread; wn is the same for every lane of a warp.  Every
// thread stages and reaches every barrier, whatever its wn.  The arithmetic
// is the staged Row's (tile_common.cuh), operation for operation.
template <int K, bool kColumn>
__device__ __forceinline__ void fold_list(
    float (&ld)[K][kPix], int (&li)[K][kPix], const float (&px)[kPix],
    const float (&py)[kPix], const float (&fb)[kPix], int wn,
    const int* __restrict__ list, int begin, int len,
    const float* __restrict__ setup, float4 (*s_row)[kRow / 4], int* s_idx) {
  for (int c0 = 0; c0 < len; c0 += kThreads) {
    const int n = min(kThreads, len - c0);
    __syncthreads();                   // the previous chunk is consumed
    tile::stage_rows(list, begin, c0, n, setup, s_row, s_idx);
    __syncthreads();
    if (wn == 0) continue;
    for (int j = 0; j < n; ++j) {
      const Row r = tile::load_row(s_row, j);
      float w0[kPix], w1[kPix], w2[kPix];
      unsigned inside = 0;
      float ex0 = 0.f, ex1 = 0.f, ex2 = 0.f;
      if constexpr (kColumn) {
        ex0 = r.a0 * (px[0] - r.x0);
        ex1 = r.a1 * (px[0] - r.x1);
        ex2 = r.a2 * (px[0] - r.x2);
      }
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (k < wn) {
          if constexpr (kColumn) {
            w0[k] = ex0 + r.b0 * (py[k] - r.y0);
            w1[k] = ex1 + r.b1 * (py[k] - r.y1);
            w2[k] = ex2 + r.b2 * (py[k] - r.y2);
          } else {
            w0[k] = r.a0 * (px[k] - r.x0) + r.b0 * (py[k] - r.y0);
            w1[k] = r.a1 * (px[k] - r.x1) + r.b1 * (py[k] - r.y1);
            w2[k] = r.a2 * (px[k] - r.x2) + r.b2 * (py[k] - r.y2);
          }
          const bool in = (w0[k] >= 0.f && w1[k] >= 0.f && w2[k] >= 0.f)
                          || (w0[k] <= 0.f && w1[k] <= 0.f && w2[k] <= 0.f);
          inside |= (in ? 1u : 0u) << k;
        }
      }
      if (inside == 0) continue;
      const int idx = s_idx[j];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if ((inside >> k) & 1u) {
          const float d = r.d0 * (w0[k] * r.ia) + r.d1 * (w1[k] * r.ia)
                          + r.d2 * (w2[k] * r.ia);
          // NaN fails every comparison; -inf never enters a slot.  A
          // fragment not above the last slot changes no slot.
          if (d > -INFINITY && d >= fb[k]
              && above(d, idx, ld[K - 1][k], li[K - 1][k])) {
            float cd = d;
            int ci = idx;
#pragma unroll
            for (int s = 0; s < K; ++s) {
              const float sd = ld[s][k];
              const int si = li[s][k];
              const bool go = ci > -1
                              && (cd > sd || (cd == sd && ci > si));
              ld[s][k] = go ? cd : sd;
              li[s][k] = go ? ci : si;
              cd = go ? sd : cd;
              ci = go ? si : ci;
            }
          }
        }
      }
    }
  }
}

// kColumn: kThreads is a multiple of tile_w, so the pixels t + k * 256 of
// a thread lie in one column.
template <int K, bool kColumn>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(K))
tile_kdeep_kernel(
    const float* __restrict__ fbd, const float* __restrict__ setup,
    const int* __restrict__ order, const int* __restrict__ n_global,
    const int* __restrict__ seg_tri, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const long long* __restrict__ tile_order,
    const float* __restrict__ payload, const int* __restrict__ plan,
    int n_plan, float* __restrict__ gbuf, float* __restrict__ best_d,
    int* __restrict__ best_i, int ntx, int tile_h, int tile_w, int Hp,
    int Wp, int blocks_per_tile, int kp, int kpi, int sl_screen, int sl_ia,
    int clip_w_off) {
  __shared__ float4 s_row[kThreads][kRow / 4];
  __shared__ int s_idx[kThreads];
  __shared__ int s_plan[kMaxPlan * 3];

  const int tile = static_cast<int>(tile_order[blockIdx.x / blocks_per_tile]);
  const int ty = tile / ntx, tx = tile % ntx;
  const int x_lo = tx * tile_w, y_lo = ty * tile_h;
  const int tpx = tile_h * tile_w;
  const int t = threadIdx.x;
  // This block owns tile pixels [first, first + kBlockPx); first < tpx.
  const int first = (blockIdx.x % blocks_per_tile) * kBlockPx;
  // Slots any lane of the warp holds; a slot past the tile's last pixel
  // holds the block's first pixel as a stand-in.
  const int wn = max(0, min(kPix, (tpx - first - (t >> 5) * 32 + kThreads - 1)
                                      / kThreads));
  for (int k = t; k < n_plan * 3; k += kThreads) s_plan[k] = plan[k];

  unsigned mine = 0;
  float px[kPix], py[kPix], fb[kPix];
  float ld[K][kPix];
  int li[K][kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int s = t + k * kThreads;
    const bool has = first + s < tpx;
    mine |= (has ? 1u : 0u) << k;
    const int q = first + (has ? s : 0);
    const int x = x_lo + q % tile_w, y = y_lo + q / tile_w;
    px[k] = static_cast<float>(x);
    py[k] = static_cast<float>(y);
    fb[k] = fbd[y * Wp + x];
#pragma unroll
    for (int s2 = 0; s2 < K; ++s2) {
      ld[s2][k] = -INFINITY;
      li[s2][k] = -1;
    }
  }

  fold_list<K, kColumn>(ld, li, px, py, fb, wn, order, 0, n_global[0],
                        setup, s_row, s_idx);
  fold_list<K, kColumn>(ld, li, px, py, fb, wn, seg_tri, starts[tile],
                        counts[tile], setup, s_row, s_idx);
  __syncthreads();                     // s_plan is visible

  const long long plane = static_cast<long long>(Hp) * Wp;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if ((mine >> k) & 1u) {
      const long long o = static_cast<long long>(py[k]) * Wp
                          + static_cast<long long>(px[k]);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        best_d[s * plane + o] = ld[s][k];
        best_i[s * plane + o] = li[s][k];
      }
    }
  }
  // Each (pixel, layer) is resolved by the thread that folded it, one at a
  // time from the winner it has just written, so that the resolve is
  // compiled once and not 4 K times.
#pragma unroll 1
  for (int e = 0; e < kPix * K; ++e) {
    const int k = e / K, s = e % K;
    const int q = first + t + k * kThreads;
    if (q >= tpx) continue;
    const int x = x_lo + q % tile_w, y = y_lo + q / tile_w;
    const long long o = static_cast<long long>(y) * Wp + x;
    tile::resolve_pixel(gbuf + s * kpi * plane + o, plane,
                        best_i[s * plane + o], static_cast<float>(x),
                        static_cast<float>(y), payload, s_plan, n_plan, kp,
                        kpi, sl_screen, sl_ia, clip_w_off);
  }
}

template <int K>
void launch(unsigned grid, bool column, cudaStream_t stream,
            const float* fbd, const float* setup, const int* order,
            const int* n_global, const int* seg_tri, const int* starts,
            const int* counts, const long long* tile_order,
            const float* payload, const int* plan, int n_plan, float* gbuf,
            float* best_d, int* best_i, int ntx, int tile_h, int tile_w,
            int Hp, int Wp, int blocks_per_tile, int kp, int kpi,
            int sl_screen, int sl_ia, int clip_w_off) {
#define TILE_KDEEP_LAUNCH(COLUMN)                                           \
  tile_kdeep_kernel<K, COLUMN><<<grid, kThreads, 0, stream>>>(              \
      fbd, setup, order, n_global, seg_tri, starts, counts, tile_order,     \
      payload, plan, n_plan, gbuf, best_d, best_i, ntx, tile_h, tile_w, Hp, \
      Wp, blocks_per_tile, kp, kpi, sl_screen, sl_ia, clip_w_off)
  if (column) {
    TILE_KDEEP_LAUNCH(true);
  } else {
    TILE_KDEEP_LAUNCH(false);
  }
#undef TILE_KDEEP_LAUNCH
}

}  // namespace

// Launch on `stream` for 1 <= K <= 8; returns cudaGetLastError() (0 on
// success).  Inputs as tile_raster_launch's opaque mode (tile_order (ntiles,)
// i64 a permutation of the tiles; setup on an 8-byte boundary); outputs gbuf
// (K*kpi, Hp, Wp) f32, best_d (K, Hp, Wp) f32 (-inf in empty slots) and
// best_i (K, Hp, Wp) i32 (-1 in empty slots).  Any tile_h x tile_w.
extern "C" int tile_kdeep_launch(
    const float* fbd, const float* setup, const int* order,
    const int* n_global, const int* seg_tri, const int* starts,
    const int* counts, const long long* tile_order, const float* payload,
    const int* plan, int n_plan, float* gbuf, float* best_d, int* best_i,
    int ntx, int nty, int tile_h, int tile_w, int kp, int kpi, int sl_screen,
    int sl_ia, int clip_w_off, int K, cudaStream_t stream) {
  if (n_plan > kMaxPlan || K < 1 || K > kMaxK || tile_h <= 0 || tile_w <= 0
      || ntx < 0 || nty < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = static_cast<long long>(ntx) * nty;
  if (ntiles == 0) return 0;
  const long long tpx = static_cast<long long>(tile_h) * tile_w;
  const long long per_tile = (tpx + kBlockPx - 1) / kBlockPx;
  if (tpx > INT_MAX || ntiles * per_tile > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(ntiles * per_tile);
  const int blocks_per_tile = static_cast<int>(per_tile);
  const int Hp = nty * tile_h, Wp = ntx * tile_w;
  const bool column = kThreads % tile_w == 0;
#define TILE_KDEEP_CASE(k)                                                  \
  case k:                                                                   \
    launch<k>(grid, column, stream, fbd, setup, order, n_global, seg_tri,   \
              starts, counts, tile_order, payload, plan, n_plan, gbuf,      \
              best_d, best_i, ntx, tile_h, tile_w, Hp, Wp, blocks_per_tile, \
              kp, kpi, sl_screen, sl_ia, clip_w_off);                       \
    break;
  switch (K) {
    TILE_KDEEP_CASE(1)
    TILE_KDEEP_CASE(2)
    TILE_KDEEP_CASE(3)
    TILE_KDEEP_CASE(4)
    TILE_KDEEP_CASE(5)
    TILE_KDEEP_CASE(6)
    TILE_KDEEP_CASE(7)
    TILE_KDEEP_CASE(8)
  }
#undef TILE_KDEEP_CASE
  return static_cast<int>(cudaGetLastError());
}
