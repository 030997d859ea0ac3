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
// What bounds it on the card: as the single-winner kernel, the fold is
// arithmetic (globals + segment length edge tests per pixel) and the
// resolve a payload-row gather per pixel and layer.  The design: the TPU
// kernel streams the triangles twice (a top-K fold, then a one-hot matmul
// resolve per layer); here the K slots stay in registers during one fold
// and the winners' rows are read once at the end, so the triangles are
// streamed once.  2K slot registers per pixel leave fewer pixels per
// thread than the single-winner kernel's 16 (4 here), so a tile is split
// across gridDim.y blocks of 256 threads, each folding the tile's whole
// list for its 1024 pixels (the fold is order-independent, so a block may
// own any pixels).

#include "tile_common.cuh"

namespace {

using tile::kThreads;
using tile::kMaxPlan;

constexpr int kMaxK = 8;

// Pixels per thread: each holds 2K slot registers.  At 4 pixels K = 8
// takes 128 registers without spilling; 8 pixels spilled at K = 4 already.
constexpr int kPix = 4;

// The (depth, id) order of the fold: does (d, i) rank above (sd, si)?
__device__ __forceinline__ bool above(float d, int i, float sd, int si) {
  return d > sd || (d == sd && i > si);
}

// Fold list[begin, begin + len) into the K sorted slots of every pixel the
// thread owns.
template <int K, int P>
__device__ __forceinline__ void fold_list(
    float (&ld)[K][P], int (&li)[K][P], const float (&px)[P],
    const float (&py)[P], const float (&fb)[P], int npix,
    const int* __restrict__ list, int begin, int len,
    const float* __restrict__ setup, float (*s_set)[kThreads], int* s_idx) {
  for (int c0 = 0; c0 < len; c0 += kThreads) {
    const int n = min(kThreads, len - c0);
    __syncthreads();                   // the previous chunk is consumed
    tile::stage(list, begin, c0, n, setup, s_set, s_idx);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const tile::Tri tri = tile::load_tri(s_set, j);
      const int idx = s_idx[j];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (k < npix) {
          float d;
          const bool inside = tile::fragment(tri, px[k], py[k], d);
          // NaN fails every comparison; -inf never enters a slot.  A
          // fragment not above the last slot changes no slot.
          if (inside && d > -INFINITY && d >= fb[k]
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

template <int K>
__global__ void __launch_bounds__(kThreads, 1) tile_kdeep_kernel(
    const float* __restrict__ fbd, const float* __restrict__ setup,
    const int* __restrict__ order, const int* __restrict__ n_global,
    const int* __restrict__ seg_tri, const int* __restrict__ starts,
    const int* __restrict__ counts, const float* __restrict__ payload,
    const int* __restrict__ plan, int n_plan, float* __restrict__ gbuf,
    float* __restrict__ best_d, int* __restrict__ best_i, int ntx,
    int tile_h, int tile_w, int Hp, int Wp, int kp, int kpi, int sl_screen,
    int sl_ia, int clip_w_off) {
  __shared__ float s_set[tile::kSetup][kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ int s_plan[kMaxPlan * 3];

  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int tpx = tile_h * tile_w;
  const int t = threadIdx.x;
  // This block owns tile pixels [first, first + kThreads * kPix).
  const int first = blockIdx.y * kThreads * kPix;
  const int npix = max(0, min(kPix, (tpx - first - t + kThreads - 1)
                                        / kThreads));
  for (int k = t; k < n_plan * 3; k += kThreads) s_plan[k] = plan[k];

  float px[kPix], py[kPix], fb[kPix];
  float ld[K][kPix];
  int li[K][kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < npix) {
      const int q = first + t + k * kThreads;
      const int x = tx * tile_w + q % tile_w, y = ty * tile_h + q / tile_w;
      px[k] = static_cast<float>(x);
      py[k] = static_cast<float>(y);
      fb[k] = fbd[y * Wp + x];
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      ld[s][k] = -INFINITY;
      li[s][k] = -1;
    }
  }

  fold_list<K, kPix>(ld, li, px, py, fb, npix, order, 0, n_global[0], setup,
                     s_set, s_idx);
  fold_list<K, kPix>(ld, li, px, py, fb, npix, seg_tri, starts[tile],
                     counts[tile], setup, s_set, s_idx);
  __syncthreads();                     // s_plan is visible

  const long long plane = static_cast<long long>(Hp) * Wp;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < npix) {
      const long long o = static_cast<long long>(py[k]) * Wp
                          + static_cast<long long>(px[k]);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        best_d[s * plane + o] = ld[s][k];
        best_i[s * plane + o] = li[s][k];
        tile::resolve_pixel(gbuf + s * kpi * plane + o, plane, li[s][k],
                            px[k], py[k], payload, s_plan, n_plan, kp, kpi,
                            sl_screen, sl_ia, clip_w_off);
      }
    }
  }
}

template <int K>
void launch(dim3 grid, cudaStream_t stream, const float* fbd,
            const float* setup, const int* order, const int* n_global,
            const int* seg_tri, const int* starts, const int* counts,
            const float* payload, const int* plan, int n_plan, float* gbuf,
            float* best_d, int* best_i, int ntx, int tile_h, int tile_w,
            int Hp, int Wp, int kp, int kpi, int sl_screen, int sl_ia,
            int clip_w_off) {
  tile_kdeep_kernel<K><<<grid, kThreads, 0, stream>>>(
      fbd, setup, order, n_global, seg_tri, starts, counts, payload, plan,
      n_plan, gbuf, best_d, best_i, ntx, tile_h, tile_w, Hp, Wp, kp, kpi,
      sl_screen, sl_ia, clip_w_off);
}

}  // namespace

// Launch on `stream` for 1 <= K <= 8; returns cudaGetLastError() (0 on
// success).  Inputs as tile_raster_launch's opaque mode; outputs gbuf
// (K*kpi, Hp, Wp) f32, best_d (K, Hp, Wp) f32 (-inf in empty slots) and
// best_i (K, Hp, Wp) i32 (-1 in empty slots).
extern "C" int tile_kdeep_launch(
    const float* fbd, const float* setup, const int* order,
    const int* n_global, const int* seg_tri, const int* starts,
    const int* counts, const float* payload, const int* plan, int n_plan,
    float* gbuf, float* best_d, int* best_i, int ntx, int nty, int tile_h,
    int tile_w, int kp, int kpi, int sl_screen, int sl_ia, int clip_w_off,
    int K, cudaStream_t stream) {
  if (n_plan > kMaxPlan || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = ntx * nty;
  if (ntiles == 0) return 0;
  const int per_block = kThreads * kPix;
  const dim3 grid(ntiles, (tile_h * tile_w + per_block - 1) / per_block);
  const int Hp = nty * tile_h, Wp = ntx * tile_w;
#define TILE_KDEEP_CASE(k)                                                  \
  case k:                                                                   \
    launch<k>(grid, stream, fbd, setup, order, n_global, seg_tri, starts,   \
              counts, payload, plan, n_plan, gbuf, best_d, best_i, ntx,     \
              tile_h, tile_w, Hp, Wp, kp, kpi, sl_screen, sl_ia,            \
              clip_w_off);                                                  \
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
