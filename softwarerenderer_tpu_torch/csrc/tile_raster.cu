// Tile raster kernel: visibility fold, winner resolve and interpolation, in
// two modes.
//
// Replaces softwarerenderer_tpu/ops/pallas_tile.py:_kernel.  With
// kPeel = false (peel=False, the opaque frame's kernel) it starts every
// pixel at (framebuffer depth, -1), folds the global triangles and then the
// tile's binned segment, keeping the lexicographic max of (depth, triangle
// id) with later ids winning ties (the reference's sequential "new >= old",
// Rasterizer.cs:546).  With kPeel = true (peel=True, the depth-peeled
// K-buffer's passes 1..K-1) a fragment is admitted only if it ranks
// strictly below the previous pass's winner (prev_d, prev_i) at its pixel,
// and never if it is that winner (pallas_tile.py:181-182); a tile with no
// pixel whose prev_i >= 0 skips both folds and writes the clear outputs
// (pallas_tile.py:150).  Either mode then reads the winner's payload row
// once per pixel and writes the G-buffer (tile_common.cuh).
//
// What bounds it on the card: the fold is arithmetic, (globals + segment
// length) edge tests per pixel; the resolve is one 3*kp-float payload row
// read per pixel, a gather served from L2 (payloads are a few MB).  The
// design: one block per tile, 256 threads, each owning up to 16 pixels with
// their running (depth, id) in registers, and in peel mode the previous
// pass's (depth, id) beside them; setup rows are staged through shared
// memory 256 triangles at a time, so each is read from device memory once
// per tile and broadcast to all threads.  Only (depth, id) is carried
// during the fold, and the payload is read once at the end: the TPU
// kernel's one-hot matmul resolve, lane padding, sub-chunk predication and
// f32-carried ids are TPU shapes with no counterpart here.  The peel mode
// is a template parameter, so the opaque instantiation carries none of it.

#include "tile_common.cuh"

namespace {

using tile::kThreads;
using tile::kMaxPlan;

constexpr int kMaxPix = 16;     // pixels per thread: tiles up to 4096 pixels

struct Fold {
  float px[kMaxPix], py[kMaxPix], bd[kMaxPix];
  int bi[kMaxPix];
};

// The previous pass's winner per pixel (peel mode only).
struct Prev {
  float pd[kMaxPix];
  int pi[kMaxPix];
};

// Fold list[begin, begin + len) into every pixel the thread owns.
template <bool kPeel>
__device__ __forceinline__ void fold_stream(
    Fold& f, const Prev& p, int npix, const int* __restrict__ list,
    int begin, int len, const float* __restrict__ setup,
    float (*s_set)[kThreads], int* s_idx) {
  for (int c0 = 0; c0 < len; c0 += kThreads) {
    const int n = min(kThreads, len - c0);
    __syncthreads();                   // the previous chunk is consumed
    tile::stage(list, begin, c0, n, setup, s_set, s_idx);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const tile::Tri s = tile::load_tri(s_set, j);
      const int idx = s_idx[j];
#pragma unroll
      for (int k = 0; k < kMaxPix; ++k) {
        if (k < npix) {
          float d;
          const bool inside = tile::fragment(s, f.px[k], f.py[k], d);
          // NaN fails every comparison; -inf never wins (pallas_tile's
          // `has`).
          bool admit = inside && d > -INFINITY;
          if constexpr (kPeel) {
            admit = admit && idx != p.pi[k]
                    && (d < p.pd[k] || (d == p.pd[k] && idx < p.pi[k]));
          }
          if (admit && (d > f.bd[k] || (d == f.bd[k] && idx > f.bi[k]))) {
            f.bd[k] = d;
            f.bi[k] = idx;
          }
        }
      }
    }
  }
}

template <bool kPeel>
__global__ void __launch_bounds__(kThreads) tile_raster_kernel(
    const float* __restrict__ fbd, const float* __restrict__ prev_d,
    const int* __restrict__ prev_i, const float* __restrict__ setup,
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
  const int npix = min(kMaxPix, (tpx - t + kThreads - 1) / kThreads);
  for (int k = t; k < n_plan * 3; k += kThreads) s_plan[k] = plan[k];

  Fold f;
  Prev p;
  bool eligible = false;
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    if (k < npix) {
      const int q = t + k * kThreads;
      const int x = tx * tile_w + q % tile_w, y = ty * tile_h + q / tile_w;
      f.px[k] = static_cast<float>(x);
      f.py[k] = static_cast<float>(y);
      f.bd[k] = fbd[y * Wp + x];
      f.bi[k] = -1;
      if constexpr (kPeel) {
        p.pd[k] = prev_d[y * Wp + x];
        p.pi[k] = prev_i[y * Wp + x];
        eligible = eligible || p.pi[k] >= 0;
      }
    }
  }
  // Peel mode: a tile whose previous winners are all cleared admits
  // nothing, so every thread skips both folds (a block-uniform branch).
  bool run = true;
  if constexpr (kPeel) run = __syncthreads_or(eligible) != 0;
  if (run) {
    fold_stream<kPeel>(f, p, npix, order, 0, n_global[0], setup, s_set,
                       s_idx);
    fold_stream<kPeel>(f, p, npix, seg_tri, starts[tile], counts[tile],
                       setup, s_set, s_idx);
  }
  __syncthreads();                     // s_plan is visible

  const long long plane = static_cast<long long>(Hp) * Wp;
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    if (k >= npix) continue;
    const float px = f.px[k], py = f.py[k];
    const long long o = static_cast<long long>(py) * Wp
                        + static_cast<long long>(px);
    best_d[o] = f.bd[k];
    best_i[o] = f.bi[k];
    tile::resolve_pixel(gbuf + o, plane, f.bi[k], px, py, payload, s_plan,
                        n_plan, kp, kpi, sl_screen, sl_ia, clip_w_off);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Pointers
// are device pointers to contiguous tensors: fbd (Hp, Wp) f32; prev_d
// (Hp, Wp) f32 and prev_i (Hp, Wp) i32, both null for the opaque mode and
// both set for the peel mode; setup (N, 10) f32; order (N,), n_global (1,),
// seg_tri (L,), starts and counts (ntiles,) i32; payload (N, 3*kp) f32;
// plan (n_plan, 3) i32; outputs gbuf (kpi, Hp, Wp) f32, best_d (Hp, Wp)
// f32, best_i (Hp, Wp) i32.
extern "C" int tile_raster_launch(
    const float* fbd, const float* prev_d, const int* prev_i,
    const float* setup, const int* order, const int* n_global,
    const int* seg_tri, const int* starts, const int* counts,
    const float* payload, const int* plan, int n_plan, float* gbuf,
    float* best_d, int* best_i, int ntx, int nty, int tile_h, int tile_w,
    int kp, int kpi, int sl_screen, int sl_ia, int clip_w_off,
    cudaStream_t stream) {
  if (n_plan > kMaxPlan || tile_h * tile_w > kThreads * kMaxPix
      || (prev_d == nullptr) != (prev_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = ntx * nty;
  if (ntiles == 0) return 0;
  if (prev_d == nullptr) {
    tile_raster_kernel<false><<<ntiles, kThreads, 0, stream>>>(
        fbd, prev_d, prev_i, setup, order, n_global, seg_tri, starts,
        counts, payload, plan, n_plan, gbuf, best_d, best_i, ntx, tile_h,
        tile_w, nty * tile_h, ntx * tile_w, kp, kpi, sl_screen, sl_ia,
        clip_w_off);
  } else {
    tile_raster_kernel<true><<<ntiles, kThreads, 0, stream>>>(
        fbd, prev_d, prev_i, setup, order, n_global, seg_tri, starts,
        counts, payload, plan, n_plan, gbuf, best_d, best_i, ntx, tile_h,
        tile_w, nty * tile_h, ntx * tile_w, kp, kpi, sl_screen, sl_ia,
        clip_w_off);
  }
  return static_cast<int>(cudaGetLastError());
}
