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
// What bounds it on the card: operations.  The fold is (globals + segment
// length) edge tests per pixel, 23 FP32 operations each; the bytes are one
// framebuffer read and kpi + 2 writes per pixel, and the resolve's one
// 3*kp-float payload row per covered pixel is a gather served from L2.
// The data sheet's 67 TFLOP/s, which the smoke's bound uses, counts a fused
// multiply-add as two operations; this library is built with -fmad=false
// so that it rounds like its plain twin and executes a multiply and an add
// instead, so half that bound is the most this arithmetic can reach.
//
// The design, and what each part does about it:
//   * A block of 256 threads owns 1,024 pixels of a tile, 4 a thread, with
//     their running (depth, id) in registers; a tile of any tile_h x tile_w
//     runs as ceil(tile_h * tile_w / 1024) blocks, the ragged last one
//     masked.  Four pixels keep the opaque mode at 64 registers, so 4
//     blocks (32 warps) fit an SM (3 in peel mode, which also holds the
//     previous winners), and the busiest tile's list is walked by four
//     blocks at 4 tests a triangle instead of one block at 16.
//   * Blocks take tiles longest list first (tile_order, computed on the
//     device by the wrapper): the grid is one-dimensional, block b folds
//     part b % blocks_per_tile of tile tile_order[b / blocks_per_tile], so
//     the busiest tiles start in the first wave and short ones fill the
//     tail.
//   * Set-up rows are staged through shared memory 256 triangles at a time,
//     as 16-float rows that carry the six edge differences (exact: the same
//     subtractions the edge functions take, once per triangle instead of
//     once per thread), and are read back as four 16-byte broadcast loads.
//   * Fewer instructions a test, none of them rounding differently: where
//     256 is a multiple of tile_w a thread's four pixels lie in one column,
//     so the opaque mode takes each edge's a * (px - x) once per triangle;
//     and the depth and its compares sit behind a branch that a triangle
//     covering none of the thread's pixels skips, as most do.  What is
//     left bounds the frame by its busiest tile: four blocks walk its
//     whole list, each sharing its SM with three other blocks.
//   * The peel folds only pixels that can admit something.  A pixel is dead
//     iff prev_i < 0 and not (prev_d > -FLT_MAX): then "d < prev_d" needs
//     d = -inf, which is never admitted, and "d == prev_d && idx < prev_i"
//     needs idx < -1.  A block with no live pixel writes its clear outputs
//     and returns before staging anything.  The tile's run flag must be the
//     whole tile's: a block whose own pixels hold a prev_i >= 0 has it, and
//     only a block with live pixels but no such pixel reads the rest of its
//     tile's prev_i (from L2).  On a K-buffer frame's own maps a live pixel
//     has prev_i >= 0, so that read never happens there, and where every
//     block must make it (the smoke's "run flag" timing) it costs nothing
//     beyond the run-to-run spread; a flag kernel ahead of this one would
//     cost every pass a launch.  A block that runs compacts its live pixels into a
//     shared-memory list (ballot + prefix count) and deals them to threads
//     in order, so 22 live pixels occupy one warp at one pixel a lane and
//     the other warps only stage and wait at the barriers; each warp's fold
//     loop is bounded by its own pixel count, which is warp-uniform.
//   * Only (depth, id) is carried during the fold and the payload is read
//     once at the end: the TPU kernel's one-hot matmul resolve, lane
//     padding, sub-chunk predication and f32-carried ids are TPU shapes
//     with no counterpart here.  The peel mode is a template parameter, so
//     the opaque instantiation carries none of it.
//   * A band of a sharded frame (parallel/sharding.py) stores tiles that
//     are not its own screen rows: contiguous bands start at a row offset,
//     balanced bands hold any set of tile rows or tiles.  An optional
//     (ntiles, 2) int32 map gives each storage tile's screen origin
//     (y0, x0); a pixel is evaluated and resolved at its screen position
//     and stored where it was.  The map is a third template parameter, so
//     the unmapped instantiations are the kernels as they were, registers
//     and all; a mapped one carries the tile's (storage - screen) offset
//     through the fold to place its writes, at 3 blocks an SM.

#include <float.h>
#include <limits.h>

#include "tile_common.cuh"

namespace {

using tile::kThreads;
using tile::kMaxPlan;
using tile::kRow;
using tile::Row;
using tile::load_row;
using tile::stage_rows;

constexpr int kPix = 4;                     // pixels per thread
constexpr int kBlockPx = kThreads * kPix;   // pixels per block
constexpr int kWarps = kThreads / 32;
static_assert(kPix * kWarps == 32, "the live-pixel scan is one warp wide");

// A thread's pixels: position, running winner and, in peel mode, the
// previous pass's winner.
template <bool kPeel>
struct Pixels {
  float px[kPix], py[kPix], bd[kPix];
  int bi[kPix];
  float pd[kPeel ? kPix : 1];
  int pi[kPeel ? kPix : 1];
};

// Fold list[begin, begin + len) into the first wn pixels of the thread;
// wn is the same for every lane of a warp.  Every thread stages and
// reaches every barrier, whatever its wn.
//
// The arithmetic is the staged Row's (tile_common.cuh), operation for
// operation, so the same bits as the plain twin: edge e at a pixel is
// a_e * (px - x_e) + b_e * (py - y_e), and the depth
// d0 * (w0 * ia) + d1 * (w1 * ia) + d2 * (w2 * ia).  With kColumn the
// thread's pixels share px (f.px[0]), so the three a_e * (px - x_e) are
// taken once per triangle.  The depth and the compares that follow are
// skipped, by a branch, for a triangle that covers none of the thread's
// pixels: most tests of a frame end there.
template <bool kPeel, bool kColumn>
__device__ __forceinline__ void fold_stream(
    Pixels<kPeel>& f, int wn, const int* __restrict__ list, int begin,
    int len, const float* __restrict__ setup, float4 (*s_row)[kRow / 4],
    int* s_idx) {
  for (int c0 = 0; c0 < len; c0 += kThreads) {
    const int n = min(kThreads, len - c0);
    __syncthreads();                   // the previous chunk is consumed
    stage_rows(list, begin, c0, n, setup, s_row, s_idx);
    __syncthreads();
    if (wn == 0) continue;
    for (int j = 0; j < n; ++j) {
      const Row r = load_row(s_row, j);
      float w0[kPix], w1[kPix], w2[kPix];
      unsigned inside = 0;
      float ex0 = 0.f, ex1 = 0.f, ex2 = 0.f;
      if constexpr (kColumn) {
        ex0 = r.a0 * (f.px[0] - r.x0);
        ex1 = r.a1 * (f.px[0] - r.x1);
        ex2 = r.a2 * (f.px[0] - r.x2);
      }
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (k < wn) {
          if constexpr (kColumn) {
            w0[k] = ex0 + r.b0 * (f.py[k] - r.y0);
            w1[k] = ex1 + r.b1 * (f.py[k] - r.y1);
            w2[k] = ex2 + r.b2 * (f.py[k] - r.y2);
          } else {
            w0[k] = r.a0 * (f.px[k] - r.x0) + r.b0 * (f.py[k] - r.y0);
            w1[k] = r.a1 * (f.px[k] - r.x1) + r.b1 * (f.py[k] - r.y1);
            w2[k] = r.a2 * (f.px[k] - r.x2) + r.b2 * (f.py[k] - r.y2);
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
          // NaN fails every comparison; -inf never wins (pallas_tile's
          // `has`).
          bool admit = d > -INFINITY;
          if constexpr (kPeel) {
            admit = admit && idx != f.pi[k]
                    && (d < f.pd[k] || (d == f.pd[k] && idx < f.pi[k]));
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

// The opaque mode fits 64 registers, so 4 blocks an SM; the peel mode's
// prev_d and prev_i for 4 pixels do not without spilling, so it takes 3.
// kColumn: kThreads is a multiple of tile_w, so the pixels t + k * 256 of
// a thread lie in one column (opaque mode only: the peel deals pixels out
// anew).  kOrigin: tile_origin maps each storage tile to its screen origin
// (y0, x0); without it a storage tile is its own screen tile.  The map's
// offset stays live through the fold, so a mapped instantiation takes 3
// blocks an SM too rather than spill.
template <bool kPeel, bool kColumn, bool kOrigin>
__global__ void __launch_bounds__(kThreads, kPeel || kOrigin ? 3 : 4)
    tile_raster_kernel(
    const float* __restrict__ fbd, const float* __restrict__ prev_d,
    const int* __restrict__ prev_i, const float* __restrict__ setup,
    const int* __restrict__ order, const int* __restrict__ n_global,
    const int* __restrict__ seg_tri, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const long long* __restrict__ tile_order,
    const int* __restrict__ tile_origin,
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
  // Storage minus screen position of the tile's pixels (0 unmapped).
  int dy = 0, dx = 0;
  if constexpr (kOrigin) {
    dy = y_lo - tile_origin[2 * tile];
    dx = x_lo - tile_origin[2 * tile + 1];
  }
  const int tpx = tile_h * tile_w;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  // This block owns tile pixels [first, first + kBlockPx); first < tpx.
  const int first = (blockIdx.x % blocks_per_tile) * kBlockPx;
  const long long plane = static_cast<long long>(Hp) * Wp;

  // Slot k of the thread holds block pixel src[k] (tile pixel first +
  // src[k]) when `mine` has bit k; the other slots hold a stand-in pixel
  // of the block that is folded and never written.
  int src[kPix];
  unsigned mine = 0;
  int wn;                              // slots any lane of the warp holds

  if constexpr (!kPeel) {
    wn = max(0, min(kPix, (tpx - first - warp * 32 + kThreads - 1)
                              / kThreads));
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int s = t + k * kThreads;
      const bool has = first + s < tpx;
      src[k] = has ? s : 0;
      mine |= (has ? 1u : 0u) << k;
    }
  } else {
    __shared__ unsigned short s_list[kBlockPx];
    __shared__ int s_base[kPix * kWarps + 1];
    const int lane = t & 31;

    // The thread's home pixels t + k * 256: which are live, and whether any
    // has a previous winner.
    unsigned live = 0;
    bool eligible = false;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int q = first + t + k * kThreads;
      if (q < tpx) {
        const int o = (y_lo + q / tile_w) * Wp + x_lo + q % tile_w;
        const float pd = prev_d[o];
        const int pi = prev_i[o];
        const bool dead = pi < 0 && !(pd > -FLT_MAX);
        live |= (dead ? 0u : 1u) << k;
        eligible = eligible || pi >= 0;
      }
    }
    // The block runs if it has a live pixel and its tile has a previous
    // winner anywhere: here, or else among the tile's other pixels.
    // Every branch below is block-uniform.
    bool run = __syncthreads_or(live != 0) != 0;
    if (run && __syncthreads_or(eligible) == 0) {
      bool elsewhere = false;
      for (int q = t; q < tpx; q += kThreads)
        elsewhere = elsewhere
                    || prev_i[(y_lo + q / tile_w) * Wp + x_lo + q % tile_w]
                           >= 0;
      run = __syncthreads_or(elsewhere) != 0;
    }
    // Clear outputs for every home pixel the fold will not own.
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int q = first + t + k * kThreads;
      if (q < tpx && !(run && ((live >> k) & 1u))) {
        const long long o = static_cast<long long>(y_lo + q / tile_w) * Wp
                            + x_lo + q % tile_w;
        best_d[o] = fbd[o];
        best_i[o] = -1;
        for (int c = 0; c < kpi; ++c) gbuf[c * plane + o] = 0.f;
      }
    }
    if (!run) return;

    // Compact the live pixels, in block-pixel order, into s_list.
    unsigned ballot[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      ballot[k] = __ballot_sync(0xffffffffu, (live >> k) & 1u);
      if (lane == 0) s_base[k * kWarps + warp] = __popc(ballot[k]);
    }
    __syncthreads();
    if (warp == 0) {                   // exclusive scan of the 32 counts
      const int own = s_base[lane];
      int sum = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, sum, d);
        if (lane >= d) sum += up;
      }
      s_base[lane] = sum - own;
      if (lane == 31) s_base[kPix * kWarps] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if ((live >> k) & 1u) {
        const int at = s_base[k * kWarps + warp]
                       + __popc(ballot[k] & ((1u << lane) - 1u));
        s_list[at] = static_cast<unsigned short>(t + k * kThreads);
      }
    }
    const int n_live = s_base[kPix * kWarps];      // >= 1: the block runs
    __syncthreads();
    // Deal them out: slot k of thread t takes list entry t + k * 256.
    wn = max(0, min(kPix, (n_live - warp * 32 + kThreads - 1) / kThreads));
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int e = t + k * kThreads;
      const bool has = e < n_live;
      src[k] = s_list[has ? e : 0];
      mine |= (has ? 1u : 0u) << k;
    }
  }

  for (int k = t; k < n_plan * 3; k += kThreads) s_plan[k] = plan[k];

  Pixels<kPeel> f;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int q = first + src[k];
    const int x = x_lo + q % tile_w, y = y_lo + q / tile_w;
    f.px[k] = static_cast<float>(x - dx);
    f.py[k] = static_cast<float>(y - dy);
    f.bd[k] = fbd[y * Wp + x];
    f.bi[k] = -1;
    if constexpr (kPeel) {
      f.pd[k] = prev_d[y * Wp + x];
      f.pi[k] = prev_i[y * Wp + x];
    }
  }

  fold_stream<kPeel, kColumn>(f, wn, order, 0, n_global[0], setup, s_row,
                              s_idx);
  fold_stream<kPeel, kColumn>(f, wn, seg_tri, starts[tile], counts[tile],
                              setup, s_row, s_idx);
  __syncthreads();                     // s_plan is visible

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if ((mine >> k) & 1u) {
      const float px = f.px[k], py = f.py[k];
      const long long o = (static_cast<long long>(py) + dy) * Wp
                          + static_cast<long long>(px) + dx;
      best_d[o] = f.bd[k];
      best_i[o] = f.bi[k];
      tile::resolve_pixel(gbuf + o, plane, f.bi[k], px, py, payload, s_plan,
                          n_plan, kp, kpi, sl_screen, sl_ia, clip_w_off);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Pointers
// are device pointers to contiguous tensors: fbd (Hp, Wp) f32; prev_d
// (Hp, Wp) f32 and prev_i (Hp, Wp) i32, both null for the opaque mode and
// both set for the peel mode; setup (N, 10) f32; order (N,), n_global (1,),
// seg_tri (L,), starts and counts (ntiles,) i32; tile_order (ntiles,) i64,
// a permutation of the tiles, the order in which blocks take them;
// tile_origin (ntiles, 2) i32, each storage tile's screen (y0, x0), or null
// for a frame stored at its screen rows; payload (N, 3*kp) f32; plan
// (n_plan, 3) i32; outputs gbuf (kpi, Hp, Wp) f32, best_d (Hp, Wp) f32,
// best_i (Hp, Wp) i32.  Any tile_h x tile_w.
extern "C" int tile_raster_launch(
    const float* fbd, const float* prev_d, const int* prev_i,
    const float* setup, const int* order, const int* n_global,
    const int* seg_tri, const int* starts, const int* counts,
    const long long* tile_order, const int* tile_origin,
    const float* payload, const int* plan,
    int n_plan, float* gbuf, float* best_d, int* best_i, int ntx, int nty,
    int tile_h, int tile_w, int kp, int kpi, int sl_screen, int sl_ia,
    int clip_w_off, cudaStream_t stream) {
  if (n_plan > kMaxPlan || tile_h <= 0 || tile_w <= 0 || ntx < 0 || nty < 0
      || (prev_d == nullptr) != (prev_i == nullptr))
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
#define TILE_RASTER_LAUNCH(PEEL, COLUMN, ORIGIN)                            \
  tile_raster_kernel<PEEL, COLUMN, ORIGIN><<<grid, kThreads, 0, stream>>>(  \
      fbd, prev_d, prev_i, setup, order, n_global, seg_tri, starts, counts, \
      tile_order, tile_origin, payload, plan, n_plan, gbuf, best_d, best_i, \
      ntx, tile_h, tile_w, Hp, Wp, blocks_per_tile, kp, kpi, sl_screen,     \
      sl_ia, clip_w_off)
  const bool column = kThreads % tile_w == 0;
  if (tile_origin == nullptr) {
    if (prev_d != nullptr) {
      TILE_RASTER_LAUNCH(true, false, false);
    } else if (column) {
      TILE_RASTER_LAUNCH(false, true, false);
    } else {
      TILE_RASTER_LAUNCH(false, false, false);
    }
  } else if (prev_d != nullptr) {
    TILE_RASTER_LAUNCH(true, false, true);
  } else if (column) {
    TILE_RASTER_LAUNCH(false, true, true);
  } else {
    TILE_RASTER_LAUNCH(false, false, true);
  }
#undef TILE_RASTER_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
