// Visibility fold: the per-pixel (depth, triangle id) winner of every tile's
// global list and binned segment, with no payload.
//
// Replaces softwarerenderer_tpu/ops/pallas_raster.py:_fold_kernel, the
// visibility pass behind raster.render_deferred's binned LESS_EQUAL frames.
// Every pixel starts at (framebuffer depth, -1) and keeps the lexicographic
// max of (depth, triangle id) over the fragments that cover it, later ids
// winning ties (the reference's "new >= old", Rasterizer.cs:546).  Its
// admit rule is the TPU kernel's (pallas_raster.py:144-155), not the tile
// kernel's: a fragment at -inf is taken where the seed is -inf too (its
// id beats -1), and a fragment at exactly the seed's depth beats the seed.
// A NaN fragment fails both compares and never wins (the TPU kernel's
// chunk-wide max lets one void its 128-lane chunk, a DMA artefact not
// carried over); a NaN seed keeps its pixel.  -0.0 and +0.0 compare equal;
// a winning zero is written as +0.0, as the plain twin's integer keys give
// it.  Ids are int32, so there is no 2^24 limit (the TPU kernel carries
// them as f32).  Pixel (x, y) is evaluated at screen (x, y), or, with a
// tile origin map, at its storage tile's screen origin (y0, x0) plus its
// place in the tile: a band of a sharded frame (parallel/sharding.py), a
// contiguous band at a row offset being the map (row_offset + ty * tile_h,
// tx * tile_w).  The map changes where a pixel is evaluated, never where
// it is stored.
//
// What bounds it on the card: operations, (globals + segment length) edge
// tests per pixel (23 FP32 operations each); the bytes are a seed read and
// two writes per pixel and each setup row read once per block from L2.
// The frame's lists are uneven (on the 1080p bench frame the mean tile
// folds 117 triangles and the busiest 1,015), so a grid of one block per
// 1,024 pixels of a tile ends on its busiest tile's blocks.  Splitting
// them gains 14-15 % there (PERF.md section 6): the rest is the
// rate at which the SMs execute the fold's instructions, about 32 a test.
// The design, and what each part does about it:
//   * K1's fold (csrc/tile_raster.cu): 256 threads own 1,024 pixels of a
//     tile, 4 a thread; set-up rows staged through shared memory as
//     16-float Rows read back as four 16-byte broadcasts; where 256 is a
//     multiple of tile_w a thread's pixels share a column and each edge's
//     a * (px - x) is taken once per triangle; the depth and its compares
//     sit behind a branch that a triangle covering none of the thread's
//     pixels skips.
//   * Split lists.  A tile's globals and then its segment are one logical
//     list, cut into parts of part_len triangles.  A work item is (tile,
//     1,024-pixel block, part); the items of the longest tiles come first.
//     The list is the tile order (tile_raster.tile_order, computed by the
//     wrapper) and each tile's first item, which a one-block plan kernel
//     launched just before the fold computes on the device, with no host
//     read (ops/vis_fold.py:fold_items is its plain twin).  An item that
//     is its tile's only part starts from the seed and writes its pixels,
//     as the unsplit kernel did.  The parts of a split tile start from
//     (-inf, -1), which every non-NaN fragment beats, fold into
//     registers, and each does a 64-bit atomicMax of the twin's key,
//     _ordered(depth) << 32 | (id + 1) with -0.0 folded into +0.0
//     (ops/raster.py:fold_keys under LESS_EQUAL), on every pixel where it
//     found a fragment; keys are stored with the sign bit flipped, so the
//     signed order is the unsigned one and 0 lies below every key.  Each
//     part then counts itself in at its (tile, block) counter after a
//     __threadfence(); the last to arrive takes every pixel's merged key
//     with atomicExch (resetting it to 0), decodes it as raster.decode_keys
//     does, lets it beat the seed where its depth is >= the seed's (so a
//     NaN seed keeps its pixel), writes best_d and best_i and resets its
//     counter.
//   * A persistent grid: as many blocks as the occupancy API fits on the
//     card (4 an SM).  Block b takes item b first, so the first wave lies
//     on the SMs as a grid of one block an item would (the busiest tile's
//     blocks on different SMs); then each block pulls the next item from a
//     device counter until they run out, and the last block to leave
//     resets the counter.  Pulling every item from the counter let the
//     blocks of one SM take consecutive items, the busiest tile's four
//     blocks among them: the unsplit fold took 0.51-0.62 ms, and 0.31 ms
//     with the first wave in block order (chip_smoke.py phase 14's bench
//     frame, H100).  The number of items
//     depends on n_global and counts, which live on the device, so the
//     grid is never sized from a host read.
//
// Scratch, owned by the caller, zero before the launch and zero again after
// it: keys, one u64 per padded pixel (Hp x Wp x 8 bytes: 16.7 MB at
// 1920 x 1088); arrivals, one i32 per (tile, block); work, two i32.  The
// work list, (tiles + 1) i32, is written by the plan kernel every launch.
//
// The TPU kernel's 128-lane aligned DMA base, double-buffered (16, chunk)
// VMEM scratch and f32 ids have no counterpart here.

#include <float.h>
#include <limits.h>

#include "tile_common.cuh"

namespace {

using tile::kRow;
using tile::kThreads;
using tile::load_row;
using tile::Row;
using tile::stage_rows;

constexpr int kPix = 4;                     // pixels per thread
constexpr int kBlockPx = kThreads * kPix;   // pixels per block
// Stored keys: the signed key with its sign bit flipped.
constexpr unsigned long long kFlip = 1ull << 63;

struct Pixels {
  float px[kPix], py[kPix], bd[kPix];
  int bi[kPix];
};

// Fold list[begin, begin + len) into the first wn pixel slots of the
// thread; wn is the same for every lane of a warp, and every thread stages
// and reaches every barrier.  The arithmetic is the staged Row's
// (tile_common.cuh), operation for operation, as in
// csrc/tile_raster.cu:fold_stream;
// the admit rule is this kernel's.
template <bool kColumn>
__device__ __forceinline__ void fold_stream(
    Pixels& f, int wn, const int* __restrict__ list, int begin, int len,
    const float* __restrict__ setup, float4 (*s_row)[kRow / 4],
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
          // NaN fails both compares.
          if (d > f.bd[k] || (d == f.bd[k] && idx > f.bi[k])) {
            f.bd[k] = d;
            f.bi[k] = idx;
          }
        }
      }
    }
  }
}

// The stored key of fragment (d, idx): raster.fold_keys under LESS_EQUAL,
// sign bit flipped.
__device__ __forceinline__ unsigned long long stored_key(float d, int idx) {
  const int bits = __float_as_int(d == 0.f ? 0.f : d);
  const int ordered = bits < 0 ? bits ^ 0x7FFFFFFF : bits;
  return ((static_cast<unsigned long long>(static_cast<unsigned>(ordered))
           << 32) | static_cast<unsigned>(idx + 1)) ^ kFlip;
}

// The launch bound caps registers at 64, so 4 blocks (32 warps) fit an SM.
// kColumn: kThreads is a multiple of tile_w, so the pixels t + k * 256 of
// a thread lie in one column.  kOrigin: tile_origin maps each storage tile
// to its screen origin; the map's pointer stays live through the
// persistent loop, so a mapped instantiation takes 3 blocks an SM rather
// than spill, and the unmapped ones are the kernel as it was.
template <bool kColumn, bool kOrigin>
__global__ void __launch_bounds__(kThreads, kOrigin ? 3 : 4) vis_fold_kernel(
    const float* __restrict__ fbd, const float* __restrict__ setup,
    const int* __restrict__ order, const int* __restrict__ n_global,
    const int* __restrict__ seg_tri, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const long long* __restrict__ tile_order,
    const int* __restrict__ tile_origin,
    const int* __restrict__ first_item, float* __restrict__ best_d,
    int* __restrict__ best_i, unsigned long long* __restrict__ keys,
    int* __restrict__ arrivals, int* __restrict__ work, int ntx,
    int ntiles, int tile_h, int tile_w, int Wp, int part_len,
    int blocks_per_tile) {
  __shared__ float4 s_row[kThreads][kRow / 4];
  __shared__ int s_idx[kThreads];
  __shared__ int s_item;
  __shared__ int s_last;

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int tpx = tile_h * tile_w;
  const int ng = n_global[0];
  const int total = first_item[ntiles];

  for (bool first_wave = true;; first_wave = false) {
    __syncthreads();                   // the previous item is done with
    if (t == 0)                        // shared memory
      s_item = first_wave ? static_cast<int>(blockIdx.x)
                          : static_cast<int>(gridDim.x)
                                + atomicAdd(&work[0], 1);
    __syncthreads();
    const int item = s_item;
    if (item >= total) break;

    // The item's place in the tile order: the last j with first_item[j]
    // <= item (every tile has at least one item, so j is unique).
    int lo = 0, hi = ntiles;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (first_item[mid] <= item) lo = mid; else hi = mid;
    }
    const int tile = static_cast<int>(tile_order[lo]);
    const int local = item - first_item[lo];
    const int nparts = (first_item[lo + 1] - first_item[lo])
                       / blocks_per_tile;
    const int part = local / blocks_per_tile;
    const int blk = local - part * blocks_per_tile;
    const bool split = nparts > 1;
    const int ty = tile / ntx, tx = tile - ty * ntx;
    const int x_lo = tx * tile_w, y_lo = ty * tile_h;
    // The tile's screen origin when mapped (else its storage place).
    int sx_lo = 0, sy_lo = 0;
    if constexpr (kOrigin) {
      sx_lo = tile_origin[2 * tile + 1];
      sy_lo = tile_origin[2 * tile];
    }
    // This block owns tile pixels [first, first + kBlockPx); first < tpx.
    const int first = blk * kBlockPx;
    const int wn = max(0, min(kPix, (tpx - first - warp * 32 + kThreads - 1)
                                        / kThreads));

    // Slot k holds tile pixel first + t + k * 256 where `mine` has bit k,
    // else a stand-in pixel of the block that is folded and never written.
    Pixels f;
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int s = t + k * kThreads;
      const bool has = first + s < tpx;
      const int q = first + (has ? s : 0);
      const int x = x_lo + q % tile_w, y = y_lo + q / tile_w;
      if constexpr (kOrigin) {
        f.px[k] = static_cast<float>(sx_lo + q % tile_w);
        f.py[k] = static_cast<float>(sy_lo + q / tile_w);
      } else {
        f.px[k] = static_cast<float>(x);
        f.py[k] = static_cast<float>(y);
      }
      f.bd[k] = split ? -INFINITY : fbd[y * Wp + x];
      f.bi[k] = -1;
      mine |= (has ? 1u : 0u) << k;
    }

    // Part `part` of the list: entries [p0, p1), the globals (order) below
    // ng and the segment (seg_tri from starts[tile]) from ng on.
    const int len = ng + counts[tile];
    const int p0 = part * part_len;
    const int p1 = len - p0 <= part_len ? len : p0 + part_len;
    const int g1 = min(p1, ng), s0 = max(p0, ng);
    fold_stream<kColumn>(f, wn, order, p0, max(0, g1 - p0), setup, s_row,
                         s_idx);
    fold_stream<kColumn>(f, wn, seg_tri, starts[tile] + s0 - ng,
                         max(0, p1 - s0), setup, s_row, s_idx);

    if (!split) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if ((mine >> k) & 1u) {
          const int q = first + t + k * kThreads;
          const int o = (y_lo + q / tile_w) * Wp + x_lo + q % tile_w;
          best_d[o] = (f.bi[k] >= 0 && f.bd[k] == 0.f) ? 0.f : f.bd[k];
          best_i[o] = f.bi[k];
        }
      }
      continue;
    }

    // A part of a split tile: publish, count in, and the last one merges.
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (((mine >> k) & 1u) && f.bi[k] >= 0) {
        const int q = first + t + k * kThreads;
        const int o = (y_lo + q / tile_w) * Wp + x_lo + q % tile_w;
        atomicMax(&keys[o], stored_key(f.bd[k], f.bi[k]));
      }
    }
    __threadfence();
    __syncthreads();
    const int slot = tile * blocks_per_tile + blk;
    if (t == 0) s_last = atomicAdd(&arrivals[slot], 1) == nparts - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if ((mine >> k) & 1u) {
        const int q = first + t + k * kThreads;
        const int o = (y_lo + q / tile_w) * Wp + x_lo + q % tile_w;
        const unsigned long long u = atomicExch(&keys[o], 0ull);
        float d = fbd[o];
        int i = -1;
        if (u != 0ull) {
          const unsigned long long key = u ^ kFlip;
          const int ordered = static_cast<int>(
              static_cast<unsigned>(key >> 32));
          const float kd = __int_as_float(ordered < 0 ? ordered ^ 0x7FFFFFFF
                                                      : ordered);
          if (kd >= d) {               // false for a NaN seed
            d = kd;
            i = static_cast<int>(static_cast<unsigned>(key)) - 1;
          }
        }
        best_d[o] = d;
        best_i[o] = i;
      }
    }
    if (t == 0) arrivals[slot] = 0;
  }

  // Every block has drawn past the last item: the last one out resets the
  // counter for the next launch.
  if (t == 0 && atomicAdd(&work[1], 1) == static_cast<int>(gridDim.x) - 1) {
    work[0] = 0;
    work[1] = 0;
  }
}

constexpr int kPlanThreads = 1024;

// The work list, one block: first_item[j + 1] - first_item[j] is the
// number of items of the tile at position j of tile_order, its parts
// max(1, ceil((n_global + counts[tile]) / part_len)) times blocks_per_tile,
// and first_item[0] = 0 (ops/vis_fold.py:fold_items is its plain twin).
// Thread t sums a run of consecutive positions; a scan of the 1,024 sums
// gives each run its base.
__global__ void __launch_bounds__(kPlanThreads) vis_fold_plan_kernel(
    const long long* __restrict__ tile_order, const int* __restrict__ counts,
    const int* __restrict__ n_global, int ntiles, int part_len,
    int blocks_per_tile, int* __restrict__ first_item) {
  __shared__ int s_warp[kPlanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (ntiles + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(ntiles, t * per), hi = min(ntiles, lo + per);
  const long long ng = n_global[0];
  auto items = [&](int j) {
    const long long len = ng + counts[tile_order[j]];
    return static_cast<int>(len <= 0 ? 1 : (len - 1) / part_len + 1)
           * blocks_per_tile;
  };
  int own = 0;
  for (int j = lo; j < hi; ++j) own += items(j);
  int sum = own;                     // inclusive scan in the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, sum, d);
    if (lane >= d) sum += up;
  }
  if (lane == 31) s_warp[warp] = sum;
  __syncthreads();
  if (warp == 0) {                   // inclusive scan of the warps' sums
    int w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int base = sum - own + (warp > 0 ? s_warp[warp - 1] : 0);
  if (t == 0) first_item[0] = 0;
  for (int j = lo; j < hi; ++j) {
    base += items(j);
    first_item[j + 1] = base;
  }
}

template <bool kColumn, bool kOrigin>
int blocks_per_sm(int* per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, vis_fold_kernel<kColumn, kOrigin>, kThreads, 0));
}

template <bool kColumn, bool kOrigin>
int launch(const float* fbd, const float* setup, const int* order,
           const int* n_global, const int* seg_tri, const int* starts,
           const int* counts, const long long* tile_order,
           const int* tile_origin, int* first_item, float* best_d,
           int* best_i, unsigned long long* keys, int* arrivals, int* work,
           int ntx, int ntiles, int tile_h, int tile_w, int Wp, int part_len,
           int blocks_per_tile, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = static_cast<cudaError_t>(
        blocks_per_sm<kColumn, kOrigin>(&per_sm));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms * per_sm <= 0) return static_cast<int>(cudaErrorInvalidValue);
  vis_fold_plan_kernel<<<1, kPlanThreads, 0, stream>>>(
      tile_order, counts, n_global, ntiles, part_len, blocks_per_tile,
      first_item);
  vis_fold_kernel<kColumn, kOrigin>
      <<<sms * per_sm, kThreads, 0, stream>>>(
      fbd, setup, order, n_global, seg_tri, starts, counts, tile_order,
      tile_origin, first_item, best_d, best_i, keys, arrivals, work, ntx,
      ntiles, tile_h, tile_w, Wp, part_len, blocks_per_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success).  Pointers
// are device pointers to contiguous tensors: fbd (Hp, Wp) f32 with
// Hp = nty * tile_h and Wp = ntx * tile_w; setup (N, 10) f32; order (N,),
// n_global (1,), seg_tri (L,), starts and counts (ntx * nty,) i32;
// tile_order (ntx * nty,) i64 (tile_raster.tile_order); tile_origin
// (ntx * nty, 2) i32, each storage tile's screen (y0, x0), or null for
// tiles at their own place; first_item (ntx * nty + 1,) i32 scratch for
// the work list at this part_len, whose last entry, the number of items,
// must fit an int (the plan kernel writes it); outputs best_d (Hp, Wp) f32
// and best_i (Hp, Wp) i32; scratch keys (Hp * Wp,) u64, arrivals (ntx * nty *
// ceil(tile_h * tile_w / 1024),) i32 and work (2,) i32, all zero, left zero.
extern "C" int vis_fold_launch(
    const float* fbd, const float* setup, const int* order,
    const int* n_global, const int* seg_tri, const int* starts,
    const int* counts, const long long* tile_order, const int* tile_origin,
    int* first_item, float* best_d, int* best_i, unsigned long long* keys,
    int* arrivals, int* work, int ntx, int nty, int tile_h, int tile_w,
    int part_len, cudaStream_t stream) {
  if (tile_h <= 0 || tile_w <= 0 || ntx < 0 || nty < 0 || part_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = static_cast<long long>(ntx) * nty;
  if (ntiles == 0) return 0;
  const long long tpx = static_cast<long long>(tile_h) * tile_w;
  const long long per_tile = (tpx + kBlockPx - 1) / kBlockPx;
  const long long Wp = static_cast<long long>(ntx) * tile_w;
  if (tpx > INT_MAX || ntiles * per_tile > INT_MAX
      || Wp * nty * tile_h > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
#define VIS_FOLD_ARGS                                                       \
  fbd, setup, order, n_global, seg_tri, starts, counts, tile_order,         \
      tile_origin, first_item, best_d, best_i, keys, arrivals, work, ntx,   \
      static_cast<int>(ntiles), tile_h, tile_w, static_cast<int>(Wp),       \
      part_len, static_cast<int>(per_tile), stream
  const bool column = kThreads % tile_w == 0;
  int err;
  if (tile_origin == nullptr)
    err = column ? launch<true, false>(VIS_FOLD_ARGS)
                 : launch<false, false>(VIS_FOLD_ARGS);
  else
    err = column ? launch<true, true>(VIS_FOLD_ARGS)
                 : launch<false, true>(VIS_FOLD_ARGS);
#undef VIS_FOLD_ARGS
  return err;
}

// The work list alone (what vis_fold_launch builds before its fold), for
// checking it against its twin: tile_order (ntiles,) i64 and counts
// (ntiles,), n_global (1,) i32 in; first_item (ntiles + 1,) i32 out.
extern "C" int vis_fold_plan_launch(const long long* tile_order,
                                    const int* counts, const int* n_global,
                                    int ntiles, int part_len,
                                    int blocks_per_tile, int* first_item,
                                    cudaStream_t stream) {
  if (ntiles <= 0 || part_len <= 0 || blocks_per_tile <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  vis_fold_plan_kernel<<<1, kPlanThreads, 0, stream>>>(
      tile_order, counts, n_global, ntiles, part_len, blocks_per_tile,
      first_item);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the fold an SM holds (the occupancy API), for tile_w dividing
// 256 (column = 1) or not, with a tile origin map (origin = 1) or without;
// a negative CUDA error code on failure.
extern "C" int vis_fold_blocks_per_sm(int column, int origin) {
  int per_sm = 0;
  const int err = origin ? (column ? blocks_per_sm<true, true>(&per_sm)
                                   : blocks_per_sm<false, true>(&per_sm))
                         : (column ? blocks_per_sm<true, false>(&per_sm)
                                   : blocks_per_sm<false, false>(&per_sm));
  return err ? -err : per_sm;
}
