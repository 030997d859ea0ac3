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
// carried over).  -0.0 and +0.0 compare equal; a winning zero is written as
// +0.0, as the plain twin's integer keys give it.  Ids are int32, so there
// is no 2^24 limit (the TPU kernel carries them as f32).  Pixel (x, y) of
// the band is evaluated at screen row y + row_offset.
//
// What bounds it on the card: arithmetic, (globals + segment length) edge
// tests per pixel (23 FP32 operations each, tile_common.cuh:fragment); the
// bytes are a seed read and two writes per pixel and each setup row read
// once per block from L2.  The design: only (depth, id) is carried, so a
// thread holds few registers and a tile of any tile_h x tile_w is split
// over gridDim.y blocks of 256 threads x 4 pixels (as tile_kdeep.cu does),
// which keeps 132 SMs busy and balances long segments over more blocks.
// Each block stages its tile's list through shared memory 256 set-up rows
// at a time (tile_common.cuh:stage), so a row is read from device memory
// once per block and broadcast to every thread.  The TPU kernel's 128-lane
// aligned DMA base, double-buffered (16, chunk) VMEM scratch and f32 ids
// have no counterpart here.

#include "tile_common.cuh"

namespace {

using tile::kThreads;

constexpr int kPix = 4;         // pixels per thread: 1,024 per block

// Fold list[begin, begin + len) into every pixel the thread owns.
__device__ __forceinline__ void fold_list(
    float (&bd)[kPix], int (&bi)[kPix], const float (&px)[kPix],
    const float (&py)[kPix], int npix, const int* __restrict__ list,
    int begin, int len, const float* __restrict__ setup,
    float (*s_set)[kThreads], int* s_idx) {
  for (int c0 = 0; c0 < len; c0 += kThreads) {
    const int n = min(kThreads, len - c0);
    __syncthreads();                   // the previous chunk is consumed
    tile::stage(list, begin, c0, n, setup, s_set, s_idx);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const tile::Tri tri = tile::load_tri(s_set, j);
      const int idx = s_idx[j];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (k < npix) {
          float d;
          const bool inside = tile::fragment(tri, px[k], py[k], d);
          if (inside && (d > bd[k] || (d == bd[k] && idx > bi[k]))) {
            bd[k] = d;
            bi[k] = idx;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) vis_fold_kernel(
    const float* __restrict__ fbd, const float* __restrict__ setup,
    const int* __restrict__ order, const int* __restrict__ n_global,
    const int* __restrict__ seg_tri, const int* __restrict__ starts,
    const int* __restrict__ counts, float* __restrict__ best_d,
    int* __restrict__ best_i, int ntx, int tile_h, int tile_w, int Wp,
    int row_offset) {
  __shared__ float s_set[tile::kSetup][kThreads];
  __shared__ int s_idx[kThreads];

  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int tpx = tile_h * tile_w;
  const int t = threadIdx.x;
  // This block owns tile pixels [first, first + kThreads * kPix).
  const int first = blockIdx.y * kThreads * kPix;
  const int npix = max(0, min(kPix, (tpx - first - t + kThreads - 1)
                                        / kThreads));
  int off[kPix];
  float px[kPix], py[kPix], bd[kPix];
  int bi[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < npix) {
      const int q = first + t + k * kThreads;
      const int x = tx * tile_w + q % tile_w, y = ty * tile_h + q / tile_w;
      off[k] = y * Wp + x;
      px[k] = static_cast<float>(x);
      py[k] = static_cast<float>(y + row_offset);
      bd[k] = fbd[off[k]];
      bi[k] = -1;
    }
  }

  fold_list(bd, bi, px, py, npix, order, 0, n_global[0], setup, s_set,
            s_idx);
  fold_list(bd, bi, px, py, npix, seg_tri, starts[tile], counts[tile], setup,
            s_set, s_idx);

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < npix) {
      best_d[off[k]] = (bi[k] >= 0 && bd[k] == 0.f) ? 0.f : bd[k];
      best_i[off[k]] = bi[k];
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Pointers
// are device pointers to contiguous tensors: fbd (Hp, Wp) f32 with
// Hp = nty * tile_h and Wp = ntx * tile_w; setup (N, 10) f32; order (N,),
// n_global (1,), seg_tri (L,), starts and counts (ntx * nty,) i32; outputs
// best_d (Hp, Wp) f32 and best_i (Hp, Wp) i32.
extern "C" int vis_fold_launch(
    const float* fbd, const float* setup, const int* order,
    const int* n_global, const int* seg_tri, const int* starts,
    const int* counts, float* best_d, int* best_i, int ntx, int nty,
    int tile_h, int tile_w, int row_offset, cudaStream_t stream) {
  if (tile_h <= 0 || tile_w <= 0 || ntx < 0 || nty < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = ntx * nty;
  if (ntiles == 0) return 0;
  const int per_block = kThreads * kPix;
  const int blocks_y = (tile_h * tile_w + per_block - 1) / per_block;
  if (blocks_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  vis_fold_kernel<<<dim3(ntiles, blocks_y), kThreads, 0, stream>>>(
      fbd, setup, order, n_global, seg_tri, starts, counts, best_d, best_i,
      ntx, tile_h, tile_w, ntx * tile_w, row_offset);
  return static_cast<int>(cudaGetLastError());
}
