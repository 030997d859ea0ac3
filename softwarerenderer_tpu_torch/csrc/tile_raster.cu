// Tile raster kernel: visibility fold, winner resolve and interpolation.
//
// Replaces softwarerenderer_tpu/ops/pallas_tile.py:_kernel with peel=False,
// the TPU kernel of the opaque frame.  For each screen tile it starts every
// pixel at (framebuffer depth, -1), folds the global triangles and then the
// tile's binned segment, keeping the lexicographic max of (depth, triangle
// id) with later ids winning ties (the reference's sequential "new >= old",
// Rasterizer.cs:546).  It then reads the winner's payload row once per pixel
// and writes the perspective-correct (pc), screen-space (pw), renormalised
// (pw3), barycentric and per-triangle (v0) channels of the G-buffer.
//
// What bounds it on the card: the fold is arithmetic, (globals + segment
// length) edge tests per pixel; the resolve is one 3*kp-float payload row
// read per pixel, a gather served from L2 (payloads are a few MB).  The
// design: one block per tile, 256 threads, each owning up to 16 pixels with
// their running (depth, id) in registers; setup rows are staged through
// shared memory 256 triangles at a time, so each is read from device memory
// once per tile and broadcast to all threads.  Only (depth, id) is carried
// during the fold, and the payload is read once at the end: the TPU
// kernel's one-hot matmul resolve, lane padding, sub-chunk predication and
// f32-carried ids are TPU shapes with no counterpart here.
//
// Arithmetic follows pallas_tile.py operand for operand (edge functions,
// barycentric depth, the cw == 0 and wsum == 0 guards, v / sqrt(lsq)); the
// library is built with -fmad=false and without fast math, so every
// operation rounds once, as in the plain PyTorch version beside it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPix = 16;     // pixels per thread: tiles up to 4096 pixels
constexpr int kSetup = 10;      // s0x s0y s1x s1y s2x s2y d0 d1 d2 ia
constexpr int kMaxPlan = 64;

enum Kind { kPc = 0, kPw = 1, kPw3 = 2, kBary = 3, kV0 = 4 };

struct Fold {
  float px[kMaxPix], py[kMaxPix], bd[kMaxPix];
  int bi[kMaxPix];
};

// Fold list[begin, begin + len) into every pixel the thread owns.
__device__ __forceinline__ void fold_stream(
    Fold& f, int npix, const int* __restrict__ list, int begin, int len,
    const float* __restrict__ setup, float (*s_set)[kThreads], int* s_idx) {
  const int t = threadIdx.x;
  for (int c0 = 0; c0 < len; c0 += kThreads) {
    const int n = min(kThreads, len - c0);
    __syncthreads();                   // the previous chunk is consumed
    if (t < n) {
      const int tri = list[begin + c0 + t];
      s_idx[t] = tri;
#pragma unroll
      for (int k = 0; k < kSetup; ++k) s_set[k][t] = setup[tri * kSetup + k];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float s0x = s_set[0][j], s0y = s_set[1][j];
      const float s1x = s_set[2][j], s1y = s_set[3][j];
      const float s2x = s_set[4][j], s2y = s_set[5][j];
      const float d0 = s_set[6][j], d1 = s_set[7][j], d2 = s_set[8][j];
      const float ia = s_set[9][j];
      const int idx = s_idx[j];
#pragma unroll
      for (int k = 0; k < kMaxPix; ++k) {
        if (k < npix) {
          const float w0 = (s1y - s2y) * (f.px[k] - s1x)
                           + (s2x - s1x) * (f.py[k] - s1y);
          const float w1 = (s2y - s0y) * (f.px[k] - s2x)
                           + (s0x - s2x) * (f.py[k] - s2y);
          const float w2 = (s0y - s1y) * (f.px[k] - s0x)
                           + (s1x - s0x) * (f.py[k] - s0y);
          const bool inside = (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f)
                              || (w0 <= 0.f && w1 <= 0.f && w2 <= 0.f);
          const float d = d0 * (w0 * ia) + d1 * (w1 * ia) + d2 * (w2 * ia);
          // NaN fails every comparison; -inf never wins (pallas_tile's
          // `has`).
          if (inside && d > -INFINITY
              && (d > f.bd[k] || (d == f.bd[k] && idx > f.bi[k]))) {
            f.bd[k] = d;
            f.bi[k] = idx;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) tile_raster_kernel(
    const float* __restrict__ fbd, const float* __restrict__ setup,
    const int* __restrict__ order, const int* __restrict__ n_global,
    const int* __restrict__ seg_tri, const int* __restrict__ starts,
    const int* __restrict__ counts, const float* __restrict__ payload,
    const int* __restrict__ plan, int n_plan, float* __restrict__ gbuf,
    float* __restrict__ best_d, int* __restrict__ best_i, int ntx,
    int tile_h, int tile_w, int Hp, int Wp, int kp, int kpi, int sl_screen,
    int sl_ia, int clip_w_off) {
  __shared__ float s_set[kSetup][kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ int s_plan[kMaxPlan * 3];

  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int tpx = tile_h * tile_w;
  const int t = threadIdx.x;
  const int npix = min(kMaxPix, (tpx - t + kThreads - 1) / kThreads);
  for (int k = t; k < n_plan * 3; k += kThreads) s_plan[k] = plan[k];

  Fold f;
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    if (k < npix) {
      const int p = t + k * kThreads;
      const int x = tx * tile_w + p % tile_w, y = ty * tile_h + p / tile_w;
      f.px[k] = static_cast<float>(x);
      f.py[k] = static_cast<float>(y);
      f.bd[k] = fbd[y * Wp + x];
      f.bi[k] = -1;
    }
  }
  fold_stream(f, npix, order, 0, n_global[0], setup, s_set, s_idx);
  fold_stream(f, npix, seg_tri, starts[tile], counts[tile], setup, s_set,
              s_idx);
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
    float* out = gbuf + o;
    if (f.bi[k] < 0) {
      for (int c = 0; c < kpi; ++c) out[c * plane] = 0.f;
      continue;
    }
    const float* r0 = payload + static_cast<long long>(f.bi[k]) * 3 * kp;
    const float* r1 = r0 + kp;
    const float* r2 = r1 + kp;
    const float ia = r0[sl_ia];
    const float s0x = r0[sl_screen], s0y = r0[sl_screen + 1];
    const float s1x = r1[sl_screen], s1y = r1[sl_screen + 1];
    const float s2x = r2[sl_screen], s2y = r2[sl_screen + 1];
    const float w0 = ((s1y - s2y) * (px - s1x) + (s2x - s1x) * (py - s1y)) * ia;
    const float w1 = ((s2y - s0y) * (px - s2x) + (s0x - s2x) * (py - s2y)) * ia;
    const float w2 = ((s0y - s1y) * (px - s0x) + (s1x - s0x) * (py - s0y)) * ia;
    const float cw0 = r0[clip_w_off], cw1 = r1[clip_w_off];
    const float cw2 = r2[clip_w_off];
    const float rcp_a = w0 / (cw0 == 0.f ? 1.f : cw0);
    const float rcp_b = w1 / (cw1 == 0.f ? 1.f : cw1);
    const float rcp_c = w2 / (cw2 == 0.f ? 1.f : cw2);
    const float wsum = rcp_a + rcp_b + rcp_c;
    const float wgt = 1.f / (wsum == 0.f ? 1.f : wsum);
    const float wa = rcp_a * wgt, wb = rcp_b * wgt, wc = rcp_c * wgt;
    int j = 0;
    for (int e = 0; e < n_plan; ++e) {
      const int kind = s_plan[3 * e], lo = s_plan[3 * e + 1];
      const int hi = s_plan[3 * e + 2];
      if (kind == kPc) {
        for (int q = lo; q < hi; ++q)
          out[(j++) * plane] = (r0[q] * rcp_a + r1[q] * rcp_b
                                + r2[q] * rcp_c) * wgt;
      } else if (kind == kPw) {
        for (int q = lo; q < hi; ++q)
          out[(j++) * plane] = r0[q] * wa + r1[q] * wb + r2[q] * wc;
      } else if (kind == kPw3) {
        const float v0 = r0[lo] * wa + r1[lo] * wb + r2[lo] * wc;
        const float v1 = r0[lo + 1] * wa + r1[lo + 1] * wb + r2[lo + 1] * wc;
        const float v2 = r0[lo + 2] * wa + r1[lo + 2] * wb + r2[lo + 2] * wc;
        const float lsq = v0 * v0 + v1 * v1 + v2 * v2;
        const float den = sqrtf(lsq > 0.f ? lsq : 1.f);
        const bool keep = lsq > 1e-6f;
        out[(j++) * plane] = keep ? v0 / den : v0;
        out[(j++) * plane] = keep ? v1 / den : v1;
        out[(j++) * plane] = keep ? v2 / den : v2;
      } else if (kind == kBary) {
        out[(j++) * plane] = wa;
        out[(j++) * plane] = wb;
        out[(j++) * plane] = wc;
      } else {                         // kV0: a per-triangle scalar
        out[(j++) * plane] = r0[lo];
      }
    }
    for (; j < kpi; ++j) out[j * plane] = 0.f;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Pointers
// are device pointers to contiguous tensors: fbd (Hp, Wp) f32; setup
// (N, 10) f32; order (N,), n_global (1,), seg_tri (L,), starts and counts
// (ntiles,) i32; payload (N, 3*kp) f32; plan (n_plan, 3) i32; outputs gbuf
// (kpi, Hp, Wp) f32, best_d (Hp, Wp) f32, best_i (Hp, Wp) i32.
extern "C" int tile_raster_launch(
    const float* fbd, const float* setup, const int* order,
    const int* n_global, const int* seg_tri, const int* starts,
    const int* counts, const float* payload, const int* plan, int n_plan,
    float* gbuf, float* best_d, int* best_i, int ntx, int nty, int tile_h,
    int tile_w, int kp, int kpi, int sl_screen, int sl_ia, int clip_w_off,
    cudaStream_t stream) {
  if (n_plan > kMaxPlan || tile_h * tile_w > kThreads * kMaxPix)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = ntx * nty;
  if (ntiles == 0) return 0;
  tile_raster_kernel<<<ntiles, kThreads, 0, stream>>>(
      fbd, setup, order, n_global, seg_tri, starts, counts, payload, plan,
      n_plan, gbuf, best_d, best_i, ntx, tile_h, tile_w, nty * tile_h,
      ntx * tile_w, kp, kpi, sl_screen, sl_ia, clip_w_off);
  return static_cast<int>(cudaGetLastError());
}
