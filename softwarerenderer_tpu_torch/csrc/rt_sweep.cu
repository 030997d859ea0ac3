// Bundle sweep: Möller–Trumbore over each ray bundle's surviving clusters.
//
// Replaces softwarerenderer_tpu/ops/rt_pallas.py:_kernel.  One block per
// bundle walks the bundle's survivor list (cluster ids sorted front to back
// by entry time in the wrapper, ops/rt_sweep.py), stages each 128-triangle
// cluster's stream columns in shared memory, and tests every ray of the
// bundle against them.  Per ray it keeps:
//   * nearest mode: the lexicographic minimum of (t, global id) over every
//     live slot where Möller–Trumbore passes (rt_pallas.py:157-206), float
//     max and NOTRI on a miss, t being the winner's own value;
//   * any-hit mode: the OR of the passes (rt_pallas.py:117-155).
// The test is rt_pallas.py:93-114 operand for operand (= sim/raycast.py:
// 92-109), with inv_det a true division; the library is built with
// -fmad=false and without fast math, so every operation rounds once, as in
// the plain twin ops/rt_sweep.rt_sweep_plain.
//
// Early exits, as the TPU kernel's: any-hit stops once every ray of the
// block's group is occluded; nearest stops once every ray's best t, times
// 64, is below the next cluster's entry time quantized x64 with floor (the
// wrapper's t0q) -- every later cluster is entered no sooner, so neither a
// nearer hit nor an equal-t tie with a lower id can follow.
//
// What bounds it on the card: arithmetic.  Each (ray, triangle) test is 46
// FP32 operations on the CUDA cores (no tensor-core form), against a few
// bytes per ray read once; the triangle stream (11 words a slot) is small
// and stays in L2.  The design keeps every ray's state in registers (4 rays
// a thread, 1,024 a block), reads each staged triangle from shared memory
// as a broadcast, and skips dead slots and, with the early exits, whole
// clusters.  A bundle of more than 1,024 rays (soft shadows stack S samples
// per pixel) is swept one group of 1,024 at a time, each group with its own
// early exit.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 4;                       // rays per thread
constexpr int kGroupRays = kThreads * kRays;   // rays per block at a time
constexpr int kGroup = 128;                    // triangles per cluster
constexpr int kRows = 11;                      // stream rows
constexpr int kNoTri = 1 << 30;
constexpr float kEps = 1e-8f;                  // sim/raycast.EPSILON
constexpr int kIgnoreBackfaces = 1;
constexpr int kIgnoreFrontfaces = 2;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) rt_sweep_kernel(
    const float* __restrict__ rays, const float* __restrict__ stream,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const int* __restrict__ t0q, float* __restrict__ out_t,
    int* __restrict__ out_g, int* __restrict__ swept, int R, int Tp,
    int capb, int face_mask) {
  __shared__ float s_tri[kRows][kGroup];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int count = min(counts[b], capb);
  const int* list = lists + static_cast<long long>(b) * capb;
  const int* tq = t0q + static_cast<long long>(b) * capb;
  const float* ray = rays + static_cast<long long>(b) * 6 * R;
  const bool back = face_mask & kIgnoreBackfaces;
  const bool front = face_mask & kIgnoreFrontfaces;
  int n_swept = 0;

  for (int g0 = 0; g0 < R; g0 += kGroupRays) {
    float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
    float bt[kRays];
    int bg[kRays];
    bool live[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int r = g0 + t + k * kThreads;
      live[k] = r < R;
      const int q = live[k] ? r : 0;
      ox[k] = ray[q];
      oy[k] = ray[R + q];
      oz[k] = ray[2 * R + q];
      dx[k] = ray[3 * R + q];
      dy[k] = ray[4 * R + q];
      dz[k] = ray[5 * R + q];
      bt[k] = FLT_MAX;
      bg[k] = kAnyHit ? 0 : kNoTri;
    }

    for (int j = 0; j < count; ++j) {
      __syncthreads();                 // the previous cluster is consumed
      const long long col = static_cast<long long>(list[j]) * kGroup;
      for (int q = t; q < kRows * kGroup; q += kThreads) {
        const int row = q / kGroup, s = q % kGroup;
        s_tri[row][s] = stream[static_cast<long long>(row) * Tp + col + s];
      }
      __syncthreads();
      ++n_swept;

      for (int s = 0; s < kGroup; ++s) {
        if (!(s_tri[10][s] > 0.f)) continue;       // pad or masked slot
        const float v0x = s_tri[0][s], v0y = s_tri[1][s], v0z = s_tri[2][s];
        const float e1x = s_tri[3][s], e1y = s_tri[4][s], e1z = s_tri[5][s];
        const float e2x = s_tri[6][s], e2y = s_tri[7][s], e2z = s_tri[8][s];
        const int gid = __float_as_int(s_tri[9][s]);
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          const float pvx = dy[k] * e2z - dz[k] * e2y;
          const float pvy = dz[k] * e2x - dx[k] * e2z;
          const float pvz = dx[k] * e2y - dy[k] * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          bool ok = fabsf(det) >= kEps;
          if (back) ok = ok && det >= kEps;
          if (front) ok = ok && det <= -kEps;
          const float inv_det = 1.0f / (det == 0.f ? 1.f : det);
          const float tvx = ox[k] - v0x;
          const float tvy = oy[k] - v0y;
          const float tvz = oz[k] - v0z;
          const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
          ok = ok && u >= 0.f && u <= 1.f;
          const float qvx = tvy * e1z - tvz * e1y;
          const float qvy = tvz * e1x - tvx * e1z;
          const float qvz = tvx * e1y - tvy * e1x;
          const float v = (dx[k] * qvx + dy[k] * qvy + dz[k] * qvz) * inv_det;
          ok = ok && v >= 0.f && u + v <= 1.f;
          const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
          ok = ok && tt >= 0.f;
          if (kAnyHit) {
            if (ok) bg[k] = 1;
          } else if (ok && (tt < bt[k] || (tt == bt[k] && gid < bg[k]))) {
            bt[k] = tt;
            bg[k] = gid;
          }
        }
      }

      bool done = true;
      if (kAnyHit) {
#pragma unroll
        for (int k = 0; k < kRays; ++k) done = done && (!live[k] || bg[k]);
      } else {
        // rt_pallas.py:198-203: btmax * 64 < t0q[j + 1], with t0q as f32.
        const bool more = j + 1 < count;
        const float nxt = more ? static_cast<float>(tq[j + 1]) : 0.f;
#pragma unroll
        for (int k = 0; k < kRays; ++k)
          done = done && (!live[k] || bt[k] * 64.0f < nxt);
        done = done && more;
      }
      if (__syncthreads_and(done)) break;
    }

#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if (live[k]) {
        const long long o = static_cast<long long>(b) * R + g0 + t
                            + k * kThreads;
        out_t[o] = kAnyHit ? 0.f : bt[k];
        out_g[o] = bg[k];
      }
    }
  }
  if (swept != nullptr && t == 0) swept[b] = n_swept;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// rays (B, 6, R) f32: origin xyz, normalized direction xyz; stream
// (11, Tp) f32 with Tp a multiple of 128 (row 9 the global id's int32
// bits, row 10 the live flag); lists and t0q (B, capb) i32; counts (B,)
// i32.  Outputs out_t (B, R) f32 and out_g (B, R) i32: nearest mode the
// winner's t and global id (FLT_MAX and 2^30 on a miss), any-hit mode 0
// and the occlusion flag.  swept, when not null, (B,) i32: the clusters
// each bundle swept, summed over its groups of 1,024 rays.
extern "C" int rt_sweep_launch(const float* rays, const float* stream,
                               const int* lists, const int* counts,
                               const int* t0q, float* out_t, int* out_g,
                               int* swept, int B, int R, int Tp, int capb,
                               int any_hit, int face_mask,
                               cudaStream_t cuda_stream) {
  if (B < 0 || R < 0 || Tp % kGroup != 0 || capb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0) return 0;
  if (any_hit)
    rt_sweep_kernel<true><<<B, kThreads, 0, cuda_stream>>>(
        rays, stream, lists, counts, t0q, out_t, out_g, swept, R, Tp, capb,
        face_mask);
  else
    rt_sweep_kernel<false><<<B, kThreads, 0, cuda_stream>>>(
        rays, stream, lists, counts, t0q, out_t, out_g, swept, R, Tp, capb,
        face_mask);
  return static_cast<int>(cudaGetLastError());
}
