// Bundle sweep: Möller–Trumbore over each ray bundle's surviving clusters.
//
// Replaces softwarerenderer_tpu/ops/rt_pallas.py:_kernel.  Every bundle has
// a survivor list (cluster ids sorted front to back by entry time in the
// wrapper, ops/rt_sweep.py); each 128-triangle cluster of the list is staged
// in shared memory and tested against the bundle's rays.  Per ray the
// kernel keeps:
//   * nearest mode: the lexicographic minimum of (t, global id) over every
//     live slot where Möller–Trumbore passes (rt_pallas.py:157-206), float
//     max and NOTRI on a miss, t being the winner's own value;
//   * any-hit mode: the OR of the passes (rt_pallas.py:117-155).
// The test is rt_pallas.py:93-114 operand for operand (= sim/raycast.py:
// 92-109), with inv_det a true division; the library is built with
// -fmad=false and without fast math, so every operation rounds once, as in
// the plain twin ops/rt_sweep.rt_sweep_plain.
//
// What bounds it on the card: arithmetic.  Each (ray, triangle) test is 46
// FP32 operations on the CUDA cores (no tensor-core form) plus a division
// and the compares, about 70 instructions, against a few bytes per ray read
// once; the triangle stream (11 words a slot) is small and stays in L2.
// The data sheet's 67 TFLOP/s counts a fused multiply-add as two
// operations; without FMA half that bound is the most this arithmetic can
// reach.  What held the first version back was not the test but who ran
// it: one 256-thread block a bundle, in bundle order.  On a 1080p frame
// most bundles list nothing and a few list two dozen clusters, so fewer
// blocks than the card has room for did all the work, and the frame waited
// for the longest of them on one SM.
//
// The design, and what each part does about it:
//   * A part of a bundle, 32 * kRays consecutive rays (one row of a
//     32-wide bundle), is one warp and one block: its rays' state in
//     registers, its own copy of the staged cluster, its own early exit,
//     no block-wide barrier.  The fold is per ray, so any split of a
//     bundle's rays is exact.  A long bundle is spread over up to 32 SMs
//     instead of one, 32 blocks fit an SM, and a part that is done frees
//     its slot at once.  Other warps of the SM cover a warp's staging, so
//     there is no second buffer.
//   * Blocks take bundles longest list first (`order`, computed on the
//     device by the wrapper), so the long lists start in the first wave
//     and short ones fill the tail.  A part of a bundle that lists nothing
//     writes its misses and returns before it loads a ray.
//   * A part stops once its own rays are done, by the rule the TPU kernel
//     applies to the whole bundle: any-hit once every ray is occluded;
//     nearest once every ray's best t, times 64, is below the next
//     cluster's entry time quantized x64 with floor (the wrapper's t0q) --
//     every later cluster is entered no sooner, so neither a nearer hit nor
//     an equal-t tie with a lower id can follow.
//   * With the clusters' boxes a part skips a cluster that its own rays
//     cannot reach: rt_accel's interval slab test (_reach_ge / _reach_le)
//     on the part's origin and direction bounds, conservative for the same
//     reason the wrapper's test on the bundle's bounds is; and in nearest
//     mode one that it cannot enter before every ray's best hit, by the
//     early exit's own rule on the part's own entry time (best t times 64
//     below the entry time quantized x64 with floor).  The bounds
//     propagate NaN, and a part whose bounds hold a NaN skips nothing.  A skipped cluster costs a hundred instructions a warp
//     instead of 128 tests a ray.
//   * A staged slot is three 16-byte words read back as broadcast loads.
//   * A test stops after det and u where no ray of the warp is left: the
//     second half of its arithmetic (v, t and their compares) is behind a
//     warp vote.  Nothing a ray keeps is computed differently.
//
// `swept`, for the smoke's bound: per (bundle, group of 1,024 rays) the
// largest count of clusters any part went through, skipped ones included,
// before it was done -- what a block-wide exit over the group would count.
// `tested`: per bundle, the (part, cluster) pairs whose slots were tested.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRays = 1;                       // rays a lane holds
constexpr int kGroupRays = 1024;               // rays of one swept group
constexpr int kGroup = 128;                    // triangles per cluster
constexpr int kRows = 11;                      // stream rows
constexpr int kNoTri = 1 << 30;
constexpr float kEps = 1e-8f;                  // sim/raycast.EPSILON
constexpr int kIgnoreBackfaces = 1;
constexpr int kIgnoreFrontfaces = 2;
constexpr unsigned kAll = 0xffffffffu;

// torch.minimum / torch.maximum: a NaN operand gives NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1)
    v = nan_min(v, __shfl_xor_sync(kAll, v, d));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1)
    v = nan_max(v, __shfl_xor_sync(kAll, v, d));
  return v;
}

// rt_accel._reach_ge: the t-interval [t0, t1], t >= 0, on which the largest
// of x + t * s over the part (x1 + t * s1) can be >= c.
__device__ __forceinline__ void reach_ge(float x1, float s1, float c,
                                         float& t0, float& t1) {
  const bool up = s1 > 0.f, dn = s1 < 0.f, at0 = x1 >= c;
  const float tc = (c - x1) / (s1 == 0.f ? 1.f : s1);
  t0 = at0 ? 0.f : (up ? tc : FLT_MAX);
  t1 = (at0 && dn) ? tc : ((at0 || up) ? FLT_MAX : -FLT_MAX);
}

// A part's ray bounds: per axis the least and largest origin and direction.
struct Bounds {
  float olo[3], ohi[3], dlo[3], dhi[3];
  bool sane;                      // no NaN among them
};

// rt_accel._bundles_alive_entry on the part's bounds against one cluster's
// box: false when no ray of the part can reach the box; `entry` is the
// earliest time one could.  NaN propagates, and keeps the cluster.
__device__ __forceinline__ bool can_reach(const Bounds& w,
                                          const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          float& entry) {
  float t0 = 0.f, t1 = FLT_MAX;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float g0, g1, l0, l1;
    reach_ge(w.ohi[a], w.dhi[a], lo[a], g0, g1);
    reach_ge(-w.olo[a], -w.dlo[a], -hi[a], l0, l1);      // _reach_le
    t0 = nan_max(t0, nan_max(g0, l0));
    t1 = nan_min(t1, nan_min(g1, l1));
  }
  entry = t0;
  return !(t0 > t1);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kLanes, 32)
rt_sweep_kernel(
    const float* __restrict__ rays, const float* __restrict__ stream,
    const int* __restrict__ lists, const int* __restrict__ counts,
    const int* __restrict__ t0q, const long long* __restrict__ order,
    const float* __restrict__ cl_lo, const float* __restrict__ cl_hi,
    float* __restrict__ out_t, int* __restrict__ out_g,
    int* __restrict__ swept, int* __restrict__ tested, int R, int Tp,
    int capb, int face_mask, int parts, int groups) {
  // A staged slot: (v0.xyz, e1.x), (e1.yz, e2.xy), (e2.z, id, live, -).
  __shared__ float4 s_tri[kGroup][3];

  constexpr int kPart = kLanes * kRays;
  const int lane = threadIdx.x;
  const int b = static_cast<int>(order[blockIdx.x / parts]);
  const int r0 = (blockIdx.x % parts) * kPart;       // < R
  const int count = min(counts[b], capb);
  float* ot = out_t + static_cast<long long>(b) * R + r0;
  int* og = out_g + static_cast<long long>(b) * R + r0;

  if (count == 0) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int q = k * kLanes + lane;
      if (r0 + q < R) {
        ot[q] = kAnyHit ? 0.f : FLT_MAX;
        og[q] = kAnyHit ? 0 : kNoTri;
      }
    }
    return;
  }

  const int* list = lists + static_cast<long long>(b) * capb;
  const int* tq = t0q + static_cast<long long>(b) * capb;
  const float* ray = rays + static_cast<long long>(b) * 6 * R + r0;
  const bool back = face_mask & kIgnoreBackfaces;
  const bool front = face_mask & kIgnoreFrontfaces;

  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float bt[kRays];
  int bg[kRays];
  bool live[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int q0 = k * kLanes + lane;
    live[k] = r0 + q0 < R;
    const int q = live[k] ? q0 : 0;    // a lane past R stands in for ray r0
    ox[k] = ray[q];
    oy[k] = ray[R + q];
    oz[k] = ray[2 * R + q];
    dx[k] = ray[3 * R + q];
    dy[k] = ray[4 * R + q];
    dz[k] = ray[5 * R + q];
    bt[k] = FLT_MAX;
    bg[k] = kAnyHit ? 0 : kNoTri;
  }

  Bounds w;
  w.sane = false;
  if (cl_lo != nullptr) {
    float lo[6], hi[6];
    lo[0] = hi[0] = ox[0]; lo[1] = hi[1] = oy[0]; lo[2] = hi[2] = oz[0];
    lo[3] = hi[3] = dx[0]; lo[4] = hi[4] = dy[0]; lo[5] = hi[5] = dz[0];
#pragma unroll
    for (int k = 1; k < kRays; ++k) {
      const float v[6] = {ox[k], oy[k], oz[k], dx[k], dy[k], dz[k]};
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        lo[a] = nan_min(lo[a], v[a]);
        hi[a] = nan_max(hi[a], v[a]);
      }
    }
    w.sane = true;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      lo[a] = warp_min(lo[a]);
      hi[a] = warp_max(hi[a]);
      w.sane = w.sane && lo[a] == lo[a] && hi[a] == hi[a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      w.olo[a] = lo[a]; w.ohi[a] = hi[a];
      w.dlo[a] = lo[3 + a]; w.dhi[a] = hi[3 + a];
    }
  }

  int n_swept = 0, n_tested = 0;
  for (int j = 0; j < count; ++j) {
    const int cluster = list[j];
    ++n_swept;

    // Every decision below is the same in all 32 lanes.
    bool test = true;
    if (w.sane) {
      float entry;
      test = can_reach(w, cl_lo + 3 * cluster, cl_hi + 3 * cluster, entry);
      if (!kAnyHit && test) {
        // The early exit's rule below, on this part's entry time: a hit
        // at the entry time itself, or a rounding of it away, is kept.
        const float entry_q = floorf(entry * 64.0f);
        bool behind = true;            // NaN entry: false, the cluster stays
#pragma unroll
        for (int k = 0; k < kRays; ++k)
          behind = behind && (!live[k] || bt[k] * 64.0f < entry_q);
        test = !__all_sync(kAll, behind);
      }
    }

    if (test) {
      ++n_tested;
      __syncwarp();                    // the previous cluster is consumed
      const float* col = stream + static_cast<long long>(cluster) * kGroup;
      // Eleven loads in flight a lane.
#pragma unroll 1
      for (int i = 0; i < kGroup / kLanes; ++i) {
        const int s = i * kLanes + lane;
        float v[kRows];
#pragma unroll
        for (int row = 0; row < kRows; ++row)
          v[row] = col[static_cast<long long>(row) * Tp + s];
        s_tri[s][0] = make_float4(v[0], v[1], v[2], v[3]);
        s_tri[s][1] = make_float4(v[4], v[5], v[6], v[7]);
        s_tri[s][2] = make_float4(v[8], v[9], v[10], 0.f);
      }
      __syncwarp();

      for (int s = 0; s < kGroup; ++s) {
        const float4 c2 = s_tri[s][2];
        if (!(c2.z > 0.f)) continue;                 // pad or masked slot
        const float4 c0 = s_tri[s][0], c1 = s_tri[s][1];
        const float v0x = c0.x, v0y = c0.y, v0z = c0.z;
        const float e1x = c0.w, e1y = c1.x, e1z = c1.y;
        const float e2x = c1.z, e2y = c1.w, e2z = c2.x;
        const int gid = __float_as_int(c2.y);
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
          // No lane's ray is left after det and u, as for most slots of a
          // cluster: v and t could change nothing, so they are not taken.
          if (!__any_sync(kAll, ok)) continue;
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
    if (__all_sync(kAll, done)) break;
  }

#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (live[k]) {
      ot[k * kLanes + lane] = kAnyHit ? 0.f : bt[k];
      og[k * kLanes + lane] = bg[k];
    }
  }
  if (lane == 0) {
    if (swept != nullptr)
      atomicMax(swept + static_cast<long long>(b) * groups + r0 / kGroupRays,
                n_swept);
    if (tested != nullptr) atomicAdd(tested + b, n_tested);
  }
}

template <bool kAnyHit>
int launch(unsigned grid, cudaStream_t cuda_stream, const float* rays,
           const float* stream, const int* lists, const int* counts,
           const int* t0q, const long long* order, const float* cl_lo,
           const float* cl_hi, float* out_t, int* out_g, int* swept,
           int* tested, int R, int Tp, int capb, int face_mask, int parts,
           int groups) {
  // 32 one-warp blocks an SM need 32 x (6 KB + the system's 1 KB) of its
  // shared memory.
  static const cudaError_t carve = cudaFuncSetAttribute(
      rt_sweep_kernel<kAnyHit>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return static_cast<int>(carve);
  rt_sweep_kernel<kAnyHit><<<grid, kLanes, 0, cuda_stream>>>(
      rays, stream, lists, counts, t0q, order, cl_lo, cl_hi, out_t, out_g,
      swept, tested, R, Tp, capb, face_mask, parts, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// rays (B, 6, R) f32: origin xyz, normalized direction xyz; stream
// (11, Tp) f32 with Tp a multiple of 128 (row 9 the global id's int32
// bits, row 10 the live flag); lists and t0q (B, capb) i32; counts (B,)
// i32; order (B,) i64, a permutation of the bundles, the order in which
// blocks take them; cl_lo and cl_hi (Tp / 128, 3) f32, the clusters' boxes,
// both null to skip nothing.  Outputs out_t (B, R) f32 and out_g (B, R)
// i32: nearest mode the winner's t and global id (FLT_MAX and 2^30 on a
// miss), any-hit mode 0 and the occlusion flag.  swept, when not null,
// (B, ceil(R / 1024)) i32 zeros: takes per group of 1,024 rays the most
// clusters a part of it went through.  tested, when not null, (B,) i32
// zeros: takes the (part, cluster) pairs tested.
extern "C" int rt_sweep_launch(const float* rays, const float* stream,
                               const int* lists, const int* counts,
                               const int* t0q, const long long* order,
                               const float* cl_lo, const float* cl_hi,
                               float* out_t, int* out_g, int* swept,
                               int* tested, int B, int R, int Tp, int capb,
                               int any_hit, int face_mask,
                               cudaStream_t cuda_stream) {
  if (B < 0 || R < 0 || Tp % kGroup != 0 || capb < 0
      || (cl_lo == nullptr) != (cl_hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || R == 0) return 0;
  constexpr int part = kLanes * kRays;
  const long long parts = (static_cast<long long>(R) + part - 1) / part;
  if (parts * B > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(parts * B);
  const int groups = (R + kGroupRays - 1) / kGroupRays;
  const auto run = any_hit ? launch<true> : launch<false>;
  return run(grid, cuda_stream, rays, stream, lists, counts, t0q, order, cl_lo,
             cl_hi, out_t, out_g, swept, tested, R, Tp, capb, face_mask,
             static_cast<int>(parts), groups);
}
