// Shared by the tile kernels (tile_raster.cu, tile_kdeep.cu, vis_fold.cu):
// the setup-row staging as 16-float rows with the edge differences taken,
// and the winner resolve that interpolates a triangle's payload row into
// the G-buffer.
//
// Arithmetic follows softwarerenderer_tpu/ops/pallas_tile.py operand for
// operand (edge functions, barycentric depth, the cw == 0 and wsum == 0
// guards, v / sqrt(lsq)); the libraries are built with -fmad=false and
// without fast math, so every operation rounds once, as in the plain
// PyTorch versions in ops/tile_raster.py.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tile {

constexpr int kThreads = 256;
constexpr int kSetup = 10;      // s0x s0y s1x s1y s2x s2y d0 d1 d2 ia
constexpr int kMaxPlan = 64;

enum Kind { kPc = 0, kPw = 1, kPw3 = 2, kBary = 3, kV0 = 4 };

constexpr int kRow = 16;        // floats of one staged Row

// One staged triangle with the edge differences taken, so edge e at a pixel
// is a_e * (px - x_e) + b_e * (py - y_e) and the depth
// d0 * (w0 * ia) + d1 * (w1 * ia) + d2 * (w2 * ia): pallas_tile.py:162-169
// operand for operand, inside where the three edges share a sign (either
// winding), the subtractions taken once per triangle instead of once per
// pixel.
struct Row {
  float x0, y0, a0, b0;       // s1x, s1y, s1y - s2y, s2x - s1x
  float x1, y1, a1, b1;       // s2x, s2y, s2y - s0y, s0x - s2x
  float x2, y2, a2, b2;       // s0x, s0y, s0y - s1y, s1x - s0x
  float d0, d1, d2, ia;
};
static_assert(sizeof(Row) == kRow * sizeof(float), "Row is four float4");

// Stage list[begin + c0, begin + c0 + n) into shared memory as Rows, one
// triangle per thread; the caller brackets it with __syncthreads().  The
// set-up table must start on an 8-byte boundary.
__device__ __forceinline__ void stage_rows(
    const int* __restrict__ list, int begin, int c0, int n,
    const float* __restrict__ setup, float4 (*s_row)[kRow / 4], int* s_idx) {
  const int t = threadIdx.x;
  if (t < n) {
    const int tri = list[begin + c0 + t];
    s_idx[t] = tri;
    // A set-up row is 10 floats, so it starts on an 8-byte boundary.
    const float2* r = reinterpret_cast<const float2*>(
        setup + static_cast<long long>(tri) * kSetup);
    const float2 s0 = r[0], s1 = r[1], s2 = r[2], da = r[3], db = r[4];
    s_row[t][0] = make_float4(s1.x, s1.y, s1.y - s2.y, s2.x - s1.x);
    s_row[t][1] = make_float4(s2.x, s2.y, s2.y - s0.y, s0.x - s2.x);
    s_row[t][2] = make_float4(s0.x, s0.y, s0.y - s1.y, s1.x - s0.x);
    s_row[t][3] = make_float4(da.x, da.y, db.x, db.y);
  }
}

// Row j back as four 16-byte broadcast loads.
__device__ __forceinline__ Row load_row(const float4 (*s_row)[kRow / 4],
                                        int j) {
  const float4 e0 = s_row[j][0], e1 = s_row[j][1], e2 = s_row[j][2];
  const float4 dd = s_row[j][3];
  return Row{e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w,
             e2.x, e2.y, e2.z, e2.w, dd.x, dd.y, dd.z, dd.w};
}

// Interpolate winner `bi`'s payload row at pixel (px, py) into the kpi
// G-buffer channels out[c * plane]: zeros when bi < 0, else the plan's
// perspective-correct (pc), screen-space (pw), renormalised (pw3),
// barycentric and per-triangle (v0) channels, then zero padding.
__device__ __forceinline__ void resolve_pixel(
    float* out, long long plane, int bi, float px, float py,
    const float* __restrict__ payload, const int* s_plan, int n_plan,
    int kp, int kpi, int sl_screen, int sl_ia, int clip_w_off) {
  if (bi < 0) {
    for (int c = 0; c < kpi; ++c) out[c * plane] = 0.f;
    return;
  }
  const float* r0 = payload + static_cast<long long>(bi) * 3 * kp;
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
    } else {                           // kV0: a per-triangle scalar
      out[(j++) * plane] = r0[lo];
    }
  }
  for (; j < kpi; ++j) out[j * plane] = 0.f;
}

}  // namespace tile
