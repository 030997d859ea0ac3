// The post chain's five stages (engine/renderer.apply_post_fx), one kernel
// a stage over an (H, W, 4) float32 frame: the sky, SSAO, bloom, the tone
// map and FXAA.
//
// Replaces no TPU kernel: the JAX package writes these stages as jnp
// graphs (softwarerenderer_tpu/ops/{sky,ssao,bloom,tonemap,fxaa}.py),
// which XLA fuses.  Run eagerly, their plain twins beside the wrappers
// (ops/sky.py, ops/ssao.py, ops/bloom.py, ops/tonemap.py, ops/fxaa.py)
// issue dozens of ATen kernels a stage, every neighbour tap
// (ops/ssao.shift) an index, a clamp and two gathers over the whole frame
// and every stage a concatenation of rgb and alpha.
//
// What bounds them on the card: bytes.  Each stage reads the frame once
// (the sky and SSAO the depth too) and writes it once; the arithmetic is
// at most a few hundred operations a pixel, far below the card's rate.
// The design, and what each part does about it:
//   * One launch a stage, one pass over the frame: a block of 32 x 8
//     threads owns a 32 x 32 tile of output pixels (the sky and the tone
//     map, which read no neighbour, one pixel a thread).  Pixels are float4
//     loads and stores, neighbouring threads on neighbouring pixels.
//   * A stencil's neighbourhood sits in shared memory with a halo: SSAO's
//     linear view distances (the halo its largest radius), bloom's bright
//     pass and its blur passes (the halo the sum of its dilations), FXAA's
//     rgb and luma (a halo of 1).  Each value is computed once a tile.
//   * Every tap's index is clamped into the image before it is mapped into
//     the tile, as ops/ssao.shift clamps it: shift replicates the edge of
//     what it shifts, so bloom's passes replicate the edge of each
//     intermediate, not of the input, and a pass is computed only where the
//     image is.  Bloom's passes shrink the region they compute by each
//     dilation, ping-ponging between two buffers of three planes.
//   * Parameters are arguments: SSAO's radii and fractions, bloom's
//     dilations, threshold and strength, the exposure, FXAA's thresholds
//     and cap.  A scalar parameter comes by value, or by a device pointer
//     (a staged uniform), read by the kernel so that nothing waits for the
//     card.
//
// Rounding: every operation is the twin's, in the twin's order, and this
// library is built with -fmad=false, so each kernel's frame equals its
// twin's bit for bit.  clamp, minimum and maximum return a NaN operand as
// ATen's do; constants are the twin's Python floats rounded to float32.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
// Radii or dilations a launch takes, and the largest halo of a shared tile
// (ops/post_kernels.py MAX_TAPS and MAX_HALO).
constexpr int kMaxTaps = 8;
constexpr int kMaxHalo = 16;
constexpr int kStaticShared = 48 * 1024;
constexpr float kDepthClear = -FLT_MAX;

// A kernel parameter: __grid_constant__, so that a tap indexed at run time
// is read in place and not copied to local memory (a spill, on SSAO).
struct Taps {
  int n;
  int v[kMaxTaps];
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp01(float v) {
  return clamp(v, 0.0f, 1.0f);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.remainder on int32: the sign of the divisor.
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// ops/texture.wrap_uv.
__device__ __forceinline__ float wrap(float u) {
  const float frac = u - truncf(u);
  return frac < 0.0f ? frac + 1.0f : frac;
}

// ---------------------------------------------------------------------------
// Sky: ops/sky.composite_sky_plain (pixel_ray_directions, sample_panorama).

template <bool kU8>
__device__ __forceinline__ float4 texel(const void* pano, long long idx) {
  if (kU8) {
    const uchar4 q = static_cast<const uchar4*>(pano)[idx];
    return make_float4(static_cast<float>(q.x) / 255.0f,
                       static_cast<float>(q.y) / 255.0f,
                       static_cast<float>(q.z) / 255.0f,
                       static_cast<float>(q.w) / 255.0f);
  }
  return static_cast<const float4*>(pano)[idx];
}

__device__ __forceinline__ float lerp_channel(float a, float b, float t) {
  return a + (b - a) * t;
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  return make_float4(lerp_channel(a.x, b.x, t), lerp_channel(a.y, b.y, t),
                     lerp_channel(a.z, b.z, t), lerp_channel(a.w, b.w, t));
}

// rays: front (3), up (3), right (3), th, tw, xs (W), ys (H), as
// ops/sky.ray_basis stages them.
template <bool kU8>
__global__ void __launch_bounds__(kThreads) sky_kernel(
    const float4* __restrict__ color, const float* __restrict__ depth,
    const float* __restrict__ rays, const void* __restrict__ pano, int ph,
    int pw, float4* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long i = static_cast<long long>(y) * W + x;
  if (depth[i] != kDepthClear) {
    out[i] = color[i];
    return;
  }
  const float xt = rays[11 + x] * rays[10];
  const float yt = rays[11 + W + y] * rays[9];
  float d[3];
  for (int k = 0; k < 3; ++k)
    d[k] = (rays[k] + xt * rays[6 + k]) + yt * rays[3 + k];
  const float dot = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2];
  const float n = sqrtf(clamp_min(dot, static_cast<float>(1e-30)));
  const float dx = d[0] / n, dy = d[1] / n, dz = d[2] / n;
  const float u = 0.5f + atan2f(dx, -dz)
      * static_cast<float>(1.0 / (2.0 * 3.141592653589793));
  const float v = 0.5f - asinf(clamp(dy, -1.0f, 1.0f))
      * static_cast<float>(1.0 / 3.141592653589793);
  const float fx = wrap(u) * static_cast<float>(pw) - 0.5f;
  const float fy = wrap(v) * static_cast<float>(ph) - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  const int x0i = floor_mod(static_cast<int>(x0), pw);
  const int y0i = floor_mod(static_cast<int>(y0), ph);
  const int x1i = floor_mod(x0i + 1, pw);
  const int y1i = floor_mod(y0i + 1, ph);
  const long long last = static_cast<long long>(ph) * pw - 1;
  auto fetch = [&](int ty_, int tx_) {
    const long long idx = static_cast<long long>(ty_ * pw + tx_);
    return texel<kU8>(pano, idx < 0 ? 0 : (idx > last ? last : idx));
  };
  const float4 top = lerp4(fetch(y0i, x0i), fetch(y0i, x1i), tx);
  const float4 bot = lerp4(fetch(y1i, x0i), fetch(y1i, x1i), tx);
  out[i] = lerp4(top, bot, ty);
}

// ---------------------------------------------------------------------------
// SSAO: ops/ssao.apply_ssao_plain (linear_view_distance, compute_ssao).

// Stored depth -> linear view distance; nf = near - far and fn = far * near,
// which the twin takes once as 0-dim tensors.
__device__ __forceinline__ float view_distance(float dep, float near,
                                               float far, float nf,
                                               float fn) {
  const bool clear = dep == kDepthClear;
  const float s = clear ? -0.5f : dep;
  const float ndc = s * -2.0f - 1.0f;
  const float den = far + ndc * nf;
  const float d = fn / (den == 0.0f ? static_cast<float>(1e-9) : den);
  return clear ? far : minimum(maximum(d, near), far);
}

// The four direction pairs of ops/ssao._PAIRS, (dy, dx).
__constant__ int kPairs[4][2] = {{1, 0}, {0, 1}, {1, 1}, {1, -1}};

__global__ void __launch_bounds__(kThreads) ssao_kernel(
    const float4* __restrict__ color, const float* __restrict__ depth,
    const float* __restrict__ near_clip, const float* __restrict__ far_clip,
    const __grid_constant__ Taps radii, int halo, float range_frac,
    float bias_frac, float strength,
    float4* __restrict__ out, int H, int W) {
  extern __shared__ float smem[];
  const int sw = kTileW + 2 * halo;
  const int sh = kTileH + 2 * halo;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float near = *near_clip;
  const float far = *far_clip;
  const float nf = near - far;
  const float fn = far * near;
  for (int sy = threadIdx.y; sy < sh; sy += kBlockY) {
    const int gy = clampi(y0 - halo + sy, 0, H - 1);
    for (int sx = threadIdx.x; sx < sw; sx += kBlockX) {
      const int gx = clampi(x0 - halo + sx, 0, W - 1);
      smem[sy * sw + sx] = view_distance(
          depth[static_cast<long long>(gy) * W + gx], near, far, nf, fn);
    }
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ty = threadIdx.y; ty < kTileH && y0 + ty < H; ty += kBlockY) {
    // The shared entry of an unclamped neighbour holds the clamped one's
    // distance, so taps index the tile directly.
    const float* c = &smem[(ty + halo) * sw + threadIdx.x + halo];
    const float d = *c;
    float ao = 0.0f;
    int taps = 0;
    for (int k = 0; k < radii.n; ++k) {
      const int r = radii.v[k];
      const float rng = clamp_min(d * range_frac * static_cast<float>(r),
                                  static_cast<float>(1e-6));
      const float bias = d * bias_frac;
      for (int p = 0; p < 4; ++p) {
        const int off = kPairs[p][0] * r * sw + kPairs[p][1] * r;
        const float gp = d - c[off];
        const float gm = d - c[-off];
        const float gap = minimum(gp, gm);
        float occ = clamp01((gap - bias) / rng);
        occ = occ * clamp01(2.0f - occ);
        ao = ao + occ;
        ++taps;
      }
    }
    ao = clamp01(ao * 2.0f / static_cast<float>(taps));
    const long long i = static_cast<long long>(y0 + ty) * W + x;
    const float f = depth[i] != kDepthClear ? 1.0f - ao * strength : 1.0f;
    const float4 px = color[i];
    out[i] = make_float4(px.x * f, px.y * f, px.z * f, px.w);
  }
}

// ---------------------------------------------------------------------------
// Bloom: ops/bloom.apply_bloom_plain (compute_bloom, _blur121).

// One [1, 2, 1] / 4 pass of the three planes of src into dst over image
// rows [ylo, yhi) and columns [xlo, xhi), taps (dy, dx) away, each clamped
// into the image; (oy, ox) is the image place of the tile's entry (0, 0).
__device__ __forceinline__ void blur_pass(const float* src, float* dst,
                                          int plane, int sw, int oy, int ox,
                                          int ylo, int yhi, int xlo, int xhi,
                                          int dy, int dx, int H, int W) {
  for (int gy = ylo + static_cast<int>(threadIdx.y); gy < yhi;
       gy += kBlockY) {
    const int row = (gy - oy) * sw - ox;
    const int lo_row = (clampi(gy - dy, 0, H - 1) - oy) * sw - ox;
    const int hi_row = (clampi(gy + dy, 0, H - 1) - oy) * sw - ox;
    for (int gx = xlo + static_cast<int>(threadIdx.x); gx < xhi;
         gx += kBlockX) {
      const int s = row + gx;
      const int lo = lo_row + clampi(gx - dx, 0, W - 1);
      const int hi = hi_row + clampi(gx + dx, 0, W - 1);
      for (int ch = 0; ch < 3; ++ch) {
        const float* a = src + ch * plane;
        dst[ch * plane + s] = (((a[lo] + a[s]) + a[s]) + a[hi]) * 0.25f;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) bloom_kernel(
    const float4* __restrict__ color, const __grid_constant__ Taps dilations,
    int halo,
    const float* __restrict__ threshold_ptr, float threshold_value,
    const float* __restrict__ strength_ptr, float strength_value,
    float4* __restrict__ out, int H, int W) {
  extern __shared__ float smem[];
  const int sw = kTileW + 2 * halo;
  const int plane = (kTileH + 2 * halo) * sw;
  float* buf[2] = {smem, smem + 3 * plane};
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int oy = y0 - halo;
  const int ox = x0 - halo;
  // The rows and columns a stage computes: the tile and what the passes
  // after it still read around it (rv rows, rh columns), in the image.
  int rv = halo, rh = halo;
  auto ylo = [&] { return max(0, y0 - rv); };
  auto yhi = [&] { return min(H, y0 + kTileH + rv); };
  auto xlo = [&] { return max(0, x0 - rh); };
  auto xhi = [&] { return min(W, x0 + kTileW + rh); };
  const float thr = threshold_ptr ? *threshold_ptr : threshold_value;
  for (int gy = ylo() + static_cast<int>(threadIdx.y); gy < yhi();
       gy += kBlockY) {
    for (int gx = xlo() + static_cast<int>(threadIdx.x); gx < xhi();
         gx += kBlockX) {
      const float4 c = color[static_cast<long long>(gy) * W + gx];
      const int s = (gy - oy) * sw + (gx - ox);
      buf[0][s] = clamp_min(c.x - thr, 0.0f);
      buf[0][plane + s] = clamp_min(c.y - thr, 0.0f);
      buf[0][2 * plane + s] = clamp_min(c.z - thr, 0.0f);
    }
  }
  __syncthreads();
  int cur = 0;
  for (int k = 0; k < dilations.n; ++k) {
    const int d = dilations.v[k];
    rv -= abs(d);
    blur_pass(buf[cur], buf[cur ^ 1], plane, sw, oy, ox, ylo(), yhi(), xlo(),
              xhi(), d, 0, H, W);
    __syncthreads();
    cur ^= 1;
    rh -= abs(d);
    blur_pass(buf[cur], buf[cur ^ 1], plane, sw, oy, ox, ylo(), yhi(), xlo(),
              xhi(), 0, d, H, W);
    __syncthreads();
    cur ^= 1;
  }
  const float strength = strength_ptr ? *strength_ptr : strength_value;
  const float* glow = buf[cur];
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ty = threadIdx.y; ty < kTileH && y0 + ty < H; ty += kBlockY) {
    const long long i = static_cast<long long>(y0 + ty) * W + x;
    const int s = (ty + halo) * sw + threadIdx.x + halo;
    const float4 c = color[i];
    out[i] = make_float4(clamp01(c.x + strength * glow[s]),
                         clamp01(c.y + strength * glow[plane + s]),
                         clamp01(c.z + strength * glow[2 * plane + s]), c.w);
  }
}

// ---------------------------------------------------------------------------
// Tone map: ops/tonemap.apply_tonemap_plain, Reinhard (mode 0) or
// Narkowicz's ACES fit (mode 1) over max(rgb, 0) * exposure.

__device__ __forceinline__ float tone(float x, int mode, float exposure) {
  const float v = clamp_min(x, 0.0f) * exposure;
  if (mode == 0) return v / (v + 1.0f);
  const float num = v * (v * static_cast<float>(2.51)
                         + static_cast<float>(0.03));
  const float den = v * (v * static_cast<float>(2.43)
                         + static_cast<float>(0.59))
      + static_cast<float>(0.14);
  return clamp01(num / den);
}

__global__ void __launch_bounds__(kThreads) tonemap_kernel(
    const float4* __restrict__ color, int mode,
    const float* __restrict__ exposure_ptr, float exposure_value,
    float4* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
      + threadIdx.x;
  if (i >= n) return;
  const float e = exposure_ptr ? *exposure_ptr : exposure_value;
  const float4 c = color[i];
  out[i] = make_float4(tone(c.x, mode, e), tone(c.y, mode, e),
                       tone(c.z, mode, e), c.w);
}

// ---------------------------------------------------------------------------
// FXAA: ops/fxaa.apply_fxaa_plain.

constexpr int kFxaaW = kTileW + 2;
constexpr int kFxaaH = kTileH + 2;

__device__ __forceinline__ float luma(float4 c) {
  return (c.x * static_cast<float>(0.299) + c.y * static_cast<float>(0.587))
      + c.z * static_cast<float>(0.114);
}

__global__ void __launch_bounds__(kThreads) fxaa_kernel(
    const float4* __restrict__ color, float abs_threshold,
    float rel_threshold, float subpix_cap, float4* __restrict__ out, int H,
    int W) {
  __shared__ float4 rgb[kFxaaH][kFxaaW];
  __shared__ float lum[kFxaaH][kFxaaW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  for (int sy = threadIdx.y; sy < kFxaaH; sy += kBlockY) {
    const int gy = clampi(y0 - 1 + sy, 0, H - 1);
    for (int sx = threadIdx.x; sx < kFxaaW; sx += kBlockX) {
      const int gx = clampi(x0 - 1 + sx, 0, W - 1);
      const float4 c = color[static_cast<long long>(gy) * W + gx];
      rgb[sy][sx] = c;
      lum[sy][sx] = luma(c);
    }
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const int sx = threadIdx.x + 1;
  for (int ty = threadIdx.y; ty < kTileH && y0 + ty < H; ty += kBlockY) {
    const int sy = ty + 1;
    const float c = lum[sy][sx];
    const float n = lum[sy - 1][sx];
    const float s = lum[sy + 1][sx];
    const float e = lum[sy][sx + 1];
    const float w = lum[sy][sx - 1];
    const float lmax = maximum(c, maximum(maximum(n, s), maximum(e, w)));
    const float lmin = minimum(c, minimum(minimum(n, s), minimum(e, w)));
    const float contrast = lmax - lmin;
    const bool active = contrast >= clamp_min(lmax * rel_threshold,
                                              abs_threshold);
    const float avg4 = (((n + s) + e) + w) * 0.25f;
    float amount = clamp01(fabsf(avg4 - c)
                           / clamp_min(contrast, static_cast<float>(1e-6)));
    amount = amount * amount * (3.0f - amount * 2.0f);
    amount = clamp_max(amount * amount, subpix_cap);
    const bool horiz = fabsf(((n + s) - c) - c) >= fabsf(((e + w) - c) - c);
    const float4 a = horiz ? rgb[sy - 1][sx] : rgb[sy][sx + 1];
    const float4 b = horiz ? rgb[sy + 1][sx] : rgb[sy][sx - 1];
    const float t = active ? amount : 0.0f;
    const float4 px = rgb[sy][sx];
    out[static_cast<long long>(y0 + ty) * W + x] = make_float4(
        px.x + ((a.x + b.x) * 0.5f - px.x) * t,
        px.y + ((a.y + b.y) * 0.5f - px.y) * t,
        px.z + ((a.z + b.z) * 0.5f - px.z) * t, px.w);
  }
}

bool taps_of(const int* values, int n, Taps* taps, int* halo, bool sum) {
  if (n < 0 || n > kMaxTaps || (n > 0 && values == nullptr)) return false;
  taps->n = n;
  *halo = 0;
  for (int k = 0; k < n; ++k) {
    taps->v[k] = values[k];
    const int a = values[k] < 0 ? -values[k] : values[k];
    if (a > kMaxHalo) return false;
    *halo = sum ? *halo + a : (a > *halo ? a : *halo);
  }
  return *halo <= kMaxHalo;
}

dim3 tile_grid(int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
}

}  // namespace

// Each entry launches its stage on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for arguments it does not take.
// color and out are (H, W, 4) f32 and 16-byte aligned, depth (H, W) f32;
// a scalar given by pointer (a device f32) is read in place of its value.

// pano (ph, pw, 4) u8 (pano_u8 = 1) or f32; rays (11 + W + H,) f32.
extern "C" int post_sky_launch(const float* color, const float* depth,
                               const float* rays, const void* pano, int ph,
                               int pw, int pano_u8, float* out, int H, int W,
                               cudaStream_t stream) {
  if (H <= 0 || W <= 0 || ph <= 0 || pw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  const dim3 block(kBlockX, kBlockY);
  const auto* c = reinterpret_cast<const float4*>(color);
  auto* o = reinterpret_cast<float4*>(out);
  if (pano_u8)
    sky_kernel<true><<<grid, block, 0, stream>>>(c, depth, rays, pano, ph,
                                                 pw, o, H, W);
  else
    sky_kernel<false><<<grid, block, 0, stream>>>(c, depth, rays, pano, ph,
                                                  pw, o, H, W);
  return static_cast<int>(cudaGetLastError());
}

// near_clip and far_clip: device f32 scalars; radii: n_radii host ints.
extern "C" int post_ssao_launch(const float* color, const float* depth,
                                const float* near_clip, const float* far_clip,
                                const int* radii, int n_radii,
                                float range_frac, float bias_frac,
                                float strength, float* out, int H, int W,
                                cudaStream_t stream) {
  Taps taps;
  int halo;
  if (H <= 0 || W <= 0 || !taps_of(radii, n_radii, &taps, &halo, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(float) * (kTileW + 2 * halo)
      * (kTileH + 2 * halo);
  ssao_kernel<<<tile_grid(H, W), dim3(kBlockX, kBlockY), shared, stream>>>(
      reinterpret_cast<const float4*>(color), depth, near_clip, far_clip,
      taps, halo, range_frac, bias_frac, strength,
      reinterpret_cast<float4*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

// dilations: n_dilations host ints.
extern "C" int post_bloom_launch(const float* color, const int* dilations,
                                 int n_dilations, const float* threshold,
                                 float threshold_value, const float* strength,
                                 float strength_value, float* out, int H,
                                 int W, cudaStream_t stream) {
  Taps taps;
  int halo;
  if (H <= 0 || W <= 0
      || !taps_of(dilations, n_dilations, &taps, &halo, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(float) * 6 * (kTileW + 2 * halo)
      * (kTileH + 2 * halo);
  if (shared > kStaticShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        bloom_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bloom_kernel<<<tile_grid(H, W), dim3(kBlockX, kBlockY), shared, stream>>>(
      reinterpret_cast<const float4*>(color), taps, halo, threshold,
      threshold_value, strength, strength_value,
      reinterpret_cast<float4*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

// mode 0 Reinhard, 1 ACES; n pixels.
extern "C" int post_tonemap_launch(const float* color, int mode,
                                   const float* exposure,
                                   float exposure_value, float* out,
                                   long long n, cudaStream_t stream) {
  if (n <= 0 || (mode != 0 && mode != 1)
      || (n + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  tonemap_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(color), mode, exposure, exposure_value,
      reinterpret_cast<float4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int post_fxaa_launch(const float* color, float abs_threshold,
                                float rel_threshold, float subpix_cap,
                                float* out, int H, int W,
                                cudaStream_t stream) {
  if (H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fxaa_kernel<<<tile_grid(H, W), dim3(kBlockX, kBlockY), 0, stream>>>(
      reinterpret_cast<const float4*>(color), abs_threshold, rel_threshold,
      subpix_cap, reinterpret_cast<float4*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
