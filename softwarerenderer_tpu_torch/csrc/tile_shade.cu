// The tile route's shading pass (ops/tile_raster.render_tile, span
// tile.shade) for the scene shaders, in one kernel: the G-buffer planes
// the tile kernel wrote to the blended color and depth of the frame.
//
// Replaces no TPU kernel: the JAX package shades the tile route's frame
// as one jnp graph after its Pallas kernel (ops/pallas_tile.py,
// render_tile_pallas), which XLA fuses.  Run eagerly, the plain twin
// (ops/tile_raster.shade_plain: frag_from_planes, the fragment shader,
// shade_rate's repeat, the blend and two selects) issues some two hundred
// ATen kernels, each reading or writing whole planes of the frame.
//
// What bounds it on the card: bytes.  A covered pixel reads its G-buffer
// channels once (4 bytes each), a few texels of the RGBA8 atlas (mostly
// from cache), its winner, depth and framebuffer, and writes color and
// depth once; the arithmetic is about a hundred operations.  The design:
//   * One thread a pixel, 32 x 8 threads a block, neighbouring threads on
//     neighbouring pixels of a row, so every plane read is coalesced; the
//     color is written as one float4.
//   * The G-buffer is read in place, (C, Hp, Wp) planes, each channel at
//     the plane index the wrapper passes (ctx["gb_slices"]); a pixel with
//     no winner reads nothing of it and takes the framebuffer.
//   * Texels through the read-only cache (__ldg).  The fetch is the one
//     part the shaders differ in: the nearest texel of the triangle's
//     region (scene_fragment_shader) or two bilinear regions mixed by the
//     8-bit mip fraction (scene_fragment_shader_trilinear), a template
//     argument; lighting, fog, the blend and the selects are shared.
//   * The uniforms (light direction and color, fog color, start and end)
//     are read through device pointers, so nothing waits for the card.
//   * shade_rate sr > 1: row y is shaded from G-buffer row (y / sr) * sr
//     and written where row y's own winner is, as the twin's repeat.
//
// Rounding: every operation is the twin's, in the twin's order, and this
// library is built with -fmad=false, so the kernel's frame equals the
// twin's bit for bit: bytes / 255 as a true division, the dot product
// left to right, lerps as a + (b - a) * t, the floored int32 modulo of
// torch.remainder, float-to-int casts as cvt.rzi (NaN to 0, saturating,
// as ATen's casts on the card), and clamps that return a NaN operand as
// ATen's do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
// Fetches (ops/tile_shade.py FETCHES) and blend modes (config.BlendMode).
constexpr int kNearestRegion = 0;
constexpr int kTrilinearRegions = 1;
constexpr int kBlendNone = 0;
constexpr int kBlendAlpha = 1;
constexpr int kBlendAdditive = 2;
constexpr int kBlendMultiply = 3;
constexpr int kPlanes = 13;

// Plane index of each channel the shaders read: color (4 planes), uv (2),
// data.world_normal (3), clip-space z, then the triangle's region (tex_oy,
// tex_ox, tex_h, tex_w) and, for the trilinear fetch, its next mip's
// region (tex_oy2, tex_ox2, tex_h2, tex_w2) and mip_frac256.
struct Planes {
  int color, uv, normal, z;
  int region[8];
  int frac;
};

// The uniforms' device pointers.
struct Uniforms {
  const float* light_direction;   // 3
  const float* light_color;       // 4
  const float* fog_color;         // 4
  const float* fog_start;         // 1
  const float* fog_end;           // 1
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// torch.remainder on int32 by a positive divisor.
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// ops/texture.wrap_uv.
__device__ __forceinline__ float wrap(float u) {
  const float frac = u - truncf(u);
  return frac < 0.0f ? frac + 1.0f : frac;
}

// A G-buffer channel holding an int32 (ATen's float-to-int cast).
__device__ __forceinline__ int as_int(float v) { return __float2int_rz(v); }

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  return make_float4(a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
                     a.z + (b.z - a.z) * t, a.w + (b.w - a.w) * t);
}

// ops/texture.atlas_fetch of the texel at region row `row`, column `col`:
// the flat index in int32 (wrapping as ATen's int32 arithmetic), clamped
// into the atlas, the bytes / 255.
__device__ __forceinline__ float4 texel(const uchar4* __restrict__ atlas,
                                        long long n, int aw, int oy, int y,
                                        int ox, int x) {
  const unsigned u = (static_cast<unsigned>(oy) + static_cast<unsigned>(y))
                         * static_cast<unsigned>(aw)
                     + (static_cast<unsigned>(ox) + static_cast<unsigned>(x));
  long long i = static_cast<int>(u);
  i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  const uchar4 q = __ldg(atlas + i);
  return make_float4(static_cast<float>(q.x) / 255.0f,
                     static_cast<float>(q.y) / 255.0f,
                     static_cast<float>(q.z) / 255.0f,
                     static_cast<float>(q.w) / 255.0f);
}

// ops/texture.sample_atlas_region.
__device__ __forceinline__ float4 nearest_region(
    const uchar4* __restrict__ atlas, long long n, int aw, int oy, int ox,
    int h, int w, float u, float v) {
  h = max(h, 1);
  w = max(w, 1);
  const int x = floor_mod(as_int(wrap(u) * static_cast<float>(w)), w);
  const int y = floor_mod(as_int(wrap(v) * static_cast<float>(h)), h);
  return texel(atlas, n, aw, oy, y, ox, x);
}

// ops/texture.sample_atlas_region_bilinear (_bilinear).
__device__ __forceinline__ float4 bilinear_region(
    const uchar4* __restrict__ atlas, long long n, int aw, int oy, int ox,
    int h, int w, float u, float v) {
  h = max(h, 1);
  w = max(w, 1);
  const float fx = wrap(u) * static_cast<float>(w) - 0.5f;
  const float fy = wrap(v) * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  const int x0i = floor_mod(as_int(x0), w);
  const int y0i = floor_mod(as_int(y0), h);
  const int x1i = floor_mod(x0i + 1, w);
  const int y1i = floor_mod(y0i + 1, h);
  const float4 top = lerp4(texel(atlas, n, aw, oy, y0i, ox, x0i),
                           texel(atlas, n, aw, oy, y0i, ox, x1i), tx);
  const float4 bot = lerp4(texel(atlas, n, aw, oy, y1i, ox, x0i),
                           texel(atlas, n, aw, oy, y1i, ox, x1i), tx);
  return lerp4(top, bot, ty);
}

// engine/renderer.scene_fragment_shader{,_trilinear}, shaders.lit_and_fogged
// and ops/raster.blend, then tile_raster.shade_plain's selects.
template <int kFetch>
__global__ void __launch_bounds__(kBlockX * kBlockY) tile_shade_kernel(
    const float* __restrict__ gbuf, long long plane, int wp,
    const int* __restrict__ best_i, const float* __restrict__ best_d,
    const float* __restrict__ fb_color, long long fc_sy, long long fc_sx,
    const float* __restrict__ fb_depth, long long fd_sy, long long fd_sx,
    const uchar4* __restrict__ atlas, long long n_texels, int aw,
    const Planes planes, const Uniforms uni, int blend, int sr,
    float4* __restrict__ out_c, float* __restrict__ out_d, int H, int W) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long at = static_cast<long long>(y) * wp + x;
  const float* fc = fb_color + y * fc_sy + x * fc_sx;
  const float4 dst = make_float4(fc[0], fc[1], fc[2], fc[3]);
  float4 color = dst;
  float depth = fb_depth[y * fd_sy + x * fd_sx];
  if (best_i[at] >= 0) {
    const float* g = gbuf + static_cast<long long>(y / sr) * sr * wp + x;
    auto ch = [&](int c) { return g[c * plane]; };
    const float u = ch(planes.uv), v = ch(planes.uv + 1);
    const int* r = planes.region;
    float4 tex;
    if (kFetch == kNearestRegion) {
      tex = nearest_region(atlas, n_texels, aw, as_int(ch(r[0])),
                           as_int(ch(r[1])), as_int(ch(r[2])),
                           as_int(ch(r[3])), u, v);
    } else {
      const float4 t0 = bilinear_region(atlas, n_texels, aw, as_int(ch(r[0])),
                                        as_int(ch(r[1])), as_int(ch(r[2])),
                                        as_int(ch(r[3])), u, v);
      const float4 t1 = bilinear_region(atlas, n_texels, aw, as_int(ch(r[4])),
                                        as_int(ch(r[5])), as_int(ch(r[6])),
                                        as_int(ch(r[7])), u, v);
      const float a = static_cast<float>(as_int(ch(planes.frac))) / 256.0f;
      tex = lerp4(t0, t1, a);
    }
    // lit_and_fogged.
    const float* ld = uni.light_direction;
    const float p0 = ch(planes.normal) * -ld[0];
    const float p1 = ch(planes.normal + 1) * -ld[1];
    const float p2 = ch(planes.normal + 2) * -ld[2];
    const float diffuse = clamp_min((p0 + p1) + p2, 0.25f);
    const float4 base = make_float4(
        ch(planes.color) * tex.x, ch(planes.color + 1) * tex.y,
        ch(planes.color + 2) * tex.z, ch(planes.color + 3) * tex.w);
    const float s = 0.1f + 0.9f * diffuse;
    const float* lc = uni.light_color;
    const float* fg = uni.fog_color;
    const float fog_end = *uni.fog_end;
    float fog = clamp01((fog_end - ch(planes.z))
                        / (fog_end - *uni.fog_start));
    fog = (fog * fog) * (3.0f - 2.0f * fog);
    const float4 src = make_float4(
        fg[0] + ((base.x * s) * lc[0] - fg[0]) * fog,
        fg[1] + ((base.y * s) * lc[1] - fg[1]) * fog,
        fg[2] + ((base.z * s) * lc[2] - fg[2]) * fog, base.w);
    if (src.w > 0.0f) {
      if (blend == kBlendAlpha) {
        const float a = src.w;
        const float b = 1.0f - a;
        color = make_float4(src.x * a + dst.x * b, src.y * a + dst.y * b,
                            src.z * a + dst.z * b, src.w * a + dst.w * b);
      } else if (blend == kBlendAdditive) {
        color = make_float4(
            clamp_max(src.x + dst.x, 1.0f), clamp_max(src.y + dst.y, 1.0f),
            clamp_max(src.z + dst.z, 1.0f), clamp_max(src.w + dst.w, 1.0f));
      } else if (blend == kBlendMultiply) {
        color = make_float4(src.x * dst.x, src.y * dst.y, src.z * dst.z,
                            src.w * dst.w);
      } else {
        color = src;
      }
      depth = best_d[at];
    }
  }
  out_c[static_cast<long long>(y) * W + x] = color;
  out_d[static_cast<long long>(y) * W + x] = depth;
}

}  // namespace

// Launches the shading pass on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for arguments it does not take.
// gbuf (C, Hp, Wp) f32 with `plane` = Hp * Wp; best_i (Hp, Wp) i32 and
// best_d (Hp, Wp) f32; fb_color (H, W, 4) f32 with element strides fc_sy,
// fc_sx and 1 (a channel), fb_depth (H, W) f32 with strides fd_sy, fd_sx;
// atlas (ah, aw, 4) u8, 4-byte aligned; planes: n_planes host ints (8 for
// the nearest fetch, 13 for the trilinear), Planes' order; the uniforms:
// device f32 pointers; out_c (H, W, 4) f32, 16-byte aligned, and out_d
// (H, W) f32.
extern "C" int tile_shade_launch(
    const float* gbuf, long long plane, int wp, const int* best_i,
    const float* best_d, const float* fb_color, long long fc_sy,
    long long fc_sx, const float* fb_depth, long long fd_sy, long long fd_sx,
    const void* atlas, int ah, int aw, const int* planes, int n_planes,
    const float* light_direction, const float* light_color,
    const float* fog_color, const float* fog_start, const float* fog_end,
    int fetch, int blend, int sr, float* out_c, float* out_d, int H, int W,
    cudaStream_t stream) {
  const int want = fetch == kNearestRegion ? 8 : kPlanes;
  if (H <= 0 || W <= 0 || W > wp || ah <= 0 || aw <= 0 || sr < 1
      || H % sr != 0 || blend < kBlendNone || blend > kBlendMultiply
      || (fetch != kNearestRegion && fetch != kTrilinearRegions)
      || n_planes != want || planes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int p[kPlanes] = {};
  for (int k = 0; k < n_planes; ++k) p[k] = planes[k];
  Planes pl;
  pl.color = p[0];
  pl.uv = p[1];
  pl.normal = p[2];
  pl.z = p[3];
  for (int k = 0; k < 8; ++k) pl.region[k] = p[4 + k];
  pl.frac = p[12];
  const Uniforms uni = {light_direction, light_color, fog_color, fog_start,
                        fog_end};
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  const dim3 block(kBlockX, kBlockY);
  const auto* texels = static_cast<const uchar4*>(atlas);
  const long long n = static_cast<long long>(ah) * aw;
  auto* oc = reinterpret_cast<float4*>(out_c);
  if (fetch == kNearestRegion)
    tile_shade_kernel<kNearestRegion><<<grid, block, 0, stream>>>(
        gbuf, plane, wp, best_i, best_d, fb_color, fc_sy, fc_sx, fb_depth,
        fd_sy, fd_sx, texels, n, aw, pl, uni, blend, sr, oc, out_d, H, W);
  else
    tile_shade_kernel<kTrilinearRegions><<<grid, block, 0, stream>>>(
        gbuf, plane, wp, best_i, best_d, fb_color, fc_sy, fc_sx, fb_depth,
        fd_sy, fd_sx, texels, n, aw, pl, uni, blend, sr, oc, out_d, H, W);
  return static_cast<int>(cudaGetLastError());
}
