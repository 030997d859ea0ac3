// Native asset-pipeline kernels (C++), loaded via ctypes.
//
// The reference consumes native code for asset import and audio through
// NuGet P/Invoke bindings (Assimp C++, SDL2 C — SURVEY.md §2); this is the
// first-party equivalent for the host-side hot paths of OUR pipeline:
// glTF accessor decoding (strided/typed → contiguous float32), node
// transform baking into vertex arrays (ModelLoader.cs:196-200 semantics:
// row-vector position transform, rotation-only normalized normals), and
// PCM volume scaling (Sounds.cs:24-38).
//
// Pure standalone C++17, no dependencies:
//   g++ -O3 -march=native -shared -fPIC -o libsrt_native.so srt_native.cpp
// Python loads it with ctypes (io_host/native.py) and falls back to the
// NumPy implementations when the library is absent.

#include <cstdint>
#include <cstddef>
#include <cmath>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// glTF accessor decode: componentType per glTF 2.0 spec, optional
// normalization of integer types, arbitrary byteStride.
// Returns 0 on success, -1 on unknown component type.
// ---------------------------------------------------------------------------
int srt_accessor_to_f32(const uint8_t* src, uint64_t count, int ncomp,
                        int component_type, uint64_t stride, int normalized,
                        float* dst) {
    for (uint64_t i = 0; i < count; ++i) {
        const uint8_t* row = src + i * stride;
        for (int c = 0; c < ncomp; ++c) {
            float v;
            switch (component_type) {
                case 5120: {  // BYTE
                    int8_t x; std::memcpy(&x, row + c, 1);
                    v = normalized ? (float)x / 127.0f : (float)x;
                    break;
                }
                case 5121: {  // UNSIGNED_BYTE
                    uint8_t x = row[c];
                    v = normalized ? (float)x / 255.0f : (float)x;
                    break;
                }
                case 5122: {  // SHORT
                    int16_t x; std::memcpy(&x, row + 2 * c, 2);
                    v = normalized ? (float)x / 32767.0f : (float)x;
                    break;
                }
                case 5123: {  // UNSIGNED_SHORT
                    uint16_t x; std::memcpy(&x, row + 2 * c, 2);
                    v = normalized ? (float)x / 65535.0f : (float)x;
                    break;
                }
                case 5125: {  // UNSIGNED_INT
                    uint32_t x; std::memcpy(&x, row + 4 * c, 4);
                    v = (float)x;
                    break;
                }
                case 5126: {  // FLOAT
                    std::memcpy(&v, row + 4 * c, 4);
                    break;
                }
                default:
                    return -1;
            }
            dst[i * ncomp + c] = v;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Bake a row-vector 4x4 world transform into positions in place:
// p' = p·M (translation in row 3) — ModelLoader.cs:196.
// m is row-major (4,4) in the framework's row-vector convention.
// ---------------------------------------------------------------------------
void srt_bake_positions(float* pos, uint64_t n, const float* m) {
    for (uint64_t i = 0; i < n; ++i) {
        float x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
        pos[3 * i]     = x * m[0] + y * m[4] + z * m[8]  + m[12];
        pos[3 * i + 1] = x * m[1] + y * m[5] + z * m[9]  + m[13];
        pos[3 * i + 2] = x * m[2] + y * m[6] + z * m[10] + m[14];
    }
}

// ---------------------------------------------------------------------------
// Bake the rotation-only part into normals and renormalize (NOT the
// inverse-transpose — faithful to ModelLoader.cs:164-200).
// ---------------------------------------------------------------------------
void srt_bake_normals(float* nrm, uint64_t n, const float* m) {
    for (uint64_t i = 0; i < n; ++i) {
        float x = nrm[3 * i], y = nrm[3 * i + 1], z = nrm[3 * i + 2];
        float nx = x * m[0] + y * m[4] + z * m[8];
        float ny = x * m[1] + y * m[5] + z * m[9];
        float nz = x * m[2] + y * m[6] + z * m[10];
        float len = std::sqrt(nx * nx + ny * ny + nz * nz);
        if (len > 0.0f) {
            nx /= len; ny /= len; nz /= len;
        }
        nrm[3 * i] = nx; nrm[3 * i + 1] = ny; nrm[3 * i + 2] = nz;
    }
}

// ---------------------------------------------------------------------------
// Software PCM volume scaling, int16 samples in place (Sounds.cs:24-38 —
// the reference mutates the sample buffer rather than using a mixer gain).
// ---------------------------------------------------------------------------
void srt_scale_pcm16(int16_t* samples, uint64_t n, float volume) {
    for (uint64_t i = 0; i < n; ++i) {
        float v = (float)samples[i] * volume;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        samples[i] = (int16_t)v;
    }
}

// ---------------------------------------------------------------------------
// Ritter bounding sphere (FrustumCuller.CalculateBoundingSphere,
// FrustumCuller.cs:59-151): 2 farthest-point passes + growth pass.
// Writes [cx, cy, cz, r] to out4.
// ---------------------------------------------------------------------------
void srt_bounding_sphere(const float* pos, uint64_t n, float* out4) {
    if (n == 0) { out4[0] = out4[1] = out4[2] = out4[3] = 0.0f; return; }
    auto dist_sq = [&](uint64_t a, const float* p) {
        float dx = pos[3 * a] - p[0], dy = pos[3 * a + 1] - p[1],
              dz = pos[3 * a + 2] - p[2];
        return dx * dx + dy * dy + dz * dz;
    };
    const float* p0 = pos;
    uint64_t i1 = 0; float best = -1.0f;
    for (uint64_t i = 0; i < n; ++i) {
        float d = dist_sq(i, p0);
        if (d > best) { best = d; i1 = i; }
    }
    const float* p1 = pos + 3 * i1;
    uint64_t i2 = 0; best = -1.0f;
    for (uint64_t i = 0; i < n; ++i) {
        float d = dist_sq(i, p1);
        if (d > best) { best = d; i2 = i; }
    }
    const float* p2 = pos + 3 * i2;
    float c[3] = {(p1[0] + p2[0]) * 0.5f, (p1[1] + p2[1]) * 0.5f,
                  (p1[2] + p2[2]) * 0.5f};
    float r = std::sqrt(best) * 0.5f;
    for (uint64_t i = 0; i < n; ++i) {
        float d = std::sqrt(dist_sq(i, c));
        if (d > r) {
            float nr = (r + d) * 0.5f;
            float k = (nr - r) / d;
            c[0] += (pos[3 * i] - c[0]) * k;
            c[1] += (pos[3 * i + 1] - c[1]) * k;
            c[2] += (pos[3 * i + 2] - c[2]) * k;
            r = nr;
        }
    }
    out4[0] = c[0]; out4[1] = c[1]; out4[2] = c[2]; out4[3] = r;
}

}  // extern "C"
