// Native PLY codec: vectorized encode/decode of the three splat PLY formats.
//
// Host-runtime counterpart of the reference's C++ parsers
// (reference: src/parsers/parsers.cpp:232-651). The same source as the JAX
// package's codec (mesh2splat_tpu/csrc/ply_codec.cpp), kept here so that
// mesh2splat_torch builds its own copy: built with the same flags, both give
// the same bytes. Exposed via a C ABI for ctypes.
//
// Layout contracts match io/ply.py exactly; its numpy writers remain the
// fallback.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr float kSHC0 = 0.28209479177387814f;

inline float inv_sigmoid(float a) {
  // f32 semantics incl. +inf at a == 1 (reference: utils.hpp:270)
  a = std::min(std::max(a, 0.0f), 1.0f);
  return -std::log(1.0f / (a + 1e-8f) - 1.0f);
}

inline uint8_t to_byte(float v) {
  float c = std::min(std::max(v, 0.0f), 1.0f);
  return static_cast<uint8_t>(std::lround(c * 255.0f));
}

struct SplatsIn {
  const float* pos;     // (n, 3)
  const float* color;   // (n, 4)
  const float* scale;   // (n, 3)
  const float* normal;  // (n, 3)
  const float* quat;    // (n, 4) wxyz
  const float* pbr;     // (n, 2)
};

}  // namespace

extern "C" {

// Record sizes (bytes per vertex) for capacity queries.
int m2s_record_size(int fmt) {
  switch (fmt) {
    case 0: return 62 * 4;  // standard 3DGS (parsers.cpp:431-514)
    case 1: return 19 * 4;  // PBR (parsers.cpp:232-316)
    case 2: return 48;      // compressed PBR (parsers.cpp:339-428)
    default: return -1;
  }
}

// Encode n splats into out (preallocated n * record_size(fmt) bytes).
// Returns bytes written, or -1 on bad fmt.
long long m2s_encode(
    int fmt, long long n, float scale_multiplier,
    const float* pos, const float* color, const float* scale,
    const float* normal, const float* quat, const float* pbr,
    unsigned char* out) {
  SplatsIn s{pos, color, scale, normal, quat, pbr};

  if (fmt == 0 || fmt == 1) {
    const int stride = (fmt == 0) ? 62 : 19;
    for (long long i = 0; i < n; ++i) {
      float* rec = reinterpret_cast<float*>(out) + i * stride;
      const float* p = s.pos + i * 3;
      const float* c = s.color + i * 4;
      const float* sc = s.scale + i * 3;
      const float* nr = s.normal + i * 3;
      const float* q = s.quat + i * 4;
      const float* pb = s.pbr + i * 2;
      int k = 0;
      rec[k++] = p[0]; rec[k++] = p[1]; rec[k++] = p[2];
      rec[k++] = nr[0]; rec[k++] = nr[1]; rec[k++] = nr[2];
      rec[k++] = (c[0] - 0.5f) / kSHC0;
      rec[k++] = (c[1] - 0.5f) / kSHC0;
      rec[k++] = (c[2] - 0.5f) / kSHC0;
      if (fmt == 0) {
        std::memset(rec + k, 0, 45 * sizeof(float));  // f_rest_0..44
        k += 45;
      } else {
        rec[k++] = pb[0];  // metallicFactor
        rec[k++] = pb[1];  // roughnessFactor
      }
      rec[k++] = inv_sigmoid(c[3]);
      rec[k++] = std::log(sc[0] * scale_multiplier);
      rec[k++] = std::log(sc[1] * scale_multiplier);
      rec[k++] = std::log(sc[2] * scale_multiplier);
      rec[k++] = q[0]; rec[k++] = q[1]; rec[k++] = q[2]; rec[k++] = q[3];
    }
    return n * stride * 4;
  }

  if (fmt == 2) {
    for (long long i = 0; i < n; ++i) {
      unsigned char* rec = out + i * 48;
      const float* p = s.pos + i * 3;
      const float* c = s.color + i * 4;
      const float* sc = s.scale + i * 3;
      const float* nr = s.normal + i * 3;
      const float* q = s.quat + i * 4;
      const float* pb = s.pbr + i * 2;

      std::memcpy(rec, p, 12);
      rec[12] = to_byte(c[0]); rec[13] = to_byte(c[1]);
      rec[14] = to_byte(c[2]); rec[15] = to_byte(c[3]);
      std::memcpy(rec + 16, q, 16);
      float logs[3] = {
          std::log(sc[0] * scale_multiplier),
          std::log(sc[1] * scale_multiplier),
          std::log(std::min(sc[0], sc[1]) * scale_multiplier),
      };
      std::memcpy(rec + 32, logs, 12);
      // octahedral encode, per-component sign (see io/ply.py rationale)
      float ax = std::fabs(nr[0]) + std::fabs(nr[1]) + std::fabs(nr[2]) + 1e-8f;
      float nx = nr[0] / ax, ny = nr[1] / ax, nz = nr[2] / ax;
      float ex, ey;
      if (nz >= 0.0f) { ex = nx; ey = ny; }
      else {
        ex = (1.0f - std::fabs(ny)) * (nx >= 0 ? 1.0f : -1.0f);
        ey = (1.0f - std::fabs(nx)) * (ny >= 0 ? 1.0f : -1.0f);
      }
      rec[44] = to_byte(ex * 0.5f + 0.5f);
      rec[45] = to_byte(ey * 0.5f + 0.5f);
      rec[46] = to_byte(pb[1]);  // roughness
      rec[47] = to_byte(pb[0]);  // metallic
    }
    return n * 48;
  }
  return -1;
}

// Decode format 0/1 body (after end_header) into splat arrays.
// props described via offsets (in floats) of each needed field; -1 = absent.
long long m2s_decode_float_body(
    long long n, int stride_floats,
    int off_xyz, int off_normal, int off_fdc, int off_opacity,
    int off_scale, int off_rot, int off_metal, int off_rough,
    const float* body,
    float* pos, float* color, float* scale,
    float* normal, float* quat, float* pbr) {
  for (long long i = 0; i < n; ++i) {
    const float* rec = body + i * stride_floats;
    std::memcpy(pos + i * 3, rec + off_xyz, 12);
    for (int k = 0; k < 3; ++k)
      color[i * 4 + k] = rec[off_fdc + k] * kSHC0 + 0.5f;
    color[i * 4 + 3] = 1.0f / (1.0f + std::exp(-rec[off_opacity]));
    for (int k = 0; k < 3; ++k)
      scale[i * 3 + k] = std::exp(rec[off_scale + k]);
    float q[4] = {rec[off_rot], rec[off_rot + 1], rec[off_rot + 2],
                  rec[off_rot + 3]};
    float qn = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12f;
    for (int k = 0; k < 4; ++k) quat[i * 4 + k] = q[k] / qn;
    if (off_normal >= 0)
      std::memcpy(normal + i * 3, rec + off_normal, 12);
    else
      std::memset(normal + i * 3, 0, 12);
    pbr[i * 2 + 0] = off_metal >= 0 ? rec[off_metal] : 0.0f;
    pbr[i * 2 + 1] = off_rough >= 0 ? rec[off_rough] : 0.0f;
  }
  return n;
}

}  // extern "C"
