// Native GLB attribute decoding + triangle assembly (C ABI, ctypes-loaded).
//
// The reference does this work in C++ inner loops (tiny_gltf accessor reads +
// SceneManager.cpp:219-451: world-space transform bake, triangulation, flat
// normal fallback, per-face tangent fallback). The same source as the JAX
// package's (mesh2splat_tpu/csrc/glb_decode.cpp); io/gltf.py keeps a
// pure-numpy fallback.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline void normalize3(float* v) {
    float n = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) + 1e-12f;
    v[0] /= n; v[1] /= n; v[2] /= n;
}

inline void cross3(const float* a, const float* b, float* out) {
    out[0] = a[1] * b[2] - a[2] * b[1];
    out[1] = a[2] * b[0] - a[0] * b[2];
    out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
void decode_rows(const uint8_t* src, int64_t count, int ncomp, int64_t stride,
                 int normalized, float* out) {
    const float inv = normalized ? 1.0f / float((uint64_t(1) << (8 * sizeof(T) - (T(-1) < T(0) ? 1 : 0))) - 1) : 1.0f;
    for (int64_t i = 0; i < count; ++i) {
        const T* row = reinterpret_cast<const T*>(src + i * stride);
        for (int c = 0; c < ncomp; ++c) {
            float v = float(row[c]);
            out[i * ncomp + c] = normalized ? v * inv : v;
        }
    }
}

}  // namespace

extern "C" {

// componentType: 5120 i8, 5121 u8, 5122 i16, 5123 u16, 5125 u32, 5126 f32
// Returns 0 on success, -1 on unknown componentType.
int m2s_accessor_decode(const uint8_t* src, int64_t count, int ncomp,
                        int component_type, int64_t stride, int normalized,
                        float* out) {
    switch (component_type) {
        case 5120: decode_rows<int8_t>(src, count, ncomp, stride, normalized, out); return 0;
        case 5121: decode_rows<uint8_t>(src, count, ncomp, stride, normalized, out); return 0;
        case 5122: decode_rows<int16_t>(src, count, ncomp, stride, normalized, out); return 0;
        case 5123: decode_rows<uint16_t>(src, count, ncomp, stride, normalized, out); return 0;
        case 5125: decode_rows<uint32_t>(src, count, ncomp, stride, normalized, out); return 0;
        case 5126:
            for (int64_t i = 0; i < count; ++i)
                std::memcpy(out + i * ncomp, src + i * stride,
                            sizeof(float) * ncomp);
            return 0;
        default: return -1;
    }
}

// Assemble world-space triangle soup from vertex attributes + indices,
// with the reference's fallbacks:
//   - missing NORMAL  -> flat face normal (SceneManager.cpp:406-413)
//   - missing TANGENT -> per-face UV-derived tangent w/ handedness
//     (SceneManager.cpp:424-451)
// pos: (V,3); nrm: (V,3)|null; uv: (V,2)|null; tan: (V,4)|null;
// idx: (F*3,) u32; world: 16 floats row-major; normal_mat: 9 floats
// row-major. Outputs: tri_pos (F,3,3), tri_normal (F,3,3), tri_uv (F,3,2),
// tri_tangent (F,3,4).
void m2s_assemble_triangles(
    const float* pos, const float* nrm, const float* uv, const float* tan,
    const uint32_t* idx, int64_t n_faces,
    const float* world, const float* normal_mat,
    float* tri_pos, float* tri_normal, float* tri_uv, float* tri_tangent) {
    for (int64_t f = 0; f < n_faces; ++f) {
        float p[3][3];
        float t_uv[3][2] = {{0, 0}, {0, 0}, {0, 0}};
        for (int k = 0; k < 3; ++k) {
            uint32_t vi = idx[f * 3 + k];
            const float* q = pos + int64_t(vi) * 3;
            for (int r = 0; r < 3; ++r)
                p[k][r] = world[r * 4 + 0] * q[0] + world[r * 4 + 1] * q[1] +
                          world[r * 4 + 2] * q[2] + world[r * 4 + 3];
            if (uv) {
                t_uv[k][0] = uv[int64_t(vi) * 2 + 0];
                t_uv[k][1] = uv[int64_t(vi) * 2 + 1];
            }
            std::memcpy(tri_pos + (f * 3 + k) * 3, p[k], 12);
            std::memcpy(tri_uv + (f * 3 + k) * 2, t_uv[k], 8);
        }

        float e1[3] = {p[1][0] - p[0][0], p[1][1] - p[0][1], p[1][2] - p[0][2]};
        float e2[3] = {p[2][0] - p[0][0], p[2][1] - p[0][1], p[2][2] - p[0][2]};
        float fn[3];
        cross3(e1, e2, fn);
        normalize3(fn);

        if (nrm) {
            for (int k = 0; k < 3; ++k) {
                uint32_t vi = idx[f * 3 + k];
                const float* q = nrm + int64_t(vi) * 3;
                float w[3];
                for (int r = 0; r < 3; ++r)
                    w[r] = normal_mat[r * 3 + 0] * q[0] +
                           normal_mat[r * 3 + 1] * q[1] +
                           normal_mat[r * 3 + 2] * q[2];
                normalize3(w);
                std::memcpy(tri_normal + (f * 3 + k) * 3, w, 12);
            }
        } else {
            for (int k = 0; k < 3; ++k)
                std::memcpy(tri_normal + (f * 3 + k) * 3, fn, 12);
        }

        if (tan) {
            for (int k = 0; k < 3; ++k) {
                uint32_t vi = idx[f * 3 + k];
                const float* q = tan + int64_t(vi) * 4;
                float w[3];
                for (int r = 0; r < 3; ++r)
                    w[r] = world[r * 4 + 0] * q[0] + world[r * 4 + 1] * q[1] +
                           world[r * 4 + 2] * q[2];
                normalize3(w);
                float out4[4] = {w[0], w[1], w[2], q[3]};
                std::memcpy(tri_tangent + (f * 3 + k) * 4, out4, 16);
            }
        } else {
            float duv1[2] = {t_uv[1][0] - t_uv[0][0], t_uv[1][1] - t_uv[0][1]};
            float duv2[2] = {t_uv[2][0] - t_uv[0][0], t_uv[2][1] - t_uv[0][1]};
            float det = duv1[0] * duv2[1] - duv1[1] * duv2[0];
            if (std::fabs(det) < 1e-8f) det = 1.0f;
            float inv = 1.0f / det;
            float tangent[3], bitan[3];
            for (int r = 0; r < 3; ++r) {
                tangent[r] = (e1[r] * duv2[1] - e2[r] * duv1[1]) * inv;
                bitan[r] = (e2[r] * duv1[0] - e1[r] * duv2[0]) * inv;
            }
            normalize3(tangent);
            normalize3(bitan);
            float c[3];
            cross3(fn, tangent, c);
            float handed =
                (c[0] * bitan[0] + c[1] * bitan[1] + c[2] * bitan[2]) < 0
                    ? -1.0f : 1.0f;
            float out4[4] = {tangent[0], tangent[1], tangent[2], handed};
            for (int k = 0; k < 3; ++k)
                std::memcpy(tri_tangent + (f * 3 + k) * 4, out4, 16);
        }
    }
}

}  // extern "C"
