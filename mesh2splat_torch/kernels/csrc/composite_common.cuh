// Shared by the composite forward (composite.cu, K3), backward
// (composite_bwd.cu, K4) and the single-channel walkers (single_channel.cu,
// K5/K6): the tile geometry, the pair-field rows, the quad axes from the
// conic, and the per-pair plane coefficients of the falloff power and of
// the quad's (u, v), so that every kernel makes exactly the coverage
// decisions K3 makes. K3 and K4 also share the per-warp pixel blocks, the
// cull and the cp.async staging of a chunk's field rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace m2s_comp {

constexpr int TILE = 32;
constexpr int NPX = TILE * TILE;
constexpr int THREADS = 256;
constexpr int PPT = NPX / THREADS;  // pixels per thread
constexpr int CHUNK = 128;
constexpr int NUM_CH = 16;

// pair-field rows (render/binning.py VARIANT_FIELDS)
enum {
  F_MEAN_X = 0, F_MEAN_Y, F_CONIC_A, F_CONIC_B, F_CONIC_C,
  F_COL_R, F_COL_G, F_COL_B, F_ALPHA,
  F_NRM_X, F_NRM_Y, F_NRM_Z, F_WS_X, F_WS_Y, F_WS_Z,
  F_DEPTH, F_METAL, F_ROUGH
};

// the plane coefficients, first in every kernel's shared-memory stage
enum {
  S_PW0 = 0, S_PW1, S_PW2, S_PW3, S_PW4, S_PW5,
  S_U0, S_U1, S_U2, S_V0, S_V1, S_V2,
  S_PLANES_END
};

// ops/projection.py axes_from_conic, operation for operation
__device__ __forceinline__ void axes_from_conic(float ca, float cb, float cc,
                                                float& mjx, float& mjy,
                                                float& mnx, float& mny) {
  float det_c = ca * cc - cb * cb;
  bool ok = det_c > 1e-30f;
  float dsafe = ok ? det_c : 1.0f;
  float a = cc / dsafe;
  float b = -cb / dsafe;
  float c = ca / dsafe;
  float mid = a + c;
  float amc = a - c;
  float b2 = 2.0f * b;
  float delta = sqrtf(amc * amc + b2 * b2);
  float lam1 = 0.5f * (mid + delta);
  float lam2 = 0.5f * (mid - delta);
  float dv_den = b - c + lam1;
  dv_den = fabsf(dv_den) < 1e-12f ? 1e-12f : dv_den;
  float dvy = (-a + b + lam1) / dv_den;
  float rinv = 1.0f / sqrtf(1.0f + dvy * dvy + 1e-24f);
  float dvx = rinv;
  dvy = dvy * rinv;
  float len1 = fminf(3.0f * sqrtf(fmaxf(lam1, 0.0f)), 1024.0f);
  float len2 = fminf(3.0f * sqrtf(fmaxf(lam2, 0.0f)), 1024.0f);
  len1 = ok ? len1 : 0.0f;
  len2 = ok ? len2 : 0.0f;
  mjx = len1 * dvx;
  mjy = len1 * dvy;
  mnx = len2 * dvy;
  mny = -len2 * dvx;
}

// One pair's plane coefficients, read once from the stage for a warp's walk.
struct Planes {
  float pw0, pw1, pw2, pw3, pw4, pw5, u0, u1, u2, v0, v1, v2;
};

// One pair's plane coefficients: the falloff power
// -(.5 ca dx^2 + cb dx dy + .5 cc dy^2) and the quad coordinates u, v
// expanded in the tile-local pixel basis [1, x, y, x^2, x*y, y^2], with
// mxp, myp the pair's mean relative to the tile origin.
__device__ __forceinline__ Planes make_planes(float ca, float cb, float cc,
                                              float mxp, float myp) {
  float mjx, mjy, mnx, mny;
  axes_from_conic(ca, cb, cc, mjx, mjy, mnx, mny);
  float det = mjx * mny - mnx * mjy;
  det = fabsf(det) < 1e-12f ? 1e-12f : det;
  float rdet = 1.0f / det;
  return {-(0.5f * ca * mxp * mxp + cb * mxp * myp + 0.5f * cc * myp * myp),
          ca * mxp + cb * myp,
          -(cb * mxp + cc * myp),
          -0.5f * ca,
          cb,
          -0.5f * cc,
          rdet * (mnx * myp - mny * mxp),
          rdet * mny,
          rdet * mnx,
          rdet * (mxp * mjy - mjx * myp),
          -rdet * mjy,
          -rdet * mjx};
}

// The same into column r of a plane-major stage.
template <int NS>
__device__ __forceinline__ void stage_planes(float (&sp)[NS][CHUNK], int r,
                                             float ca, float cb, float cc,
                                             float mxp, float myp) {
  const Planes pl = make_planes(ca, cb, cc, mxp, myp);
  sp[S_PW0][r] = pl.pw0;
  sp[S_PW1][r] = pl.pw1;
  sp[S_PW2][r] = pl.pw2;
  sp[S_PW3][r] = pl.pw3;
  sp[S_PW4][r] = pl.pw4;
  sp[S_PW5][r] = pl.pw5;
  sp[S_U0][r] = pl.u0;
  sp[S_U1][r] = pl.u1;
  sp[S_U2][r] = pl.u2;
  sp[S_V0][r] = pl.v0;
  sp[S_V1][r] = pl.v1;
  sp[S_V2][r] = pl.v2;
}

// Coverage of pixel (x, y) by pair r and, where covered, its falloff g.
template <int NS>
__device__ __forceinline__ bool falloff(float (&sp)[NS][CHUNK], int r,
                                        float x, float y, float xx, float xy,
                                        float yy, float& g) {
  float pw = sp[S_PW0][r] + sp[S_PW1][r] * x + sp[S_PW2][r] * y +
             sp[S_PW3][r] * xx + sp[S_PW4][r] * xy + sp[S_PW5][r] * yy;
  float u = sp[S_U0][r] + sp[S_U1][r] * x + sp[S_U2][r] * y;
  float v = sp[S_V0][r] + sp[S_V1][r] * x + sp[S_V2][r] * y;
  if (!(fmaxf(fabsf(u), fabsf(v)) <= 1.0f)) return false;  // g == 0
  g = expf(fminf(pw, 0.0f));
  return true;
}

// ---- K3 and K4: compact per-warp pixel blocks and the per-warp cull ----
//
// The cull works on blocks of 8x4 pixels, 32 to a tile: block (bx, by)
// holds the pixels [8 bx, 8 bx + 8) x [4 by, 4 by + 4), lane l of a warp
// that walks it the pixel (l % 8, l / 8). A warp walks only the pairs of a
// chunk that the cull keeps for its block.

constexpr int CULL_W = 8;
constexpr int CULL_H = 4;
constexpr int CULL_BX = TILE / CULL_W;  // blocks across a tile
constexpr unsigned FULL_MASK = 0xffffffffu;

// Tile-local pixel index of lane's pixel in cull block (bx, by).
__device__ __forceinline__ int cull_pixel(int bx, int by, int lane) {
  return (by * CULL_H + (lane >> 3)) * TILE + bx * CULL_W + (lane & 7);
}

// The centre of a cull block's pixel centres, and its half extents.
__device__ __forceinline__ float cull_xc(int bx) {
  return (float)(bx * CULL_W) + 4.0f;
}
__device__ __forceinline__ float cull_yc(int by) {
  return (float)(by * CULL_H) + 2.0f;
}
constexpr float CULL_HX = 3.5f;
constexpr float CULL_HY = 1.5f;

// Margin of the cull, relative: CULL_EPS * (S + 1), where
// S = |c0| + 32 (|c1| + |c2|) bounds every intermediate of c0 + c1 x + c2 y
// for tile-local x, y in [0, 32]. With e = 2^-24, the coverage test's u at a
// pixel (4 roundings) lies within 4.01 e S of the exact linear value, the
// block-centre value `mid` likewise, `half` within 3 e S, the difference
// |mid| - half rounds within 2 e S, and 1 + margin within e (1 + margin).
// A pair the cull drops therefore has |u| > 1 + m - 13.02 e S - e (1 + m)
// at every pixel of the block, which is above 1 for m = 16 e (S + 1).
constexpr float CULL_EPS = 9.5367431640625e-07f;  // 2^-20 = 16 e

// False only where the plane c0 + c1 x + c2 y stays outside [-1, 1] over
// every pixel centre of the block (the plane is linear, so its range over
// the block's rectangle lies at the corners: |mid| - half). NaN keeps the
// pair. The plain mirror is render/composite.py::cull_plain.
__device__ __forceinline__ bool plane_reaches(float c0, float c1, float c2,
                                              float xc, float yc) {
  const float mid = c0 + c1 * xc + c2 * yc;
  const float half = fabsf(c1) * CULL_HX + fabsf(c2) * CULL_HY;
  const float margin =
      (fabsf(c0) + 32.0f * (fabsf(c1) + fabsf(c2)) + 1.0f) * CULL_EPS;
  return !(fabsf(mid) - half > 1.0f + margin);
}

// ---- the stage of K3 and K4: pair-major rows and the cull's planes ----
//
// Row r of the pair-major stage holds pair r's 12 plane coefficients, then
// its fields from F_COL_R on (colour and alpha; the full variant's normal,
// position, depth, metal, rough) and, for K4's chain to the gradient rows,
// its tile-local mean and conic, padded to 16-byte pieces, so a warp reads
// a walked pair with a few 16-byte broadcast loads. The cull's ballots read
// the u and v planes of 32 pairs at once, one per lane, from a plane-major
// copy. Once a chunk is staged nothing reads its field rows, so the next
// chunk's rows can land in the same buffer while the chunk is walked.

enum { C_U0 = 0, C_U1, C_U2, C_V0, C_V1, C_V2, C_END };
enum { P_COL_R = 12 };

// floats per row: 12 planes, 4 or 13 fields, (CHAIN) 5 chain terms, padding
template <int NF, bool CHAIN>
__host__ __device__ constexpr int pair_row() {
  return (12 + (NF - F_COL_R) + (CHAIN ? 5 : 0) + 3) / 4 * 4;
}

// Whether pair r may cover a pixel of the cull block centred at (xc, yc):
// its quad's u and v both reach [-1, 1] there. A degenerate pair (zero
// axes: every u and v coefficient 0) always does, as it covers every pixel.
__device__ __forceinline__ bool may_cover(const float (&uv)[C_END][CHUNK],
                                          int r, float xc, float yc) {
  return plane_reaches(uv[C_U0][r], uv[C_U1][r], uv[C_U2][r], xc, yc) &&
         plane_reaches(uv[C_V0][r], uv[C_V1][r], uv[C_V2][r], xc, yc);
}

// Stage pair r (a live row of the chunk's field rows fr) for the walks.
template <bool CHAIN, int NF, int PR>
__device__ __forceinline__ void stage_pair(float (&pp)[CHUNK][PR],
                                           float (&uv)[C_END][CHUNK],
                                           const float (&fr)[NF][CHUNK],
                                           int r, float tjf, float py0) {
  const float ca = fr[F_CONIC_A][r], cb = fr[F_CONIC_B][r],
              cc = fr[F_CONIC_C][r];
  const float mxp = fr[F_MEAN_X][r] - tjf, myp = fr[F_MEAN_Y][r] - py0;
  const Planes pl = make_planes(ca, cb, cc, mxp, myp);
  float4* row = reinterpret_cast<float4*>(pp[r]);
  row[0] = make_float4(pl.pw0, pl.pw1, pl.pw2, pl.pw3);
  row[1] = make_float4(pl.pw4, pl.pw5, pl.u0, pl.u1);
  row[2] = make_float4(pl.u2, pl.v0, pl.v1, pl.v2);
#pragma unroll
  for (int f = F_COL_R; f < NF; ++f) pp[r][P_COL_R + f - F_COL_R] = fr[f][r];
  if constexpr (CHAIN) {
    float* ch = &pp[r][P_COL_R + NF - F_COL_R];
    ch[0] = mxp;
    ch[1] = myp;
    ch[2] = ca;
    ch[3] = cb;
    ch[4] = cc;
  }
  uv[C_U0][r] = pl.u0;
  uv[C_U1][r] = pl.u1;
  uv[C_U2][r] = pl.u2;
  uv[C_V0][r] = pl.v0;
  uv[C_V1][r] = pl.v1;
  uv[C_V2][r] = pl.v2;
}

// A walked pair's planes and its first 4 values (colour and alpha) ...
template <int PR>
__device__ __forceinline__ Planes row_planes(const float (&pp)[CHUNK][PR],
                                             int r, float4& rgba) {
  const float4* row = reinterpret_cast<const float4*>(pp[r]);
  const float4 a = row[0], b = row[1], c = row[2];
  rgba = row[3];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
}

// ... and the full variant's other 9 fields, in field order from F_NRM_X.
template <int PR>
__device__ __forceinline__ void row_rest(const float (&pp)[CHUNK][PR], int r,
                                         float (&pv)[9]) {
  const float4* row = reinterpret_cast<const float4*>(pp[r]);
  const float4 a = row[4], b = row[5], c = row[6];
  pv[0] = a.x; pv[1] = a.y; pv[2] = a.z; pv[3] = a.w;
  pv[4] = b.x; pv[5] = b.y; pv[6] = b.z; pv[7] = b.w;
  pv[8] = c.x;
}

// falloff() on loaded coefficients: the same operations in the same order.
__device__ __forceinline__ bool covers(const Planes& pl, float x, float y,
                                       float& g) {
  const float xx = x * x, xy = x * y, yy = y * y;
  float pw = pl.pw0 + pl.pw1 * x + pl.pw2 * y + pl.pw3 * xx + pl.pw4 * xy +
             pl.pw5 * yy;
  float u = pl.u0 + pl.u1 * x + pl.u2 * y;
  float v = pl.v0 + pl.v1 * x + pl.v2 * y;
  if (!(fmaxf(fabsf(u), fabsf(v)) <= 1.0f)) return false;  // g == 0
  g = expf(fminf(pw, 0.0f));
  return true;
}

// K4's chain terms of a staged pair: tile-local mean and conic.
template <int NF, int PR>
__device__ __forceinline__ const float* row_chain(const float (&pp)[CHUNK][PR],
                                                  int r) {
  return &pp[r][P_COL_R + NF - F_COL_R];
}

// ---- staging a chunk's field rows with cp.async ----
//
// Rows [0, NF) of the field-major (F_pad, p) buffer, columns
// [base, base + CHUNK), into dst[NF][CHUNK], in 16-byte pieces spread over
// the block's threads, as one commit group. base is a multiple of CHUNK and
// p of CHUNK (render/binning.py pads the pair axis), so every piece is
// 16-byte aligned once the buffer is (the wrapper checks).
template <int NF>
__device__ __forceinline__ void stage_fields(float (&dst)[NF][CHUNK],
                                             const float* fields, int64_t p,
                                             int64_t base) {
  constexpr int PIECES = NF * CHUNK / 4;
  for (int i = threadIdx.x; i < PIECES; i += THREADS) {
    const int f = i / (CHUNK / 4);
    const int col = (i - f * (CHUNK / 4)) * 4;
    const uint32_t s =
        static_cast<uint32_t>(__cvta_generic_to_shared(&dst[f][col]));
    const float* g = fields + (int64_t)f * p + base + col;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(g));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace m2s_comp
