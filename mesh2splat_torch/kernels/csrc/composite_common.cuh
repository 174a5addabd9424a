// Shared by the composite forward (composite.cu, K3) and backward
// (composite_bwd.cu, K4): the tile geometry, the pair-field rows, the quad
// axes from the conic, and the per-pair plane coefficients of the falloff
// power and of the quad's (u, v), so that K4 makes exactly the coverage
// decisions K3 made.
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

// One pair's plane coefficients into column r of the stage: the falloff
// power -(.5 ca dx^2 + cb dx dy + .5 cc dy^2) and the quad coordinates u, v
// expanded in the tile-local pixel basis [1, x, y, x^2, x*y, y^2], with
// mxp, myp the pair's mean relative to the tile origin.
template <int NS>
__device__ __forceinline__ void stage_planes(float (&sp)[NS][CHUNK], int r,
                                             float ca, float cb, float cc,
                                             float mxp, float myp) {
  float mjx, mjy, mnx, mny;
  axes_from_conic(ca, cb, cc, mjx, mjy, mnx, mny);
  float det = mjx * mny - mnx * mjy;
  det = fabsf(det) < 1e-12f ? 1e-12f : det;
  float rdet = 1.0f / det;
  sp[S_PW0][r] = -(0.5f * ca * mxp * mxp + cb * mxp * myp +
                   0.5f * cc * myp * myp);
  sp[S_PW1][r] = ca * mxp + cb * myp;
  sp[S_PW2][r] = -(cb * mxp + cc * myp);
  sp[S_PW3][r] = -0.5f * ca;
  sp[S_PW4][r] = cb;
  sp[S_PW5][r] = -0.5f * cc;
  sp[S_U0][r] = rdet * (mnx * myp - mny * mxp);
  sp[S_U1][r] = rdet * mny;
  sp[S_U2][r] = rdet * mnx;
  sp[S_V0][r] = rdet * (mxp * mjy - mjx * myp);
  sp[S_V1][r] = -rdet * mjy;
  sp[S_V2][r] = -rdet * mjx;
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

}  // namespace m2s_comp
