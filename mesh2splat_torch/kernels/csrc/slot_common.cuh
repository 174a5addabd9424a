// Per-slot math shared by the conversion kernels K1 (texel_rows.cu) and K2
// (fragment.cu): the texel centre, barycentrics, top-left coverage and the
// packed tap-atlas index of one conversion slot.
//
// Every expression repeats mesh2splat_torch/ops/fragment.py (_row_span_cols,
// _slot_uv, _tap_index) operation for operation and in the same order. The
// sources are compiled with -fmad=false and without fast math, so each
// product and sum rounds as it does in PyTorch, and fmaf() stands exactly
// where the plain version calls ops/numerics.fma (where the reference's own
// arithmetic fuses a multiply-add): the integer decisions (texel column,
// coverage, tap index) must come out identical, or a slot lands on another
// texel than the row pass budgeted for it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Record rows of the (REC_W, T_pad) record table (ops/fragment.py REC).
enum {
  R_AU = 0, R_AV, R_BU, R_BV, R_CU, R_CV,
  R_TX0, R_TY0, R_TW,
  R_UA, R_VA, R_UB, R_VB, R_UC, R_VC,
  R_MID, R_LOD,
  R_PAX, R_PAY, R_PAZ, R_PBX, R_PBY, R_PBZ, R_PCX, R_PCY, R_PCZ,
  R_NAX, R_NAY, R_NAZ, R_NBX, R_NBY, R_NBZ, R_NCX, R_NCY, R_NCZ,
  R_TAX, R_TAY, R_TAZ, R_TAW, R_TBX, R_TBY, R_TBZ, R_TBW,
  R_TCX, R_TCY, R_TCZ, R_TCW,
  R_QW, R_QX, R_QY, R_QZ,
  R_SX, R_SY, R_SZ,
  R_FR, R_FG, R_FB, R_FA,
  R_USED  // 58 rows are read; REC_W pads the table to 64
};

#define M2S_MAX_LEVELS 8

// Mip-level geometry of the tap atlas (ops/fragment.py mip_geometry):
// level l starts at atlas row off[l], each of its layers is padded to
// hw_pad[l] texels; level dimensions are (h0 >> l, w0 >> l).
struct M2SGeom {
  int32_t levels;
  int32_t h0;
  int32_t w0;
  int32_t off[M2S_MAX_LEVELS];
  int32_t hw_pad[M2S_MAX_LEVELS];
};

// float -> int32 as torch's .to(torch.int32) gives it for the values this
// code meets: truncation toward zero. Callers clamp out-of-range values first.
__device__ __forceinline__ int32_t f2i(float x) { return (int32_t)x; }

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// ceil/floor of a texel coordinate: NaN -> 0, then clamped into
// [-2^30, 2^30] before the cast, so that +-inf (a row no edge spans)
// converts the same way on every device (ops/fragment.py _to_index).
__device__ __forceinline__ int32_t to_index(float x) {
  if (x != x) x = 0.0f;
  x = fminf(fmaxf(x, -1073741824.0f), 1073741824.0f);
  return (int32_t)x;
}

// One edge's crossing of the scanline at y (the lower x only).
__device__ __forceinline__ float edge_lo(float pu, float pv, float qu,
                                         float qv, float y) {
  float den = qv - pv;
  bool span = ((pv - y) * (qv - y) <= 0.0f) && (fabsf(den) > 1e-20f);
  float tt = (y - pv) / (span ? den : 1.0f);
  float xx = fmaf(tt, qu - pu, pu);
  return span ? xx : 3e38f;
}

struct SlotUV {
  float wa, wb, wc;  // barycentrics
  float uu, vv;      // texture uv
  bool valid;        // live and covered
};

// a*wa + b*wb + c*wc of a vertex attribute (fragment.py _slot_uv lerp3)
__device__ __forceinline__ float lerp3(const SlotUV& s, float a, float b,
                                       float c) {
  return fmaf(c, s.wc, fmaf(b, s.wb, a * s.wa));
}

// rec(f) reads record row f of this slot's triangle.
template <typename Rec>
__device__ __forceinline__ SlotUV slot_uv(const Rec& rec, float row_local,
                                          float local, float live, int res) {
  const float resf = (float)res;
  int32_t tx0 = f2i(rec(R_TX0));
  int32_t tw = f2i(rec(R_TW));
  int32_t tj = f2i(rec(R_TY0)) + f2i(row_local);
  float y_s = ((float)tj + 0.5f) / resf;

  float au = rec(R_AU), av = rec(R_AV);
  float bu = rec(R_BU), bv = rec(R_BV);
  float cu = rec(R_CU), cv = rec(R_CV);

  // _row_span_cols: first covered column of the row
  float lo0 = edge_lo(au, av, bu, bv, y_s);
  float lo1 = edge_lo(bu, bv, cu, cv, y_s);
  float lo2 = edge_lo(cu, cv, au, av, y_s);
  float xlo = fminf(fminf(lo0, lo1), lo2);
  int32_t c0 = to_index(ceilf(fmaf(xlo, resf, -0.5f) - 0.01f));
  c0 = min(max(c0, tx0), tx0 + tw - 1);

  int32_t ti = c0 + f2i(local);
  float pu = ((float)ti + 0.5f) / resf;
  float pv = y_s;

  float v0u = bu - au, v0v = bv - av;
  float v1u = cu - au, v1v = cv - av;
  float v2u = pu - au, v2v = pv - av;
  float den = fmaf(v0u, v1v, -(v1u * v0v));
  float safe = fabsf(den) < 1e-20f ? 1.0f : den;
  SlotUV s;
  s.wb = fmaf(v2u, v1v, -(v1u * v2v)) / safe;
  s.wc = fmaf(v0u, v2v, -(v2u * v0v)) / safe;
  s.wa = 1.0f - s.wb - s.wc;

  // coverage with the top-left fill rule
  float sg = sign_f(den);
  auto accept = [&](float p0u, float p0v, float p1u, float p1v) {
    float wq = fmaf(p1u - p0u, pv - p0v, -((p1v - p0v) * (pu - p0u))) * sg;
    float du = (p1u - p0u) * sg;
    float dv = (p1v - p0v) * sg;
    bool tl = (dv < 0.0f) || ((dv == 0.0f) && (du < 0.0f));
    return (wq > 0.0f) || ((wq == 0.0f) && tl);
  };
  bool inside = accept(au, av, bu, bv) && accept(bu, bv, cu, cv) &&
                accept(cu, cv, au, av) && (fabsf(den) > 1e-20f);
  s.valid = (live > 0.0f) && inside;

  // the texture uv fuses the other product than lerp3 (fragment.py lerp_uv)
  s.uu = fmaf(rec(R_UC), s.wc, fmaf(rec(R_UA), s.wa, rec(R_UB) * s.wb));
  s.vv = fmaf(rec(R_VC), s.wc, fmaf(rec(R_VA), s.wa, rec(R_VB) * s.wb));
  return s;
}

struct TapIndex {
  int32_t row;  // packed atlas row
  int32_t sub;  // texel within the row, in [0, k)
  float fu, fv;  // bilinear fractions
};

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The mip level a triangle samples: its dimensions, first atlas row and
// the first texel of its material's layer.
struct TapLevel {
  int32_t lh, lw, off, base;
};

__device__ __forceinline__ TapLevel tap_level(float mid, float lod,
                                              const M2SGeom& g) {
  int32_t lvl = min(max(f2i(lod), 0), g.levels - 1);
  TapLevel l;
  l.lh = g.h0 >> lvl;
  l.lw = g.w0 >> lvl;
  l.off = g.off[lvl];
  l.base = f2i(mid) * g.hw_pad[lvl];
  return l;
}

// The texel (in the level's layer order) of the 2x2 footprint's first tap
// at (uu, vv) (REPEAT wrap), and the bilinear fractions.
__device__ __forceinline__ int32_t tap_texel(float uu, float vv,
                                             const TapLevel& l, float* fu,
                                             float* fv) {
  float uw = uu - floorf(uu);
  float vw = vv - floorf(vv);
  float u = fmaf(uw, (float)l.lw, -0.5f);
  float v = fmaf(vw, (float)l.lh, -0.5f);
  float u0 = floorf(u);
  float v0 = floorf(v);
  *fu = u - u0;
  *fv = v - v0;
  int32_t u0i = to_index(u0);
  int32_t v0i = to_index(v0);
  u0i = u0i + (u0i < 0 ? l.lw : 0);
  v0i = v0i + (v0i < 0 ? l.lh : 0);
  return l.base + v0i * l.lw + u0i;
}

// _tap_index: the 2x2 footprint at (uu, vv) in mip level lod (REPEAT wrap).
__device__ __forceinline__ TapIndex tap_index(float uu, float vv, float mid,
                                              float lod, const M2SGeom& g,
                                              int32_t k) {
  TapLevel l = tap_level(mid, lod, g);
  TapIndex t;
  int32_t texel = tap_texel(uu, vv, l, &t.fu, &t.fv);
  t.row = l.off + floor_div(texel, k);
  t.sub = texel - floor_div(texel, k) * k;
  return t;
}
