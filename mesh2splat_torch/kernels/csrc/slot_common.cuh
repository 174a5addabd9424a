// Per-slot math shared by the conversion kernels K1 (texel_rows.cu) and K2
// (fragment.cu): each slot's index within its texel-row segment (`local`),
// the texel centre, barycentrics, top-left coverage and the packed
// tap-atlas index of one conversion slot.
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

// ---- each slot's index within its texel-row segment (`local`) ----------
//
// The TPU kernels walk the slots in order and carry the last segment start
// across grid steps in SMEM (mesh2splat_tpu/ops/fragment.py _local_scan);
// blocks here run in no order. Slot allocation is triangle-ordered, so the
// key (tri, row_local) never decreases along the slots (the slots past
// `total` repeat the last key): the start of the segment of a warp's first
// slot is the first slot with its key, which the warp finds by a 32-way
// search over meta rows 0-1 (first the 32 slots before it, then the whole
// prefix). Inside the warp a max-scan of "a segment starts here" gives
// every other slot's start (per thread over its slots, then shuffles).
// Each warp works alone: no block order, no barrier, no atomics, no state
// between launches. Slot indices are int32: the wrappers take fewer than
// 2^30 slots.

constexpr unsigned WARP_FULL = 0xffffffffu;

__device__ __forceinline__ bool key_below(int32_t t, int32_t r, int32_t t0,
                                          int32_t r0) {
  return t < t0 || (t == t0 && r < r0);
}

// The first slot in [0, j0] whose key is not below (t0, r0), the key of
// slot j0: with keys that never decrease, the start of j0's segment. Called
// by a whole warp; every lane returns the result. Each round probes 32
// slots and keeps the interval between the last probe below the key and
// the next: first the 32 slots before j0, then strides over the prefix.
static __device__ int32_t segment_first(const float* __restrict__ tri_row,
                                        const float* __restrict__ row_row,
                                        int32_t j0, int32_t t0, int32_t r0) {
  const int lane = threadIdx.x & 31;
  int32_t hi = j0;  // the answer lies in [lo, hi]
  int32_t lo = max(j0 - 32, 0);
  bool near = true;
  while (lo < hi) {
    const int32_t step = near ? 1 : (hi - lo + 31) / 32;
    const int32_t p = lo + lane * step;
    bool below = false;
    if (p < hi)
      below = key_below(f2i(__ldg(tri_row + p)), f2i(__ldg(row_row + p)), t0,
                        r0);
    const unsigned m = __ballot_sync(WARP_FULL, below);
    if (m == 0) {
      // slot lo is not below: the answer is lo, or lies before the window
      hi = lo;
      if (near) lo = 0;
      near = false;
      continue;
    }
    const int32_t last = lo + (31 - __clz((int)m)) * step;
    hi = min(last + step, hi);
    lo = last + 1;
    near = false;
  }
  return hi;
}

// `local` of the SPT consecutive slots from w0 + lane * SPT, whose keys
// tri[], row[] (meta rows 0-1) the thread holds (any value past cap).
// Called by a whole warp whose first slot w0 lies below cap.
template <int SPT>
__device__ __forceinline__ void warp_slot_local(
    const float* __restrict__ tri_row, const float* __restrict__ row_row,
    int32_t w0, int32_t cap, const float (&tri)[SPT],
    const float (&row)[SPT], float (&local)[SPT]) {
  const int lane = threadIdx.x & 31;
  const int32_t base = w0 + lane * SPT;

  // the key of the slot before this thread's first
  int32_t pt = __shfl_up_sync(WARP_FULL, f2i(tri[SPT - 1]), 1);
  int32_t pr = __shfl_up_sync(WARP_FULL, f2i(row[SPT - 1]), 1);
  if (lane == 0 && w0 > 0) {
    pt = f2i(__ldg(tri_row + w0 - 1));
    pr = f2i(__ldg(row_row + w0 - 1));
  }

  // running segment start over this thread's slots (-1: none yet); lane 0
  // starts from the segment start of the warp's first slot
  int32_t m = -1;
  const bool cont = w0 > 0 && f2i(tri[0]) == pt && f2i(row[0]) == pr;
  if (__shfl_sync(WARP_FULL, cont, 0)) {
    const int32_t s0 = segment_first(
        tri_row, row_row, w0, __shfl_sync(WARP_FULL, f2i(tri[0]), 0),
        __shfl_sync(WARP_FULL, f2i(row[0]), 0));
    if (lane == 0) m = s0;
  }
  int32_t run[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int32_t j = base + s;
    const int32_t t = f2i(tri[s]), r = f2i(row[s]);
    if (j < cap && (j == 0 || t != pt || r != pr)) m = j;
    run[s] = m;
    pt = t;
    pr = r;
  }

  // the warp's exclusive max-scan of the thread totals
  int32_t inc = m;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int32_t y = __shfl_up_sync(WARP_FULL, inc, d);
    if (lane >= d) inc = max(inc, y);
  }
  int32_t pre = __shfl_up_sync(WARP_FULL, inc, 1);
  if (lane == 0) pre = -1;
#pragma unroll
  for (int s = 0; s < SPT; ++s)
    local[s] = (float)(base + s - max(pre, run[s]));
}
