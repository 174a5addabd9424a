// K2 fragment_apply (forward): the per-slot fragment shader of conversion.
// Top-left coverage at the texel centre, barycentric lerps of position,
// normal, tangent and texture uv, the bilinear mix of the slot's 2x2 taps
// (bf16 pairs unpacked in-kernel), TBN normal mapping, the colour factor,
// metallic-roughness, quat and scale -> 20 output rows per slot.
//
// Replaces the Pallas kernel B of mesh2splat_tpu/ops/fragment.py::
// fragment_apply / _fragment_fwd_impl (both its window-DMA and gather
// variants), with its local_in_kernel mode: LOCAL computes each slot's
// index within its texel-row segment (`local`) from meta rows 0-1, as K1
// does (slot_common.cuh, warp_slot_local), writes it into meta row 2 and
// uses it; otherwise `local` is read from row 2. Plain version:
// mesh2splat_torch/ops/fragment.py::fragment_apply_plain (index_select of
// the tap columns, slot_local when local_in_kernel, then _fragment_math).
//
// Taps. The TPU kernel reads taps that an XLA gather wrote first
// (atlasT[:, rows], one column per slot), because a Pallas TPU kernel
// cannot fetch one column per lane. Here each slot reads its own column
// `rows[slot]` of the tap atlas, and of it only the 4*TAPS_C fields of its
// sub-texel group: no gathered copy of the taps exists in device memory.
// The atlas may be field-major ((F, n_cols) contiguous: a warp's lanes read
// neighbouring columns of one field row) or row-major (its (n_cols, F)
// transpose contiguous: a slot's group is 160 contiguous bytes of f32, read
// as 16-byte vectors). Without `rows` the column is the slot itself: the
// taps were gathered by the caller, as the TPU kernel takes them.
//
// Bound on the H100: bytes by the roofline's count (per slot its meta
// floats, its row index, the atlas groups the run touches, 20 floats
// written), but a slot's arithmetic is long and exact (seven IEEE
// divisions, four IEEE reciprocal square roots with a normal map), and
// what holds the kernel is latency: each slot's chain of dependent loads
// and divisions. Design: one slot a thread in 128-thread blocks, with
// registers capped at 64 so that 8 blocks share an SM; each block stages
// the 58 record fields of its triangle range in shared memory, slot-major,
// once (slots are sorted by triangle, ~78 slots a triangle at bench size),
// so a slot reads them by 32-bit shared loads at fixed offsets instead of
// 58 global loads with 64-bit addresses. A block whose range is wider than
// TRI_CAP triangles, or whose slots leave it (keys that decrease), reads
// the records through L1 by triangle id instead. Outputs are written with
// streaming stores. (PERF.md section 6 gives the variants measured: 2 or 4
// slots a thread with vector meta loads and stores, no staging, other
// block sizes and register caps, plain stores.) In LOCAL each warp of 32
// slots scans alone; the search for its first slot's segment start reads
// keys the warps before it have just read, mostly from cache. The TPU's
// record-window DMA and one-hot MXU select are not carried over.
#include "slot_common.cuh"

namespace {

constexpr int THREADS = 128;     // one slot a thread
constexpr int MIN_BLOCKS = 8;    // registers capped at 64: 8 blocks an SM
constexpr int TAPS_C = 10;       // channels per tap: rgba | normal xyz | mr rgb
constexpr int GROUP = 4 * TAPS_C;          // fields of one sub-texel's taps
constexpr int OUT_W = 20;
constexpr int TRI_CAP = 64;      // triangles a block stages
constexpr int REC_S = 60;        // staged floats a triangle: 58, 16-B rows

static_assert(R_USED <= REC_S, "staged record row too short");

struct Flags {
  int has_base, has_normal, has_mr, packed, k;
};

// The tap atlas: column c's field f lies at atlas[f * ld + c] field-major,
// at atlas[c * ld + f] row-major; rows == nullptr: column = slot.
struct Taps {
  const void* atlas;
  const int32_t* rows;
  int64_t ld;
  int32_t n_cols;
};

// Record field f of a slot's triangle: from the block's staged rows, or by
// triangle id from the (REC_W, T_pad) table.
struct RecShared {
  const float* p;
  __device__ float operator()(int f) const { return p[f]; }
};
struct RecGlobal {
  const float* __restrict__ p;
  int64_t t_pad;
  __device__ float operator()(int f) const {
    return __ldg(p + (int64_t)f * t_pad);
  }
};

__device__ __forceinline__ float hi_half(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ float lo_half(uint32_t w) {
  return __uint_as_float(w << 16);
}

// The GROUP fields of sub-texel group j of atlas column col as f32:
// t[q] = field j * GROUP + q. Packed columns hold field f in the high half
// and field f + half in the low half of int32 word f (half = k * GROUP / 2;
// ops/fragment.py build_pair_atlas / _unpack_taps): for k = 1 the group is
// words 0..19, high halves then low halves; for k >= 2 it is 40 words, all
// high or all low.
template <bool ROW>
__device__ __forceinline__ void load_group(const Taps& tp, const Flags& fl,
                                           int64_t col, int j,
                                           float (&t)[GROUP]) {
  const int g0 = j * GROUP;
  if (!fl.packed) {
    const float* a = (const float*)tp.atlas;
    if (ROW) {
      const float4* p = reinterpret_cast<const float4*>(a + col * tp.ld + g0);
#pragma unroll
      for (int q = 0; q < GROUP / 4; ++q) {
        const float4 x = __ldg(p + q);
        t[4 * q] = x.x;
        t[4 * q + 1] = x.y;
        t[4 * q + 2] = x.z;
        t[4 * q + 3] = x.w;
      }
    } else {
      const float* p = a + (int64_t)g0 * tp.ld + col;
#pragma unroll
      for (int q = 0; q < GROUP; ++q) t[q] = __ldg(p + q * tp.ld);
    }
    return;
  }
  const int half = fl.k * (GROUP / 2);
  const bool one = fl.k == 1;
  const bool high = g0 < half;
  const int w0 = high ? g0 : g0 - half;   // first word (k >= 2)
  const int32_t* a = (const int32_t*)tp.atlas;
  uint32_t w[GROUP];
  if (ROW) {
    const int4* p = reinterpret_cast<const int4*>(a + col * tp.ld + w0);
#pragma unroll
    for (int q = 0; q < GROUP / 4; ++q) {
      int4 x = make_int4(0, 0, 0, 0);
      if (!one || q < GROUP / 8) x = __ldg(p + q);
      w[4 * q] = (uint32_t)x.x;
      w[4 * q + 1] = (uint32_t)x.y;
      w[4 * q + 2] = (uint32_t)x.z;
      w[4 * q + 3] = (uint32_t)x.w;
    }
  } else {
    const int32_t* p = a + (int64_t)w0 * tp.ld + col;
#pragma unroll
    for (int q = 0; q < GROUP; ++q)
      w[q] = (!one || q < GROUP / 2) ? (uint32_t)__ldg(p + q * tp.ld) : 0u;
  }
#pragma unroll
  for (int q = 0; q < GROUP; ++q) {
    if (q < GROUP / 2)
      t[q] = (one || high) ? hi_half(w[q]) : lo_half(w[q]);
    else
      t[q] = one ? lo_half(w[q - GROUP / 2])
                 : (high ? hi_half(w[q]) : lo_half(w[q]));
  }
}

__device__ __forceinline__ float rsqrt_ieee(float x) {
  return 1.0f / sqrtf(x);
}

// One slot: its 20 output values. f reads its triangle's record fields;
// col is its tap-atlas column (unused without a texture).
template <bool ROW, typename Rec>
__device__ __forceinline__ void shade(const Rec& f, float row_local,
                                      float local, float live, int res,
                                      const M2SGeom& geom, const Flags& fl,
                                      const Taps& tp, int64_t col,
                                      float (&o)[OUT_W]) {
  SlotUV s = slot_uv(f, row_local, local, live, res);

  float mix[TAPS_C];
  if (fl.has_base || fl.has_normal || fl.has_mr) {
    TapIndex ti = tap_index(s.uu, s.vv, f(R_MID), f(R_LOD), geom, fl.k);
    // the sub-texel's tap group; out-of-range sub selects group 0
    const int j = (ti.sub > 0 && ti.sub < fl.k) ? ti.sub : 0;
    float t[GROUP];
    load_group<ROW>(tp, fl, col, j, t);
    const float fu = ti.fu, fv = ti.fv;
#pragma unroll
    for (int c = 0; c < TAPS_C; ++c) {
      const float t00 = t[c], t01 = t[TAPS_C + c];
      const float t10 = t[2 * TAPS_C + c], t11 = t[3 * TAPS_C + c];
      // fragment.py: the reference's sum of four products, as it fuses it
      mix[c] = fmaf(t11 * fu, fv,
                    fmaf(t10 * (1.0f - fu), fv,
                         fmaf(t00 * (1.0f - fu), 1.0f - fv,
                              t01 * fu * (1.0f - fv))));
    }
  }

  auto lerp = [&](int a, int b, int c) { return lerp3(s, f(a), f(b), f(c)); };
  const float nx = lerp(R_NAX, R_NBX, R_NCX);
  const float ny = lerp(R_NAY, R_NBY, R_NCY);
  const float nz = lerp(R_NAZ, R_NBZ, R_NCZ);

  float ox = nx, oy = ny, oz = nz;
  if (fl.has_normal) {
    const float tx_ = lerp(R_TAX, R_TBX, R_TCX);
    const float ty_ = lerp(R_TAY, R_TBY, R_TCY);
    const float tz_ = lerp(R_TAZ, R_TBZ, R_TCZ);
    const float tw_ = lerp(R_TAW, R_TBW, R_TCW);
    float mx = mix[4] * 2.0f - 1.0f;
    float my = mix[5] * 2.0f - 1.0f;
    float mz = mix[6] * 2.0f - 1.0f;
    float rinv = rsqrt_ieee(mx * mx + my * my + mz * mz + 1e-24f);
    mx = mx * rinv; my = my * rinv; mz = mz * rinv;
    rinv = rsqrt_ieee(nx * nx + ny * ny + nz * nz + 1e-24f);
    const float ux = nx * rinv, uy = ny * rinv, uz = nz * rinv;
    float bx = uy * tz_ - uz * ty_;
    float by = uz * tx_ - ux * tz_;
    float bz = ux * ty_ - uy * tx_;
    rinv = rsqrt_ieee(bx * bx + by * by + bz * bz + 1e-24f);
    bx = bx * rinv * tw_; by = by * rinv * tw_; bz = bz * rinv * tw_;
    ox = tx_ * mx + bx * my + ux * mz;
    oy = ty_ * mx + by * my + uy * mz;
    oz = tz_ * mx + bz * my + uz * mz;
    rinv = rsqrt_ieee(ox * ox + oy * oy + oz * oz + 1e-24f);
    ox = ox * rinv; oy = oy * rinv; oz = oz * rinv;
  }

  o[0] = lerp(R_PAX, R_PBX, R_PCX);
  o[1] = lerp(R_PAY, R_PBY, R_PCY);
  o[2] = lerp(R_PAZ, R_PBZ, R_PCZ);
  o[3] = fl.has_base ? mix[0] * f(R_FR) : f(R_FR);
  o[4] = fl.has_base ? mix[1] * f(R_FG) : f(R_FG);
  o[5] = fl.has_base ? mix[2] * f(R_FB) : f(R_FB);
  o[6] = fl.has_base ? mix[3] * f(R_FA) : f(R_FA);
  o[7] = f(R_SX);
  o[8] = f(R_SY);
  o[9] = f(R_SZ);
  o[10] = ox;
  o[11] = oy;
  o[12] = oz;
  o[13] = f(R_QW);
  o[14] = f(R_QX);
  o[15] = f(R_QY);
  o[16] = f(R_QZ);
  o[17] = fl.has_mr ? mix[9] : 0.1f;
  o[18] = fl.has_mr ? mix[8] : 0.5f;
  o[19] = s.valid ? 1.0f : 0.0f;
}

__device__ __forceinline__ int32_t clamp_tri(float t, int64_t t_pad) {
  const int32_t i = f2i(t);
  return i < 0 ? 0 : (i >= t_pad ? (int32_t)(t_pad - 1) : i);
}

// LOCAL: `local` computed and written to meta row 2, which is then not
// read; otherwise read from row 2. ROW: the atlas is row-major.
template <bool LOCAL, bool ROW>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fragment_kernel(const float* __restrict__ records, int64_t t_pad,
                    Taps tp, float* __restrict__ meta, int32_t cap, int res,
                    M2SGeom geom, Flags fl, float* __restrict__ out) {
  __shared__ __align__(16) float s_rec[TRI_CAP * REC_S];
  const float* tri_row = meta;
  const float* row_row = meta + cap;
  float* local_row = meta + 2 * (int64_t)cap;
  const float* live_row = meta + 3 * (int64_t)cap;
  const int32_t b0 = blockIdx.x * THREADS;   // the block's first slot
  const int32_t i = b0 + threadIdx.x;
  const bool in = i < cap;

  const float tri = in ? __ldg(tri_row + i) : 0.0f;
  const float row = in ? __ldg(row_row + i) : 0.0f;
  const float live = in ? __ldg(live_row + i) : 0.0f;
  float local = !LOCAL && in ? __ldg(local_row + i) : 0.0f;
  const int32_t t = clamp_tri(tri, t_pad);
  int64_t col = i;
  if (tp.atlas != nullptr && tp.rows != nullptr && in)
    col = min(max(__ldg(tp.rows + i), 0), tp.n_cols - 1);

  // the block's triangle range, staged when it is narrow and holds every
  // slot of the block (block-uniform)
  const int32_t t_lo = clamp_tri(__ldg(tri_row + b0), t_pad);
  const int32_t t_hi =
      clamp_tri(__ldg(tri_row + min(b0 + THREADS, cap) - 1), t_pad);
  const int32_t n = t_hi - t_lo + 1;
  const bool fits = t_lo <= t_hi && n <= TRI_CAP;
  if (fits) {
    for (int e = threadIdx.x; e < R_USED * n; e += THREADS) {
      const int fld = e / n;
      const int k = e - fld * n;
      s_rec[k * REC_S + fld] =
          __ldg(records + (int64_t)fld * t_pad + t_lo + k);
    }
  }
  const bool staged =
      __syncthreads_and(fits && (!in || (t >= t_lo && t <= t_hi)));

  if constexpr (LOCAL) {
    // whole warps scan; a warp past cap has nothing to scan
    const int32_t w0 = i - (int32_t)(threadIdx.x & 31);
    if (w0 < cap) {
      const float kt[1] = {tri}, kr[1] = {row};
      float loc[1];
      warp_slot_local<1>(tri_row, row_row, w0, cap, kt, kr, loc);
      local = loc[0];
    }
    if (in) local_row[i] = local;
  }
  if (!in) return;

  float o[OUT_W];
  if (staged)
    shade<ROW>(RecShared{s_rec + (t - t_lo) * REC_S}, row, local, live, res,
               geom, fl, tp, col, o);
  else
    shade<ROW>(RecGlobal{records + t, t_pad}, row, local, live, res, geom,
               fl, tp, col, o);
  // streaming stores: the output is not read again by this kernel
#pragma unroll
  for (int r = 0; r < OUT_W; ++r) __stcs(out + (int64_t)r * cap + i, o[r]);
}

template <bool LOCAL, bool ROW>
void launch(unsigned blocks, cudaStream_t st, const float* records,
            int64_t t_pad, const Taps& tp, float* meta, int32_t cap, int res,
            const M2SGeom& geom, const Flags& fl, float* out) {
  fragment_kernel<LOCAL, ROW><<<blocks, THREADS, 0, st>>>(
      records, t_pad, tp, meta, cap, res, geom, fl, out);
}

}  // namespace

// taps: the tap atlas (null without a texture); rows: its column per slot
// (null: column = slot); ld, row_major: its layout (see Taps); local != 0:
// the LOCAL mode, which writes meta row 2. Fewer than 2^30 slots.
extern "C" int m2s_fragment_apply(const float* records, int64_t t_pad,
                                  const void* taps, const int32_t* rows,
                                  int64_t ld, int n_cols, int row_major,
                                  float* meta, int64_t cap, int res,
                                  M2SGeom geom, int k, int has_base,
                                  int has_normal, int has_mr, int packed,
                                  int local, float* out, void* stream) {
  if (cap > 0) {
    const Flags fl{has_base, has_normal, has_mr, packed, k};
    const Taps tp{taps, rows, ld, n_cols};
    const unsigned blocks = (unsigned)((cap + THREADS - 1) / THREADS);
    const bool row = taps != nullptr && row_major;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t c = (int32_t)cap;
    if (local) {
      if (row)
        launch<true, true>(blocks, st, records, t_pad, tp, meta, c, res,
                           geom, fl, out);
      else
        launch<true, false>(blocks, st, records, t_pad, tp, meta, c, res,
                            geom, fl, out);
    } else {
      if (row)
        launch<false, true>(blocks, st, records, t_pad, tp, meta, c, res,
                            geom, fl, out);
      else
        launch<false, false>(blocks, st, records, t_pad, tp, meta, c, res,
                             geom, fl, out);
    }
  }
  return (int)cudaGetLastError();
}
