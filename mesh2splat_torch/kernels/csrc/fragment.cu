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
// mesh2splat_torch/ops/fragment.py::fragment_apply_plain (slot_local when
// local_in_kernel, then _fragment_math).
//
// Bound on the H100: bytes. A slot reads its taps (k*20 int32 when packed,
// k*40 f32 otherwise, none without a texture), 4 meta floats (3 in LOCAL,
// which writes the fourth) and the 58 record floats of its triangle, and
// writes 20 floats; its few hundred flops are far below the card's
// balance. Design: one thread per slot, all field-major rows so that
// neighbouring threads read and write neighbouring addresses; record rows are
// read by triangle id and mostly hit in cache, since consecutive slots share
// their triangle. In LOCAL each warp of 32 slots scans alone; the search for
// its first slot's segment start reads keys the warps before it have just
// read, mostly from cache. The TPU's record-window DMA and one-hot MXU
// select are not carried over.
#include "slot_common.cuh"

namespace {

constexpr int TAPS_C = 10;  // channels per tap: rgba | normal xyz | mr rgb
constexpr int OUT_W = 20;

struct RecCol {
  const float* __restrict__ records;
  int64_t t_pad;
  int64_t tri;
  __device__ float operator()(int f) const {
    return __ldg(records + (int64_t)f * t_pad + tri);
  }
};

struct Flags {
  int has_base, has_normal, has_mr, packed, k;
};

// Field f (of k*4*TAPS_C) of this slot's taps as f32. Packed taps hold field
// f in the high half and field f + half in the low half of row f's int32
// (ops/fragment.py build_pair_atlas / _unpack_taps).
__device__ __forceinline__ float tap_field(const void* taps, int64_t cap,
                                           int64_t i, int f, const Flags& fl) {
  if (!fl.packed) {
    return __ldg((const float*)taps + (int64_t)f * cap + i);
  }
  const int half = fl.k * 2 * TAPS_C;
  const int32_t* t = (const int32_t*)taps;
  uint32_t bits;
  if (f < half) {
    bits = (uint32_t)__ldg(t + (int64_t)f * cap + i) & 0xFFFF0000u;
  } else {
    bits = (uint32_t)__ldg(t + (int64_t)(f - half) * cap + i) << 16;
  }
  return __uint_as_float(bits);
}

__device__ __forceinline__ float rsqrt_ieee(float x) {
  return 1.0f / sqrtf(x);
}

// LOCAL: `local` computed and written to local_row (meta row 2, which is
// then not read); otherwise read from meta row 2 (local_row unused).
template <bool LOCAL>
__global__ void fragment_kernel(const float* __restrict__ records,
                                int64_t t_pad, const void* __restrict__ taps,
                                const float* __restrict__ meta, int64_t cap,
                                int res, M2SGeom geom, Flags fl,
                                float* __restrict__ out,
                                float* __restrict__ local_row) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float local = 0.0f;
  if constexpr (LOCAL) {
    // the whole warp scans: it leaves only when its first slot is past cap
    const int32_t w0 = (int32_t)i - (int32_t)(threadIdx.x & 31);
    if (w0 >= cap) return;
    const float kt[1] = {i < cap ? meta[i] : 0.0f};
    const float kr[1] = {i < cap ? meta[cap + i] : 0.0f};
    float loc[1];
    warp_slot_local<1>(meta, meta + cap, w0, (int32_t)cap, kt, kr, loc);
    if (i >= cap) return;
    local = loc[0];
    local_row[i] = local;
  } else {
    if (i >= cap) return;
  }
  int64_t tri = (int64_t)meta[i];
  tri = tri < 0 ? 0 : (tri >= t_pad ? t_pad - 1 : tri);
  RecCol f{records, t_pad, tri};
  SlotUV s = slot_uv(f, meta[cap + i], LOCAL ? local : meta[2 * cap + i],
                     meta[3 * cap + i], res);
  auto lerp = [&](int a, int b, int c) { return lerp3(s, f(a), f(b), f(c)); };
  float px = lerp(R_PAX, R_PBX, R_PCX);
  float py = lerp(R_PAY, R_PBY, R_PCY);
  float pz = lerp(R_PAZ, R_PBZ, R_PCZ);
  float nx = lerp(R_NAX, R_NBX, R_NCX);
  float ny = lerp(R_NAY, R_NBY, R_NCY);
  float nz = lerp(R_NAZ, R_NBZ, R_NCZ);
  float tx_ = lerp(R_TAX, R_TBX, R_TCX);
  float ty_ = lerp(R_TAY, R_TBY, R_TCY);
  float tz_ = lerp(R_TAZ, R_TBZ, R_TCZ);
  float tw_ = lerp(R_TAW, R_TBW, R_TCW);

  float mix[TAPS_C];
  if (fl.has_base || fl.has_normal || fl.has_mr) {
    TapIndex t = tap_index(s.uu, s.vv, f(R_MID), f(R_LOD), geom, fl.k);
    // the sub-texel's tap group; out-of-range sub selects group 0
    int j = (t.sub > 0 && t.sub < fl.k) ? t.sub : 0;
    int g0 = j * 4 * TAPS_C;
    float fu = t.fu, fv = t.fv;
    for (int c = 0; c < TAPS_C; ++c) {
      float t00 = tap_field(taps, cap, i, g0 + c, fl);
      float t01 = tap_field(taps, cap, i, g0 + TAPS_C + c, fl);
      float t10 = tap_field(taps, cap, i, g0 + 2 * TAPS_C + c, fl);
      float t11 = tap_field(taps, cap, i, g0 + 3 * TAPS_C + c, fl);
      // fragment.py: the reference's sum of four products, as it fuses it
      mix[c] = fmaf(t11 * fu, fv,
                    fmaf(t10 * (1.0f - fu), fv,
                         fmaf(t00 * (1.0f - fu), 1.0f - fv,
                              t01 * fu * (1.0f - fv))));
    }
  }

  float col[4] = {f(R_FR), f(R_FG), f(R_FB), f(R_FA)};
  if (fl.has_base) {
    for (int c = 0; c < 4; ++c) col[c] = mix[c] * col[c];
  }

  float ox = nx, oy = ny, oz = nz;
  if (fl.has_normal) {
    float mx = mix[4] * 2.0f - 1.0f;
    float my = mix[5] * 2.0f - 1.0f;
    float mz = mix[6] * 2.0f - 1.0f;
    float rinv = rsqrt_ieee(mx * mx + my * my + mz * mz + 1e-24f);
    mx = mx * rinv; my = my * rinv; mz = mz * rinv;
    rinv = rsqrt_ieee(nx * nx + ny * ny + nz * nz + 1e-24f);
    float ux = nx * rinv, uy = ny * rinv, uz = nz * rinv;
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

  float metal = 0.1f, rough = 0.5f;
  if (fl.has_mr) {
    metal = mix[9];
    rough = mix[8];
  }

  const float o[OUT_W] = {
      px, py, pz, col[0], col[1], col[2], col[3],
      f(R_SX), f(R_SY), f(R_SZ), ox, oy, oz,
      f(R_QW), f(R_QX), f(R_QY), f(R_QZ), metal, rough,
      s.valid ? 1.0f : 0.0f};
#pragma unroll
  for (int r = 0; r < OUT_W; ++r) out[(int64_t)r * cap + i] = o[r];
}

}  // namespace

// local != 0: the LOCAL mode, which writes meta row 2 (cap below 2^30).
extern "C" int m2s_fragment_apply(const float* records, int64_t t_pad,
                                  const void* taps, float* meta,
                                  int64_t cap, int res, M2SGeom geom, int k,
                                  int has_base, int has_normal, int has_mr,
                                  int packed, int local, float* out,
                                  void* stream) {
  if (cap > 0) {
    Flags fl{has_base, has_normal, has_mr, packed, k};
    const int threads = 256;  // whole warps: LOCAL scans a warp's 32 slots
    const int64_t blocks = (cap + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    if (local)
      fragment_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
          records, t_pad, taps, meta, cap, res, geom, fl, out,
          meta + 2 * cap);
    else
      fragment_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
          records, t_pad, taps, meta, cap, res, geom, fl, out, nullptr);
  }
  return (int)cudaGetLastError();
}
