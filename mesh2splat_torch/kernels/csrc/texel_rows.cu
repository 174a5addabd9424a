// K1 texel_rows: per conversion slot, the packed tap-atlas row under the
// slot's bilinear footprint at its triangle's mip level, and the slot's
// index within its texel-row segment (`local`), which it writes into row 2
// of the meta table for K2.
//
// Replaces the Pallas kernel A of mesh2splat_tpu/ops/fragment.py::texel_rows
// (both its window-DMA and gather variants) with its in-kernel segment scan
// (_local_scan). Plain version: mesh2splat_torch/ops/fragment.py::
// texel_rows_plain (slot_local, then _index_math).
//
// Bound on the H100: bytes by the roofline's count (per slot 3 meta floats
// read, the row and `local` written: 20 B), but the index math reaches the
// integer and issue limits first: seven IEEE divisions, clamps and the
// address arithmetic of the record loads (PERF.md section 6). Without the
// math the kernel runs near the bytes bound.
//
// `local` without a carry: each warp finds the start of its first slot's
// segment by a search over the sorted (tri, row_local) keys and max-scans
// the rest (slot_common.cuh, warp_slot_local; K2 shares it).
//
// Each thread takes SPT consecutive slots with vector loads and stores; the
// record rows are read straight from the (REC_W, T_pad) table by triangle
// id. Neighbouring slots mostly share a triangle, so those reads hit in
// L1/L2. k (texels an atlas row) is a power of two: the wrapper passes
// log2(k), and the atlas row divides by k with a shift.
#include "slot_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SPT = 4;                     // slots a thread
constexpr int WARP_SLOTS = 32 * SPT;
constexpr int BLOCK_SLOTS = THREADS * SPT;

struct RecCol {
  const float* __restrict__ records;
  int64_t t_pad;
  int64_t tri;
  __device__ float operator()(int f) const {
    return __ldg(records + (int64_t)f * t_pad + tri);
  }
};

// SPT consecutive floats of one meta row from slot `base` (0 past cap).
template <bool VEC>
__device__ __forceinline__ void load_slots(const float* __restrict__ row,
                                           int32_t base, int32_t cap,
                                           float (&v)[SPT]) {
  if (VEC && base + SPT <= cap) {
    float4 x = __ldg(reinterpret_cast<const float4*>(row + base));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
    return;
  }
#pragma unroll
  for (int s = 0; s < SPT; ++s)
    v[s] = base + s < cap ? __ldg(row + base + s) : 0.0f;
}

__device__ __forceinline__ void put4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(int32_t* p, const int32_t* v) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// SPT consecutive values of one row from slot `base` (none past cap).
template <bool VEC, typename T>
__device__ __forceinline__ void store_slots(T* __restrict__ row, int32_t base,
                                            int32_t cap, const T (&v)[SPT]) {
  if (VEC && base + SPT <= cap) {
    put4(row + base, v);
    return;
  }
#pragma unroll
  for (int s = 0; s < SPT; ++s)
    if (base + s < cap) row[base + s] = v[s];
}

// The packed atlas row of a covered slot: floor(texel / k) with
// k = 2^kshift (an arithmetic shift floors a negative texel too).
__device__ __forceinline__ int32_t atlas_row(const SlotUV& su,
                                             const TapLevel& l, int kshift) {
  float fu, fv;
  int32_t texel = tap_texel(su.uu, su.vv, l, &fu, &fv);
  return l.off + (texel >> kshift);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    texel_rows_kernel(const float* __restrict__ records, int64_t t_pad,
                      float* __restrict__ meta, int32_t cap, int res,
                      M2SGeom geom, int kshift, int n_rows,
                      int32_t* __restrict__ out) {
  const float* tri_row = meta;
  const float* row_row = meta + cap;
  const float* live_row = meta + 3 * (int64_t)cap;
  float* local_row = meta + 2 * (int64_t)cap;
  const int lane = threadIdx.x & 31;
  // the warp's first slot
  const int32_t w0 = blockIdx.x * BLOCK_SLOTS + (threadIdx.x >> 5) * WARP_SLOTS;
  const int32_t base = w0 + lane * SPT;
  if (w0 >= cap) return;

  float tri[SPT], row[SPT], live[SPT];
  load_slots<VEC>(tri_row, base, cap, tri);
  load_slots<VEC>(row_row, base, cap, row);
  load_slots<VEC>(live_row, base, cap, live);

  float local[SPT];
  warp_slot_local<SPT>(tri_row, row_row, w0, cap, tri, row, local);

  int32_t rows_out[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    int64_t t = f2i(tri[s]);
    t = t < 0 ? 0 : (t >= t_pad ? t_pad - 1 : t);
    RecCol rec{records, t_pad, t};
    int32_t r = 0;
    if (base + s < cap) {
      SlotUV su = slot_uv(rec, row[s], local[s], live[s], res);
      if (su.valid)
        r = atlas_row(su, tap_level(rec(R_MID), rec(R_LOD), geom), kshift);
    }
    rows_out[s] = min(max(r, 0), n_rows - 1);
  }
  store_slots<VEC>(out, base, cap, rows_out);
  store_slots<VEC>(local_row, base, cap, local);
}

}  // namespace

extern "C" int m2s_texel_rows(const float* records, int64_t t_pad,
                              float* meta, int64_t cap, int res, M2SGeom geom,
                              int kshift, int n_rows, int32_t* out,
                              void* stream) {
  if (cap > 0) {
    const unsigned blocks = (unsigned)((cap + BLOCK_SLOTS - 1) / BLOCK_SLOTS);
    // vector access: every meta row and the output start on 16 bytes
    const bool vec = cap % SPT == 0 && (uintptr_t)meta % 16 == 0 &&
                     (uintptr_t)out % 16 == 0;
    if (vec)
      texel_rows_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          records, t_pad, meta, (int32_t)cap, res, geom, kshift, n_rows,
          out);
    else
      texel_rows_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          records, t_pad, meta, (int32_t)cap, res, geom, kshift, n_rows,
          out);
  }
  return (int)cudaGetLastError();
}
