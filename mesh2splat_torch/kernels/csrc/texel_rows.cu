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
// `local` without a carry. The TPU walks the slots in order and carries the
// last segment start across grid steps in SMEM; blocks here run in no
// order. Slot allocation is triangle-ordered, so the key (tri, row_local)
// never decreases along the slots (the slots past `total` repeat the last
// key): the start of the segment of a warp's first slot is the first slot
// with its key, which the warp finds by a 32-way search over meta rows 0-1
// (first the 32 slots before it, then the whole prefix). Inside the warp a
// max-scan of "a segment starts here" gives every other slot's start (per
// thread over its slots, then shuffles). Each warp works alone: no block
// order, no barrier, no atomics, no state between launches.
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
constexpr unsigned FULL = 0xffffffffu;

struct RecCol {
  const float* __restrict__ records;
  int64_t t_pad;
  int64_t tri;
  __device__ float operator()(int f) const {
    return __ldg(records + (int64_t)f * t_pad + tri);
  }
};

__device__ __forceinline__ bool key_below(int32_t t, int32_t r, int32_t t0,
                                          int32_t r0) {
  return t < t0 || (t == t0 && r < r0);
}

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

// The first slot in [0, j0] whose key is not below (t0, r0), the key of
// slot j0: with keys that never decrease, the start of j0's segment. Called
// by a whole warp; every lane returns the result. Each round probes 32
// slots and keeps the interval between the last probe below the key and
// the next: first the 32 slots before j0, then strides over the prefix.
__device__ int32_t segment_first(const float* __restrict__ tri_row,
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
    const unsigned m = __ballot_sync(FULL, below);
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

  // the key of the slot before this thread's first
  int32_t pt = __shfl_up_sync(FULL, f2i(tri[SPT - 1]), 1);
  int32_t pr = __shfl_up_sync(FULL, f2i(row[SPT - 1]), 1);
  if (lane == 0 && w0 > 0) {
    pt = f2i(__ldg(tri_row + w0 - 1));
    pr = f2i(__ldg(row_row + w0 - 1));
  }

  // running segment start over this thread's slots (-1: none yet); lane 0
  // starts from the segment start of the warp's first slot
  int32_t m = -1;
  const bool cont = w0 > 0 && f2i(tri[0]) == pt && f2i(row[0]) == pr;
  if (__shfl_sync(FULL, cont, 0)) {
    const int32_t s0 = segment_first(
        tri_row, row_row, w0, __shfl_sync(FULL, f2i(tri[0]), 0),
        __shfl_sync(FULL, f2i(row[0]), 0));
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
    const int32_t y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc = max(inc, y);
  }
  int32_t pre = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) pre = -1;

  int32_t rows_out[SPT];
  float local[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    local[s] = (float)(base + s - max(pre, run[s]));
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
