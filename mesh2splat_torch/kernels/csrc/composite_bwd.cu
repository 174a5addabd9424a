// K4 composite backward: the VJP of the per-tile front-to-back composite
// (K3), from the G-buffer's cotangent to the gradient of every pair-field
// row.
//
// Replaces the Pallas kernel of mesh2splat_tpu/render/composite.py::
// _make_backward_kernel (launched by _composite_bwd), both its full and its
// albedo_only variants. Plain versions: mesh2splat_torch/render/composite.py
// ::composite_backward_plain (the main pass) and ::segment_states_plain
// (the state pass).
//
// The suffix trick: with res_a = dot(out, ct) over the alpha group plus
// ct_Ta * T_a per pixel (res_g likewise), a front-to-back walk carries the
// transmittances T_a, T_g and the inclusive prefixes Bpref_a, Bpref_g, and
//   dL/dalpha-plane = -(res_a - Bpref_a) / (1 - min(alpha g, 0.9999)),
//   dL/dg          += -(res_g - Bpref_g) / max(1 - g, 1e-4)   (full only).
// The per-(pair, pixel) terms reduce over the tile's 1024 pixels into the
// moments of dL/dpower against [1, x, y, x^2, x*y, y^2], dL/dalpha and the
// colour (and, full, normal / depth / position / metal-rough) sums; the
// moments chain to the mean and conic rows about the tile-local mean, as the
// Pallas kernel's algebra does. Every chunk of the tile is walked: there is
// no early exit in the backward.
//
// Bound on the H100: f32 operations. Per pair the plane coefficients and the
// chain to its rows; per (pair, pixel) the pair covers, the coverage test,
// the chain above and its 10 (albedo) or 19 (full) reduction terms; a
// pair's fields are read once per tile and its gradient rows written once.
// The pairs crowd into a fifth of the tiles, the fullest holding ~2.8x the
// mean: walked by one block, that tile alone took two thirds of the time.
//
// Design. A tile's chunks are cut into segments of SEG_CHUNKS chunks; one
// block walks one segment. Every pair row lies in one chunk, so it is still
// stored by exactly one block, with plain stores into the zeroed output. A
// segment needs T and Bpref at its start: the state pass
// (segment_state_kernel) walks each segment but a tile's last one from
// T = 1, Bpref = 0 and stores, per pixel, its local T and local Bpref; the
// main pass folds the states of the segments before its own, in order
// (Bpref += T * Bpref_local, T *= T_local), then walks its segment.
//
// Within a block: 256 threads; warp w owns the 16x8 pixel block made of the
// 8x4 cull blocks (2 (w % 2) + q % 2, 2 (w / 2) + q / 2), q = 0..3, and
// lane l its pixel (l % 8, l / 8) in each, with T_a, T_g, Bpref_a and
// Bpref_g per pixel in registers. A chunk's field rows arrive by cp.async
// while the previous chunk is walked; each pair is staged once, pair-major,
// with its plane coefficients, fields and chain terms (composite_common.cuh
// stage_pair). The chunk is walked in ballot groups of 32 pairs: the warp
// ballots which pairs may cover each of its 4 cull blocks (may_cover(),
// exact) and walks the pairs of any list in pair order, evaluating only the
// cull blocks whose list holds the pair. A walked pair's terms are summed
// over the lane's pixels, then across the warp by a reduce-scatter (16 or 32
// terms halved at each of 5 shuffle steps: 12 / 21 shuffles instead of 5 per
// term), skipped where no lane is covered, and the warp's partials go to
// shared memory. Per window of 64 (albedo) or 32 (full) pairs, the
// cross-warp sum reads only the warps that covered the pair, in fixed warp
// order, so the result does not vary from run to run, and warp 0 alone
// chains the window's sums to the gradient rows. The full variant
// keeps the 14 cotangent planes and the two totals of its pixels in 64 KB of
// dynamic shared memory, to stay within 128 registers at two blocks per SM.
// This replaces the Pallas kernel's read-modify-write of the gradient window
// it shares with the previous tile (safe there only because a TPU grid runs
// in order).
#include "composite_common.cuh"

namespace {

using namespace m2s_comp;

constexpr int WARPS = THREADS / 32;
// chunks per segment, one block each; kernels.segment_table reads it through
// m2s_composite_bwd_seg_chunks
constexpr int SEG_CHUNKS = 8;

constexpr int NF_ALBEDO = F_ALPHA + 1;  // the field rows each variant reads
constexpr int NF_FULL = F_ROUGH + 1;
// full variant: 14 cotangent planes, res_a and res_g per pixel in shared
// memory
constexpr int NCT = 16;
// per pixel and segment: T_a, Bpref_a (and, full, T_g, Bpref_g)
constexpr int NST_ALBEDO = 2;
constexpr int NST_FULL = 4;

// reduction terms per pair
enum {
  V_M0 = 0, V_MX, V_MY, V_MXX, V_MXY, V_MYY, V_ALPHA, V_R, V_G, V_B,
  V_ALBEDO_END,
  V_NX = V_ALBEDO_END, V_NY, V_NZ, V_DEPTH, V_WX, V_WY, V_WZ, V_METAL,
  V_ROUGH,
  V_FULL_END
};

// dynamic shared memory: the full variant's pixels' cotangents
constexpr int dyn_smem(bool albedo) {
  return albedo ? 0 : NCT * PPT * THREADS * (int)sizeof(float);
}

// Sum v (N terms) over the warp's 32 lanes by a reduce-scatter: at each
// step the two lanes o apart hold the same n terms; one keeps the first
// ceil(n / 2), the other the rest (padded with a zero), each sends the other
// what it keeps and adds what it gets back. Once one term is left, the
// remaining steps are butterflies. For 10 terms that is 5 + 3 + 2 + 1 + 1 =
// 12 shuffles, for 19 terms 10 + 5 + 3 + 2 + 1 = 21 (a butterfly per term:
// 5 each). The order of the additions is fixed, so the result is the same
// on every run. reduce_slot() says which term's total a lane ends with.
__host__ __device__ constexpr int rs_terms(int n, int step) {
  return step == 0 ? n : (rs_terms(n, step - 1) + 1) / 2;
}

template <int N, int STEP = 0>
__device__ __forceinline__ void reduce_scatter(float (&v)[N + 1], int lane) {
  if constexpr (STEP < 5) {
    constexpr int n = rs_terms(N, STEP);
    constexpr int o = 16 >> STEP;  // partner lane distance
    if constexpr (n > 1) {
      constexpr int h = (n + 1) / 2;  // terms kept by the lower lane
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float rest = i + h < n ? v[i + h] : 0.0f;
        const float send = upper ? v[i] : rest;
        const float keep = upper ? rest : v[i];
        v[i] = keep + __shfl_xor_sync(FULL_MASK, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(FULL_MASK, v[0], o);
    }
    reduce_scatter<N, STEP + 1>(v, lane);
  }
}

// The term whose total reduce_scatter<N> leaves in v[0] of this lane, or -1
// where the lane holds padding or a butterfly partner's copy.
__device__ __forceinline__ int reduce_slot(int nterms, int lane) {
  int base = 0, size = nterms;
  bool owner = true;
  for (int step = 0; step < 5; ++step) {
    const int n = rs_terms(nterms, step), o = 16 >> step;
    if (n > 1) {
      const int h = (n + 1) / 2;
      if (lane & o) {
        base += h;
        size = size > h ? size - h : 0;
      } else {
        size = size < h ? size : h;
      }
    } else if (lane & o) {
      owner = false;
    }
  }
  return owner && size == 1 ? base : -1;
}

// One block's segment: block b walks chunks [c0, c1) of tile `tile`,
// segment k of its nseg. seg_first (n_tiles + 1) counts the segments before
// each tile; blocks past the last segment have none.
struct Segment {
  int tile, k, nseg;
  int64_t start, end, aligned, c0, c1;
};

__device__ __forceinline__ bool find_segment(const int32_t* tile_starts,
                                             const int32_t* seg_first,
                                             int n_tiles, Segment& sg) {
  const int b = blockIdx.x;
  if (b >= seg_first[n_tiles]) return false;
  int lo = 0, hi = n_tiles;  // seg_first[lo] <= b < seg_first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg_first[mid] <= b) lo = mid; else hi = mid;
  }
  sg.tile = lo;
  sg.k = b - seg_first[lo];
  sg.nseg = seg_first[lo + 1] - seg_first[lo];
  sg.start = tile_starts[lo];
  sg.end = tile_starts[lo + 1];
  sg.aligned = (sg.start / CHUNK) * CHUNK;
  const int64_t num_chunks = (sg.end - sg.aligned + CHUNK - 1) / CHUNK;
  sg.c0 = (int64_t)sg.k * SEG_CHUNKS;
  sg.c1 = sg.c0 + SEG_CHUNKS < num_chunks ? sg.c0 + SEG_CHUNKS : num_chunks;
  return true;
}

// What every thread of both passes holds: its 4 pixels, one in each of its
// warp's cull blocks, and their cotangents: the albedo variant's 5 per pixel
// in registers, the full variant's 16 in dynamic shared memory, written and
// read by this thread only.
template <bool ALBEDO>
struct Pixels {
  float xs[PPT], ys[PPT];
  float c_rgba[ALBEDO ? PPT : 1][4], res_a[ALBEDO ? PPT : 1];
  float* cts;

  // cull block q of this thread's warp
  __device__ __forceinline__ static int block_x(int q) {
    return 2 * ((threadIdx.x >> 5) & 1) + (q & 1);
  }
  __device__ __forceinline__ static int block_y(int q) {
    return 2 * (threadIdx.x >> 6) + (q >> 1);
  }

  __device__ __forceinline__ void load(int tile, int tx, int64_t plane,
                                       const float* ct, const float* res,
                                       float* dyn) {
    const int lane = threadIdx.x & 31;
    const int ti = tile / tx, tj = tile - (tile / tx) * tx;
    const int64_t w_img = (int64_t)tx * TILE;
    cts = dyn;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int pix = cull_pixel(block_x(q), block_y(q), lane);
      xs[q] = (float)(pix % TILE) + 0.5f;
      ys[q] = (float)(pix / TILE) + 0.5f;
      const int64_t off = ((int64_t)ti * TILE + pix / TILE) * w_img +
                          (int64_t)tj * TILE + pix % TILE;
      if constexpr (ALBEDO) {
#pragma unroll
        for (int k = 0; k < 4; ++k) c_rgba[q][k] = ct[k * plane + off];
        res_a[q] = res != nullptr ? res[off] : 0.0f;
      } else {
#pragma unroll
        for (int k = 0; k < 14; ++k) at(k, q) = ct[k * plane + off];
        if (res != nullptr) {
          at(14, q) = res[off];
          at(15, q) = res[plane + off];
        }
      }
    }
  }

  __device__ __forceinline__ float& at(int k, int q) {
    return cts[(k * PPT + q) * THREADS + threadIdx.x];
  }

  // cotangent channel k (14: res_a, 15: res_g) of pixel q
  __device__ __forceinline__ float cot(int k, int q) {
    if constexpr (ALBEDO) {
      return k == 14 ? res_a[q] : c_rgba[q][k & 3];
    } else {
      return at(k, q);
    }
  }

  __device__ __forceinline__ int pix(int q) const {
    return ((int)ys[q]) * TILE + (int)xs[q];
  }
};

// The pairs of rows [r0, r0 + 32) of the chunk that may cover each of the
// warp's cull blocks: bit rr of m[q] for row r0 + rr and block q. Returns
// the union.
template <bool ALBEDO>
__device__ __forceinline__ unsigned sub_lists(const float (&uv)[C_END][CHUNK],
                                              int r0, int lo, int hi,
                                              unsigned (&m)[PPT]) {
  const int r = r0 + (threadIdx.x & 31);
  const bool live = r >= lo && r < hi;
  unsigned any = 0;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const float xc = cull_xc(Pixels<ALBEDO>::block_x(q));
    const float yc = cull_yc(Pixels<ALBEDO>::block_y(q));
    m[q] = __ballot_sync(FULL_MASK, live && may_cover(uv, r, xc, yc));
    any |= m[q];
  }
  return any;
}

// Stage one chunk's pairs (threads 0..127, one live row each) from its
// field rows, then start the next chunk's rows on their way into the same
// buffer.
template <int NF, int PR>
__device__ __forceinline__ void stage_chunk(
    float (&pp)[CHUNK][PR], float (&uv)[C_END][CHUNK], float (&raw)[NF][CHUNK],
    const float* fields, int64_t p, int64_t base, bool more, int lo, int hi,
    float tjf, float py0) {
  if (threadIdx.x < CHUNK) {
    const int r = threadIdx.x;
    if (r >= lo && r < hi) stage_pair<true>(pp, uv, raw, r, tjf, py0);
  }
  __syncthreads();
  if (more) stage_fields(raw, fields, p, base + CHUNK);
}

// The state pass: per segment but a tile's last, per pixel, the segment's
// transmittance product and its prefix sum Bpref from T = 1, Bpref = 0.
template <bool ALBEDO>
__global__ void __launch_bounds__(THREADS, 2)
segment_state_kernel(const float* __restrict__ fields, int64_t p,
                     const int32_t* __restrict__ tile_starts,
                     const int32_t* __restrict__ seg_first, int n_tiles,
                     int tx, float height, const float* __restrict__ ct,
                     float* __restrict__ states) {
  constexpr int NF = ALBEDO ? NF_ALBEDO : NF_FULL;
  constexpr int NST = ALBEDO ? NST_ALBEDO : NST_FULL;
  __shared__ __align__(16) float raw[NF][CHUNK];
  __shared__ __align__(16) float pp[CHUNK][pair_row<NF, true>()];
  __shared__ float uv[C_END][CHUNK];
  extern __shared__ float dyn[];

  Segment sg;
  if (!find_segment(tile_starts, seg_first, n_tiles, sg) ||
      sg.k == sg.nseg - 1)
    return;
  const int ti = sg.tile / tx;
  const float tjf = (float)(sg.tile - ti * tx) * (float)TILE;
  const float py0 = height - (float)ti * (float)TILE;
  stage_fields(raw, fields, p, sg.aligned + sg.c0 * CHUNK);
  Pixels<ALBEDO> px;
  px.load(sg.tile, tx, (int64_t)n_tiles * NPX, ct, nullptr, dyn);
  float ta[PPT], tg[PPT], bpa[PPT], bpg[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    ta[q] = 1.0f;
    tg[q] = 1.0f;
    bpa[q] = 0.0f;
    bpg[q] = 0.0f;
  }
  wait_staged();
  __syncthreads();

  for (int64_t c = sg.c0; c < sg.c1; ++c) {
    const int64_t base = sg.aligned + c * CHUNK;
    const int lo = (int)(sg.start > base ? sg.start - base : 0);
    const int hi = (int)(sg.end - base < CHUNK ? sg.end - base : CHUNK);
    stage_chunk(pp, uv, raw, fields, p, base, c + 1 < sg.c1, lo, hi, tjf,
                py0);
    float cum_a[PPT], cum_g[PPT], run_a[PPT], run_g[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      cum_a[q] = 1.0f;
      cum_g[q] = 1.0f;
      run_a[q] = 0.0f;
      run_g[q] = 0.0f;
    }
    for (int r0 = 0; r0 < CHUNK; r0 += 32) {
      unsigned m[PPT];
      unsigned list = sub_lists<ALBEDO>(uv, r0, lo, hi, m);
      while (list) {
        const int rr = __ffs(list) - 1;
        list &= list - 1;
        const int r = r0 + rr;
        float4 rgba;  // colour and alpha
        const Planes pl = row_planes(pp, r, rgba);
        const float alpha = rgba.w;
        float pv[9];  // the full variant's normal, position, depth, pbr
        if constexpr (!ALBEDO) row_rest(pp, r, pv);
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          float g;
          if (!((m[q] >> rr) & 1u) || !covers(pl, px.xs[q], px.ys[q], g))
            continue;
          const float ag = fminf(alpha * g, 0.9999f);
          const float e_a = cum_a[q] * ta[q];
          const float gw_a = g * e_a;
          float sdot_a = alpha * (rgba.x * px.cot(0, q) +
                                  rgba.y * px.cot(1, q) +
                                  rgba.z * px.cot(2, q) + px.cot(3, q));
          if constexpr (!ALBEDO) {
            sdot_a = sdot_a + (pv[F_NRM_X - F_NRM_X] * px.cot(8, q) +
                               pv[F_NRM_Y - F_NRM_X] * px.cot(9, q) +
                               pv[F_NRM_Z - F_NRM_X] * px.cot(10, q) +
                               pv[F_DEPTH - F_NRM_X] * px.cot(11, q));
            const float omg = 1.0f - g;
            const float gw_g = g * (cum_g[q] * tg[q]);
            const float sdot_g = pv[F_WS_X - F_NRM_X] * px.cot(4, q) +
                                 pv[F_WS_Y - F_NRM_X] * px.cot(5, q) +
                                 pv[F_WS_Z - F_NRM_X] * px.cot(6, q) +
                                 px.cot(7, q) +
                                 pv[F_METAL - F_NRM_X] * px.cot(12, q) +
                                 pv[F_ROUGH - F_NRM_X] * px.cot(13, q);
            run_g[q] = run_g[q] + sdot_g * gw_g;
            cum_g[q] = cum_g[q] * omg;
          }
          run_a[q] = run_a[q] + sdot_a * gw_a;
          cum_a[q] = cum_a[q] * (1.0f - ag);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      ta[q] = ta[q] * cum_a[q];
      bpa[q] = bpa[q] + run_a[q];
      if constexpr (!ALBEDO) {
        tg[q] = tg[q] * cum_g[q];
        bpg[q] = bpg[q] + run_g[q];
      }
    }
    wait_staged();
    __syncthreads();
  }
  float* st = states + (int64_t)blockIdx.x * NST * NPX;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int pix = px.pix(q);
    st[0 * NPX + pix] = ta[q];
    st[1 * NPX + pix] = bpa[q];
    if constexpr (!ALBEDO) {
      st[2 * NPX + pix] = tg[q];
      st[3 * NPX + pix] = bpg[q];
    }
  }
}

// The main pass: one segment's walk from the state at its start, and the
// gradient rows of its pairs.
template <bool ALBEDO>
__global__ void __launch_bounds__(THREADS, 2)
composite_bwd_kernel(const float* __restrict__ fields, int64_t p,
                     const int32_t* __restrict__ tile_starts,
                     const int32_t* __restrict__ seg_first, int n_tiles,
                     int tx, float height, const float* __restrict__ ct,
                     const float* __restrict__ res,
                     const float* __restrict__ states,
                     float* __restrict__ dfields) {
  constexpr int NF = ALBEDO ? NF_ALBEDO : NF_FULL;
  constexpr int NV = ALBEDO ? V_ALBEDO_END : V_FULL_END;
  constexpr int NST = ALBEDO ? NST_ALBEDO : NST_FULL;
  // pairs per cross-warp reduction, in ballot groups of 32 (the partials
  // fill the static shared memory left beside the stage)
  constexpr int WINDOW = ALBEDO ? 64 : 32;
  constexpr int GROUPS = WINDOW / 32;
  __shared__ __align__(16) float raw[NF][CHUNK];
  __shared__ __align__(16) float pp[CHUNK][pair_row<NF, true>()];
  __shared__ float uv[C_END][CHUNK];
  __shared__ float part[WINDOW][WARPS][NV];  // warp 0's row ends as the sum
  __shared__ unsigned wlist[GROUPS][WARPS];
  extern __shared__ float dyn[];

  Segment sg;
  if (!find_segment(tile_starts, seg_first, n_tiles, sg)) return;
  const int ti = sg.tile / tx;
  const float tjf = (float)(sg.tile - ti * tx) * (float)TILE;
  const float py0 = height - (float)ti * (float)TILE;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = reduce_slot(NV, lane);
  stage_fields(raw, fields, p, sg.aligned + sg.c0 * CHUNK);
  Pixels<ALBEDO> px;
  px.load(sg.tile, tx, (int64_t)n_tiles * NPX, ct, res, dyn);

  // T and Bpref at the segment's start: the states of the segments before
  // it, folded in order
  float ta[PPT], tg[PPT], bpa[PPT], bpg[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    ta[q] = 1.0f;
    tg[q] = 1.0f;
    bpa[q] = 0.0f;
    bpg[q] = 0.0f;
  }
  for (int s = 0; s < sg.k; ++s) {
    const float* st = states + (int64_t)(seg_first[sg.tile] + s) * NST * NPX;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int pix = px.pix(q);
      bpa[q] = bpa[q] + ta[q] * st[1 * NPX + pix];
      ta[q] = ta[q] * st[0 * NPX + pix];
      if constexpr (!ALBEDO) {
        bpg[q] = bpg[q] + tg[q] * st[3 * NPX + pix];
        tg[q] = tg[q] * st[2 * NPX + pix];
      }
    }
  }
  wait_staged();
  __syncthreads();

  for (int64_t c = sg.c0; c < sg.c1; ++c) {
    const int64_t base = sg.aligned + c * CHUNK;
    const int lo = (int)(sg.start > base ? sg.start - base : 0);
    const int hi = (int)(sg.end - base < CHUNK ? sg.end - base : CHUNK);
    stage_chunk(pp, uv, raw, fields, p, base, c + 1 < sg.c1, lo, hi, tjf,
                py0);

    // this chunk's exclusive transmittance products and inclusive prefix
    // sums, applied to the values at the chunk's start (as the plain
    // version's loops over the chunk)
    float cum_a[PPT], cum_g[PPT], run_a[PPT], run_g[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      cum_a[q] = 1.0f;
      cum_g[q] = 1.0f;
      run_a[q] = 0.0f;
      run_g[q] = 0.0f;
    }
    for (int w0 = 0; w0 < CHUNK; w0 += WINDOW) {
      for (int gi = 0; gi < GROUPS; ++gi) {
        const int r0 = w0 + 32 * gi;
        unsigned m[PPT];
        unsigned list = sub_lists<ALBEDO>(uv, r0, lo, hi, m);
        unsigned held = 0;  // the pairs that cover a pixel of this warp
        while (list) {
          const int rr = __ffs(list) - 1;
          list &= list - 1;
          const int r = r0 + rr;
          float4 rgba;  // colour and alpha
          const Planes pl = row_planes(pp, r, rgba);
          const float alpha = rgba.w;
          const float col[3] = {rgba.x, rgba.y, rgba.z};
          float pv[9];  // the full variant's normal, position, depth, pbr
          if constexpr (!ALBEDO) row_rest(pp, r, pv);
          float v[NV + 1];  // and a slot for reduce_scatter\'s padding
#pragma unroll
          for (int k = 0; k <= NV; ++k) v[k] = 0.0f;
          bool any = false;
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            float g;
            if (!((m[q] >> rr) & 1u) || !covers(pl, px.xs[q], px.ys[q], g))
              continue;
            any = true;
            const float agr = alpha * g;
            const float ag = fminf(agr, 0.9999f);
            const float e_a = cum_a[q] * ta[q];
            const float gw_a = g * e_a;
            const float ct_rgb3 = col[0] * px.cot(0, q) +
                                  col[1] * px.cot(1, q) +
                                  col[2] * px.cot(2, q) + px.cot(3, q);
            float sdot_a = alpha * ct_rgb3;
            if constexpr (!ALBEDO) {
              sdot_a = sdot_a + (pv[F_NRM_X - F_NRM_X] * px.cot(8, q) +
                                 pv[F_NRM_Y - F_NRM_X] * px.cot(9, q) +
                                 pv[F_NRM_Z - F_NRM_X] * px.cot(10, q) +
                                 pv[F_DEPTH - F_NRM_X] * px.cot(11, q));
            }
            run_a[q] = run_a[q] + sdot_a * gw_a;
            const float bpref_a = bpa[q] + run_a[q];
            // da and dgg feed only the gradient rows, and their divisors lie
            // in [1e-4, 1]: __fdividef is within 2 ulp there, and IEEE
            // division's slow path costs K4 registers and spills (PERF.md)
            const float da = -__fdividef(px.cot(14, q) - bpref_a, 1.0f - ag);
            float dl_dg = sdot_a * e_a + da * alpha;
            float gw_g = 0.0f;
            if constexpr (!ALBEDO) {
              const float omg = 1.0f - g;
              const float e_g = cum_g[q] * tg[q];
              gw_g = g * e_g;
              const float sdot_g = pv[F_WS_X - F_NRM_X] * px.cot(4, q) +
                                   pv[F_WS_Y - F_NRM_X] * px.cot(5, q) +
                                   pv[F_WS_Z - F_NRM_X] * px.cot(6, q) +
                                   px.cot(7, q) +
                                   pv[F_METAL - F_NRM_X] * px.cot(12, q) +
                                   pv[F_ROUGH - F_NRM_X] * px.cot(13, q);
              run_g[q] = run_g[q] + sdot_g * gw_g;
              const float bpref_g = bpg[q] + run_g[q];
              const float dgg =
                  -__fdividef(px.cot(15, q) - bpref_g, fmaxf(omg, 1e-4f));
              dl_dg = dl_dg + sdot_g * e_g + dgg;
              cum_g[q] = cum_g[q] * omg;
            }
            const float gp = dl_dg * g;                    // dL/dpower
            const float dal = g * (ct_rgb3 * e_a + da);    // dL/dalpha
            const float w_rgb = agr * e_a;
            const float x = px.xs[q], y = px.ys[q];
            // the reduction terms feed only the gradient rows: fused
            // multiply-adds (the chains above keep their own roundings)
            v[V_M0] += gp;
            v[V_MX] = __fmaf_rn(gp, x, v[V_MX]);
            v[V_MY] = __fmaf_rn(gp, y, v[V_MY]);
            v[V_MXX] = __fmaf_rn(gp, x * x, v[V_MXX]);
            v[V_MXY] = __fmaf_rn(gp, x * y, v[V_MXY]);
            v[V_MYY] = __fmaf_rn(gp, y * y, v[V_MYY]);
            v[V_ALPHA] += dal;
            v[V_R] = __fmaf_rn(w_rgb, px.cot(0, q), v[V_R]);
            v[V_G] = __fmaf_rn(w_rgb, px.cot(1, q), v[V_G]);
            v[V_B] = __fmaf_rn(w_rgb, px.cot(2, q), v[V_B]);
            if constexpr (!ALBEDO) {
              v[V_NX] = __fmaf_rn(gw_a, px.cot(8, q), v[V_NX]);
              v[V_NY] = __fmaf_rn(gw_a, px.cot(9, q), v[V_NY]);
              v[V_NZ] = __fmaf_rn(gw_a, px.cot(10, q), v[V_NZ]);
              v[V_DEPTH] = __fmaf_rn(gw_a, px.cot(11, q), v[V_DEPTH]);
              v[V_WX] = __fmaf_rn(gw_g, px.cot(4, q), v[V_WX]);
              v[V_WY] = __fmaf_rn(gw_g, px.cot(5, q), v[V_WY]);
              v[V_WZ] = __fmaf_rn(gw_g, px.cot(6, q), v[V_WZ]);
              v[V_METAL] = __fmaf_rn(gw_g, px.cot(12, q), v[V_METAL]);
              v[V_ROUGH] = __fmaf_rn(gw_g, px.cot(13, q), v[V_ROUGH]);
            }
            cum_a[q] = cum_a[q] * (1.0f - ag);
          }
          // a warp none of whose pixels the pair covers adds nothing: the
          // cross-warp sum skips it (an exact zero)
          if (!__any_sync(FULL_MASK, any)) continue;
          held |= 1u << rr;
          reduce_scatter<NV>(v, lane);
          if (slot >= 0) part[r - w0][warp][slot] = v[0];
        }
        if (lane == 0) wlist[gi][warp] = held;
      }
      __syncthreads();
      // each pair's sum over the warps that walked it, in warp order
      for (int i = threadIdx.x; i < WINDOW * NV; i += THREADS) {
        const int rr = i / NV;
        const int k = i - rr * NV;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          if ((wlist[rr >> 5][w] >> (rr & 31)) & 1u) s += part[rr][w][k];
        }
        part[rr][0][k] = s;  // read and written by this thread alone
      }
      __syncthreads();
      // the per-pair chain to the mean, conic, colour and alpha rows, in
      // warp 0 alone: the next window's walk writes part[][0] from warp 0
      // only, so no warp can overwrite a sum that this chain still reads
      // (the next barrier comes after that walk)
      for (int rr = lane; warp == 0 && rr < WINDOW; rr += 32) {
        const int r = w0 + rr;
        if (r >= lo && r < hi) {
          const int64_t row = base + r;
          const float* m = part[rr][0];
          const float* chain = row_chain<NF>(pp, r);
          const float mxp = chain[0], myp = chain[1];
          const float ca = chain[2], cb = chain[3], cc = chain[4];
          const float gx = mxp * m[V_M0] - m[V_MX];   // sum gp * dx
          const float gy = myp * m[V_M0] + m[V_MY];   // sum gp * dy
          auto put = [&](int f, float val) {
            dfields[(int64_t)f * p + row] = val;
          };
          put(F_MEAN_X, -(ca * gx + cb * gy));
          put(F_MEAN_Y, -(cc * gy + cb * gx));
          put(F_CONIC_A, -0.5f * (mxp * mxp * m[V_M0] - 2.0f * mxp * m[V_MX] +
                                  m[V_MXX]));
          put(F_CONIC_B, -(mxp * myp * m[V_M0] + mxp * m[V_MY] -
                           myp * m[V_MX] - m[V_MXY]));
          put(F_CONIC_C, -0.5f * (myp * myp * m[V_M0] + 2.0f * myp * m[V_MY] +
                                  m[V_MYY]));
          put(F_COL_R, m[V_R]);
          put(F_COL_G, m[V_G]);
          put(F_COL_B, m[V_B]);
          put(F_ALPHA, m[V_ALPHA]);
          if constexpr (!ALBEDO) {
            put(F_NRM_X, m[V_NX]);
            put(F_NRM_Y, m[V_NY]);
            put(F_NRM_Z, m[V_NZ]);
            put(F_DEPTH, m[V_DEPTH]);
            put(F_WS_X, m[V_WX]);
            put(F_WS_Y, m[V_WY]);
            put(F_WS_Z, m[V_WZ]);
            put(F_METAL, m[V_METAL]);
            put(F_ROUGH, m[V_ROUGH]);
          }
        }
      }
      // and every lane of warp 0 has read its sums before any of them
      // writes the next window's partials
      __syncwarp();
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      ta[q] = ta[q] * cum_a[q];
      bpa[q] = bpa[q] + run_a[q];
      if constexpr (!ALBEDO) {
        tg[q] = tg[q] * cum_g[q];
        bpg[q] = bpg[q] + run_g[q];
      }
    }
    // the next chunk's rows have landed once every thread has waited for its
    // pieces and passed the barrier, which also keeps the next chunk's
    // planes and the chain's reads of this chunk's rows apart
    wait_staged();
    __syncthreads();
  }
}

// Static and dynamic shared memory together pass the default 48 KB in both
// variants: opt in, and ask for the largest shared-memory carveout.
template <bool ALBEDO, class K>
cudaError_t allow_smem(K kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem(ALBEDO));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Launch one of the kernels for either variant.
template <bool ALBEDO, class K, class... A>
int launch(K kernel, int blocks, void* stream, A... args) {
  if (blocks <= 0) return (int)cudaGetLastError();
  cudaError_t e = allow_smem<ALBEDO>(kernel);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, THREADS, dyn_smem(ALBEDO), (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

template <bool ALBEDO, class K>
int occupancy(K kernel, int* blocks) {
  cudaError_t e = allow_smem<ALBEDO>(kernel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, THREADS, dyn_smem(ALBEDO));
}

}  // namespace

// The state pass over `blocks` blocks (at least the number of segments).
extern "C" int m2s_composite_bwd_states(const float* fields, int64_t p,
                                        const int32_t* tile_starts,
                                        const int32_t* seg_first, int blocks,
                                        int ty, int tx, int height,
                                        int albedo_only,
                                        const float* ct, float* states,
                                        void* stream) {
  const float h = (float)height;
  return albedo_only
             ? launch<true>(segment_state_kernel<true>, blocks, stream,
                            fields, p, tile_starts, seg_first, ty * tx, tx, h,
                            ct, states)
             : launch<false>(segment_state_kernel<false>, blocks, stream,
                             fields, p, tile_starts, seg_first, ty * tx, tx,
                             h, ct, states);
}

// The main pass over `blocks` blocks, after the state pass has filled
// `states`.
extern "C" int m2s_composite_backward(const float* fields, int64_t p,
                                      const int32_t* tile_starts,
                                      const int32_t* seg_first, int blocks,
                                      int ty, int tx, int height,
                                      int albedo_only, const float* ct,
                                      const float* res,
                                      const float* states, float* dfields,
                                      void* stream) {
  const float h = (float)height;
  return albedo_only
             ? launch<true>(composite_bwd_kernel<true>, blocks, stream,
                            fields, p, tile_starts, seg_first, ty * tx, tx, h,
                            ct, res, states, dfields)
             : launch<false>(composite_bwd_kernel<false>, blocks, stream,
                             fields, p, tile_starts, seg_first, ty * tx, tx,
                             h, ct, res, states, dfields);
}

// The chunks of one segment.
extern "C" int m2s_composite_bwd_seg_chunks() { return SEG_CHUNKS; }

// Resident blocks of THREADS threads per SM of the main pass (state = 0) or
// the state pass (state = 1) of one variant, from the occupancy calculator.
extern "C" int m2s_composite_backward_occupancy(int albedo_only, int state,
                                                int* blocks) {
  if (albedo_only) {
    return state ? occupancy<true>(segment_state_kernel<true>, blocks)
                 : occupancy<true>(composite_bwd_kernel<true>, blocks);
  }
  return state ? occupancy<false>(segment_state_kernel<false>, blocks)
               : occupancy<false>(composite_bwd_kernel<false>, blocks);
}
