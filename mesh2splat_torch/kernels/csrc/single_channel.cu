// K5 min depth and K6 overdraw: the forward-only walkers of each 32x32
// tile's pair list into one output channel.
//
// Replaces the Pallas kernels of mesh2splat_tpu/render/composite.py::
// _make_min_depth_kernel (K5, launched by min_depth_tiles through
// _single_channel_call) and ::_make_overdraw_kernel (K6, launched by
// overdraw_tiles). Plain versions: mesh2splat_torch/render/composite.py::
// min_depth_plain and ::overdraw_plain (with seg_chunks=, the segmented
// walk below).
//
// K5 keeps, per pixel, the minimum of the pairs' depth field over the pairs
// that cover it (3e38 where none does): the depth test of the shadow
// cubemap, whose six faces arrive as row bands of one tall image. K6 counts
// the covering pairs: the overdraw view. A pair covers a pixel where its
// falloff g is above 0, inside the quad and not underflowed, as the Pallas
// kernels' _coverage decides; covers() alone reports every inside pixel,
// so the walker also tests g > 0.
//
// Bound on the H100: f32 operations. Per pair its plane coefficients, per
// (pair, pixel) it covers the coverage test and the min or the count; a
// pair's fields are read once and the output written once. Two things keep
// a walk from that bound: a splat covers a few percent of a tile's pixels,
// and the pairs crowd into a fifth of the tiles (bench.py's cubemap: 5,767
// of 6,144 tiles are empty, the fullest holds 26,452 pairs, 4x the mean
// busy tile), so one block per tile leaves the card idle behind the
// fullest.
//
// Design. A minimum and an integer count do not depend on the order of the
// pairs, so a tile's chunks (from its 128-aligned start, as the Pallas
// kernels walk them) are cut into segments of SEG_CHUNKS chunks, one block
// each, and no segment needs state from another: the cubemap's fullest
// tile runs as 104 blocks among some 10,000. An empty tile has no segment
// and costs only the wrapper's fill of the output (3e38 or 0). Within a
// block of 256 threads each warp owns 4 of the tile's 32 cull blocks of
// 8x4 pixels (composite_common.cuh), one pixel of each per lane. Each
// chunk is staged once, pair-major (stage_pair; K5's depth stands where K3
// keeps colour), while the next chunk's field rows arrive by cp.async,
// and occupancy hides the rest: 8 blocks fill an SM. The warp ballots
// the chunk's live pairs against each of its cull blocks (may_cover(),
// exact: a dropped pair covers no pixel of the block) and walks only the
// pairs of those lists, evaluating a pair only at the blocks whose list
// holds it. Each thread keeps its pixels' partial min or count in
// registers over the segment, then combines each pixel it changed into the
// output once, by atomics that give the same bits in any order: K6 adds
// its count as a float (an integer below 2^24, so the sum is exact); K5
// takes the minimum through the order-preserving integer image of the
// float (atomicMin on the bits where the sign bit is clear, atomicMax on
// the unsigned bits where it is set), and stores a NaN depth, which the
// plain version's torch.minimum propagates, as the negative quiet NaN
// 0xffc00000, which wins both.
#include "composite_common.cuh"

namespace {

using namespace m2s_comp;

// chunks per segment, one block each (m2s_single_channel_seg_chunks)
constexpr int SEG_CHUNKS = 2;
// Blocks per SM the registers must allow: 8 of THREADS fill an SM, which
// holds the walk to 32 registers. ptxas then spills ~150 bytes, and that
// still measured faster than 40 or 64 registers at fewer resident warps
// (PERF.md).
constexpr int MIN_BLOCKS = 8;

constexpr float NO_DEPTH = 3e38f;  // composite.py MIN_DEPTH_NONE
constexpr unsigned NAN_BITS = 0xffc00000u;

// Cull block q of warp w: each warp owns the 16x8 pixels of 2x2 cull
// blocks, its lanes one pixel of each.
__device__ __forceinline__ int block_x(int w, int q) {
  return 2 * (w & 1) + (q & 1);
}
__device__ __forceinline__ int block_y(int w, int q) {
  return 2 * (w >> 1) + (q >> 1);
}

// A staged pair's plane coefficients.
template <int PR>
__device__ __forceinline__ Planes staged_planes(const float (&pp)[CHUNK][PR],
                                                int r) {
  const float4* row = reinterpret_cast<const float4*>(pp[r]);
  const float4 a = row[0], b = row[1], c = row[2];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
}

// *o = min(*o, v) in the order of floats, NaN winning, whatever the order
// of the calls.
__device__ __forceinline__ void combine_min(float* o, float v) {
  if (v != v) {
    atomicMax(reinterpret_cast<unsigned*>(o), NAN_BITS);
    return;
  }
  const int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(o), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned*>(o), (unsigned)bits);
  }
}

template <bool MIN_DEPTH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
single_channel_kernel(const float* __restrict__ fields, int64_t p,
                      const int32_t* __restrict__ tile_starts,
                      const int32_t* __restrict__ seg_first, int n_tiles,
                      int tx, float height, float* __restrict__ out) {
  // the field rows read: mean and conic, and K5's depth (row 5 of the
  // "depth" variant, render/binning.py FIELDS_DEPTH)
  constexpr int NF = MIN_DEPTH ? F_COL_R + 1 : F_COL_R;
  __shared__ __align__(16) float raw[NF][CHUNK];
  __shared__ __align__(16) float pp[CHUNK][pair_row<NF, false>()];
  __shared__ float uv[C_END][CHUNK];

  Segment sg;
  if (!find_segment<SEG_CHUNKS>(tile_starts, seg_first, n_tiles, sg)) return;
  const int ti = sg.tile / tx;
  const int tj = sg.tile - ti * tx;
  const float tjf = (float)tj * (float)TILE;
  const float py0 = height - (float)ti * (float)TILE;
  // the walk's rows in 32 bits (tile_starts is int32), from the segment's
  // first row: its chunks hold rows [0, n_rows), the tile's live ones
  // [lo0, hi0)
  const int first = (int)(sg.aligned + sg.c0 * CHUNK);
  const int n_rows = (int)(sg.c1 - sg.c0) * CHUNK;
  const int lo0 = (int)sg.start - first;
  const int hi0 = (int)sg.end - first;
  stage_fields(raw, fields, p, first);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // per pixel: K5 the running minimum, K6 the count (exact in f32)
  float xs[PPT], ys[PPT], acc[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int pix = cull_pixel(block_x(warp, q), block_y(warp, q), lane);
    xs[q] = (float)(pix % TILE) + 0.5f;
    ys[q] = (float)(pix / TILE) + 0.5f;
    acc[q] = MIN_DEPTH ? NO_DEPTH : 0.0f;
  }
  wait_staged();
  __syncthreads();

  for (int base = 0; base < n_rows; base += CHUNK) {
    // the live rows of this chunk: [lo, hi)
    const int lo = lo0 > base ? lo0 - base : 0;
    const int hi = hi0 - base < CHUNK ? hi0 - base : CHUNK;
    if (threadIdx.x < CHUNK) {
      const int r = threadIdx.x;
      if (r >= lo && r < hi) stage_pair<false>(pp, uv, raw, r, tjf, py0);
    }
    __syncthreads();
    // the next chunk's rows land while this one is walked
    if (base + CHUNK < n_rows)
      stage_fields(raw, fields, p, first + base + CHUNK);

    for (int r0 = 0; r0 < CHUNK; r0 += 32) {
      const int r = r0 + lane;
      const bool live = r >= lo && r < hi;
      unsigned m[PPT];
      unsigned list = 0;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        m[q] = __ballot_sync(
            FULL_MASK, live && may_cover(uv, r, cull_xc(block_x(warp, q)),
                                         cull_yc(block_y(warp, q))));
        list |= m[q];
      }
      while (list) {
        const int rr = __ffs(list) - 1;
        list &= list - 1;
        const Planes pl = staged_planes(pp, r0 + rr);
        float d = 0.0f;
        if constexpr (MIN_DEPTH) d = pp[r0 + rr][P_COL_R];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          float g;
          if (!((m[q] >> rr) & 1u) || !covers(pl, xs[q], ys[q], g) ||
              !(g > 0.0f))
            continue;
          if constexpr (MIN_DEPTH) {
            // torch.minimum's semantics: a NaN depth propagates
            acc[q] = (d < acc[q] || d != d) ? d : acc[q];
          } else {
            acc[q] += 1.0f;
          }
        }
      }
    }
    // the next chunk's rows have landed once every thread has waited for
    // its pieces and passed the barrier, which also keeps the next chunk's
    // stage from overwriting this one's before every warp is done
    wait_staged();
    __syncthreads();
  }

  const int64_t w_img = (int64_t)tx * TILE;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int pix = cull_pixel(block_x(warp, q), block_y(warp, q), lane);
    float* o = out + ((int64_t)ti * TILE + pix / TILE) * w_img +
               (int64_t)tj * TILE + pix % TILE;
    if constexpr (MIN_DEPTH) {
      if (!(acc[q] == NO_DEPTH)) combine_min(o, acc[q]);  // NaN included
    } else {
      if (acc[q] != 0.0f) atomicAdd(o, acc[q]);
    }
  }
}

}  // namespace

// One launch over `blocks` blocks (at least the number of segments) into
// `out`, which the caller has filled with 3e38 (K5) or 0 (K6).
extern "C" int m2s_single_channel(const float* fields, int64_t p,
                                  const int32_t* tile_starts,
                                  const int32_t* seg_first, int blocks,
                                  int ty, int tx, int height, int min_depth,
                                  float* out, void* stream) {
  if (blocks > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (min_depth) {
      single_channel_kernel<true><<<blocks, THREADS, 0, s>>>(
          fields, p, tile_starts, seg_first, ty * tx, tx, (float)height, out);
    } else {
      single_channel_kernel<false><<<blocks, THREADS, 0, s>>>(
          fields, p, tile_starts, seg_first, ty * tx, tx, (float)height, out);
    }
  }
  return (int)cudaGetLastError();
}

// The chunks of one segment.
extern "C" int m2s_single_channel_seg_chunks() { return SEG_CHUNKS; }

// Resident blocks of THREADS threads per SM of K5 (min_depth = 1) or K6,
// from the occupancy calculator.
extern "C" int m2s_single_channel_occupancy(int min_depth, int* blocks) {
  return (int)(min_depth
                   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, single_channel_kernel<true>, THREADS, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, single_channel_kernel<false>, THREADS, 0));
}
