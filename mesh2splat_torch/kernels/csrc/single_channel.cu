// K5 min depth and K6 overdraw: the forward-only walkers of one 32x32 tile's
// pair list into one output channel.
//
// Replaces the Pallas kernels of mesh2splat_tpu/render/composite.py::
// _make_min_depth_kernel (K5, launched by min_depth_tiles through
// _single_channel_call) and ::_make_overdraw_kernel (K6, launched by
// overdraw_tiles). Plain versions: mesh2splat_torch/render/composite.py::
// min_depth_plain and ::overdraw_plain.
//
// K5 keeps, per pixel, the minimum of the pairs' depth field over the pairs
// that cover it (3e38 where none does): the depth test of the shadow
// cubemap, whose six faces arrive as row bands of one tall image. K6 counts
// the covering pairs: the overdraw view. A pair covers a pixel where its
// falloff g is above 0, inside the quad and not underflowed, as the Pallas
// kernels' _coverage decides; falloff() alone reports every inside pixel,
// so the walker also tests g > 0.
//
// Bound on the H100: f32 operations. Every (pair, pixel) of every chunk of
// a tile evaluates the falloff polynomial, the quad's u and v and the
// coverage test (~22 operations), while a pair's fields are read once per
// tile and the output is one float per pixel. Design: K3's shape, one block
// per tile, 256 threads with 4 pixels each; each 128-pair chunk's plane
// coefficients are staged in shared memory by the shared stage_planes()
// (composite_common.cuh), so K5 and K6 make exactly K3's coverage
// decisions. No early exit, as in the Pallas kernels: a minimum and an
// integer count do not depend on the order of the pairs, so the result is
// deterministic without atomics, and each pixel's value is stored once.
#include "composite_common.cuh"

namespace {

using namespace m2s_comp;

// pair-field rows of the "depth" and "overdraw" variants
// (render/binning.py FIELDS_DEPTH, FIELDS_OVERDRAW); the first five rows are
// those of every variant, depth is row 5 of the "depth" variant only
enum { D_MEAN_X = 0, D_MEAN_Y, D_CONIC_A, D_CONIC_B, D_CONIC_C, D_DEPTH };

// the pair's depth, staged after the plane coefficients
enum { S_DEPTH = S_PLANES_END, S_DEPTH_END };

constexpr float NO_DEPTH = 3e38f;  // composite.py MIN_DEPTH_NONE

template <bool MIN_DEPTH>
__global__ void __launch_bounds__(THREADS)
single_channel_kernel(const float* __restrict__ fields, int64_t p,
                      const int32_t* __restrict__ tile_starts, int tx,
                      float height, float* __restrict__ out) {
  constexpr int NS = MIN_DEPTH ? S_DEPTH_END : S_PLANES_END;
  __shared__ float sp[NS][CHUNK];
  __shared__ unsigned char slive[CHUNK];

  const int tile = blockIdx.x;
  const int ti = tile / tx;
  const int tj = tile - ti * tx;
  const int64_t start = tile_starts[tile];
  const int64_t end = tile_starts[tile + 1];
  const int64_t aligned = (start / CHUNK) * CHUNK;
  const int64_t num_chunks =
      end > start ? (end - aligned + CHUNK - 1) / CHUNK : 0;
  const float tjf = (float)tj * (float)TILE;
  const float py0 = height - (float)ti * (float)TILE;

  float xs[PPT], ys[PPT], xx[PPT], xy[PPT], yy[PPT];
  float zmin[PPT];
  int count[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    int pix = threadIdx.x + q * THREADS;
    xs[q] = (float)(pix % TILE) + 0.5f;
    ys[q] = (float)(pix / TILE) + 0.5f;
    xx[q] = xs[q] * xs[q];
    xy[q] = xs[q] * ys[q];
    yy[q] = ys[q] * ys[q];
    zmin[q] = NO_DEPTH;
    count[q] = 0;
  }

  for (int64_t c = 0; c < num_chunks; ++c) {
    const int64_t base = aligned + c * CHUNK;
    if (threadIdx.x < CHUNK) {
      const int r = threadIdx.x;
      const int64_t row = base + r;
      const bool live = row >= start && row < end;
      slive[r] = live;
      if (live) {
        auto fld = [&](int f) { return __ldg(fields + (int64_t)f * p + row); };
        stage_planes(sp, r, fld(D_CONIC_A), fld(D_CONIC_B), fld(D_CONIC_C),
                     fld(D_MEAN_X) - tjf, fld(D_MEAN_Y) - py0);
        if constexpr (MIN_DEPTH) sp[S_DEPTH][r] = fld(D_DEPTH);
      }
    }
    __syncthreads();

    for (int r = 0; r < CHUNK; ++r) {
      if (!slive[r]) continue;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        float g;
        if (!falloff(sp, r, xs[q], ys[q], xx[q], xy[q], yy[q], g) ||
            !(g > 0.0f))
          continue;
        if constexpr (MIN_DEPTH) {
          // torch.minimum's semantics: a NaN depth propagates
          const float d = sp[S_DEPTH][r];
          zmin[q] = (d < zmin[q] || d != d) ? d : zmin[q];
        } else {
          ++count[q];
        }
      }
    }
    // the next chunk overwrites the staged terms
    __syncthreads();
  }

  const int64_t w_img = (int64_t)tx * TILE;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    int pix = threadIdx.x + q * THREADS;
    int64_t off = ((int64_t)ti * TILE + pix / TILE) * w_img +
                  (int64_t)tj * TILE + pix % TILE;
    if constexpr (MIN_DEPTH) {
      out[off] = zmin[q];
    } else {
      out[off] = (float)count[q];
    }
  }
}

}  // namespace

extern "C" int m2s_single_channel(const float* fields, int64_t p,
                                  const int32_t* tile_starts, int ty, int tx,
                                  int height, int min_depth, float* out,
                                  void* stream) {
  const int tiles = ty * tx;
  if (tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (min_depth) {
      single_channel_kernel<true><<<tiles, THREADS, 0, s>>>(
          fields, p, tile_starts, tx, (float)height, out);
    } else {
      single_channel_kernel<false><<<tiles, THREADS, 0, s>>>(
          fields, p, tile_starts, tx, (float)height, out);
    }
  }
  return (int)cudaGetLastError();
}
