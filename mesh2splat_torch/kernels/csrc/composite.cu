// K3 composite forward: front-to-back compositing of each 32x32 tile's
// depth-ordered pair list into the 16-channel G-buffer.
//
// Replaces the Pallas kernel of mesh2splat_tpu/render/composite.py::
// _make_forward_kernel (launched by _composite_fwd), both its full and its
// albedo_only variants. Plain version: mesh2splat_torch/render/composite.py::
// composite_plain.
//
// Bound on the H100: f32 operations. Every walked (pair, pixel) evaluates the
// falloff polynomial, the quad coverage and, where covered, the two
// transmittance chains and up to 14 accumulations, while a pair's fields are
// read once per tile. Design: one block per tile, 256 threads with 4 pixels
// each (pixels t, t+256, t+512, t+768 of the row-major tile). The tile walks
// its pairs in chunks of 128 from the 128-aligned start below its range, as
// the Pallas kernel does; each chunk's per-pair terms (quad axes from the
// conic, 1/det, the plane coefficients of the falloff and of the quad's u/v)
// are computed once per pair, cooperatively, into shared memory. Each pixel
// then walks the chunk in depth order with sequential T_a/T_g products: no
// prefix scans. The early exit is tested only at chunk ends, over all 1024
// pixels of the tile (padding pixels included), with __syncthreads_or, which
// is where the Pallas kernel tests it. The TPU's bf16x3 MXU accumulation and
// its (8, 128) field-major DMA windows are not carried over.
#include "composite_common.cuh"

namespace {

using namespace m2s_comp;

// per-pair terms staged in shared memory after the plane coefficients
enum {
  S_ALPHA = S_PLANES_END, S_R, S_G, S_B,
  S_ALBEDO_END,
  S_NX = S_ALBEDO_END, S_NY, S_NZ, S_DEPTH, S_WX, S_WY, S_WZ, S_METAL,
  S_ROUGH,
  S_FULL_END
};

template <bool ALBEDO>
__global__ void __launch_bounds__(THREADS)
composite_kernel(const float* __restrict__ fields, int64_t p,
                 const int32_t* __restrict__ tile_starts, int tx,
                 float height, float* __restrict__ out,
                 int32_t* __restrict__ walked) {
  constexpr int NS = ALBEDO ? S_ALBEDO_END : S_FULL_END;
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
  float acc[PPT][NUM_CH];
  float ta[PPT], tg[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    int pix = threadIdx.x + q * THREADS;
    xs[q] = (float)(pix % TILE) + 0.5f;
    ys[q] = (float)(pix / TILE) + 0.5f;
    xx[q] = xs[q] * xs[q];
    xy[q] = xs[q] * ys[q];
    yy[q] = ys[q] * ys[q];
    ta[q] = 1.0f;
    tg[q] = 1.0f;
#pragma unroll
    for (int c = 0; c < NUM_CH; ++c) acc[q][c] = 0.0f;
  }

  const float min_t = (float)(1.0 / 255.0);
  int64_t c = 0;
  bool go = num_chunks > 0;
  while (go) {
    const int64_t base = aligned + c * CHUNK;
    if (threadIdx.x < CHUNK) {
      const int r = threadIdx.x;
      const int64_t row = base + r;
      const bool live = row >= start && row < end;
      slive[r] = live;
      if (live) {
        auto fld = [&](int f) { return __ldg(fields + (int64_t)f * p + row); };
        stage_planes(sp, r, fld(F_CONIC_A), fld(F_CONIC_B), fld(F_CONIC_C),
                     fld(F_MEAN_X) - tjf, fld(F_MEAN_Y) - py0);
        sp[S_ALPHA][r] = fld(F_ALPHA);
        sp[S_R][r] = fld(F_COL_R);
        sp[S_G][r] = fld(F_COL_G);
        sp[S_B][r] = fld(F_COL_B);
        if (!ALBEDO) {
          sp[S_NX][r] = fld(F_NRM_X);
          sp[S_NY][r] = fld(F_NRM_Y);
          sp[S_NZ][r] = fld(F_NRM_Z);
          sp[S_DEPTH][r] = fld(F_DEPTH);
          sp[S_WX][r] = fld(F_WS_X);
          sp[S_WY][r] = fld(F_WS_Y);
          sp[S_WZ][r] = fld(F_WS_Z);
          sp[S_METAL][r] = fld(F_METAL);
          sp[S_ROUGH][r] = fld(F_ROUGH);
        }
      }
    }
    __syncthreads();

    // cum_*: this chunk's running transmittance products (exclusive of the
    // current pair), applied to the value at the chunk's start, as the plain
    // version's exclusive cumprod does
    float cum_a[PPT], cum_g[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      cum_a[q] = 1.0f;
      cum_g[q] = 1.0f;
    }
    for (int r = 0; r < CHUNK; ++r) {
      if (!slive[r]) continue;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        float g;
        if (!falloff(sp, r, xs[q], ys[q], xx[q], xy[q], yy[q], g)) continue;
        float agr = sp[S_ALPHA][r] * g;
        float ag = fminf(agr, 0.9999f);
        float e_a = cum_a[q] * ta[q];
        float agw = agr * e_a;
        acc[q][0] += sp[S_R][r] * agw;
        acc[q][1] += sp[S_G][r] * agw;
        acc[q][2] += sp[S_B][r] * agw;
        acc[q][3] += agw;
        if (!ALBEDO) {
          float gw_a = g * e_a;
          float omg = 1.0f - g;
          float gw_g = g * (cum_g[q] * tg[q]);
          acc[q][8] += sp[S_NX][r] * gw_a;
          acc[q][9] += sp[S_NY][r] * gw_a;
          acc[q][10] += sp[S_NZ][r] * gw_a;
          acc[q][11] += sp[S_DEPTH][r] * gw_a;
          acc[q][4] += sp[S_WX][r] * gw_g;
          acc[q][5] += sp[S_WY][r] * gw_g;
          acc[q][6] += sp[S_WZ][r] * gw_g;
          acc[q][7] += gw_g;
          acc[q][12] += sp[S_METAL][r] * gw_g;
          acc[q][13] += sp[S_ROUGH][r] * gw_g;
          cum_g[q] = cum_g[q] * omg;
        }
        cum_a[q] = cum_a[q] * (1.0f - ag);
      }
    }
    bool any_open = false;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      ta[q] = ta[q] * cum_a[q];
      if (!ALBEDO) tg[q] = tg[q] * cum_g[q];
      any_open = any_open || (ta[q] > min_t);
    }
    ++c;
    // also the barrier before the next chunk overwrites the shared terms
    go = __syncthreads_or(any_open) && c < num_chunks;
  }

  if (walked != nullptr && threadIdx.x == 0) {
    int64_t hi = aligned + c * CHUNK;
    hi = hi < end ? hi : end;
    walked[tile] = (int32_t)(num_chunks > 0 ? hi - start : 0);
  }

  const int64_t w_img = (int64_t)tx * TILE;
  const int64_t plane = (int64_t)gridDim.x / tx * TILE * w_img;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    int pix = threadIdx.x + q * THREADS;
    int64_t off = ((int64_t)ti * TILE + pix / TILE) * w_img +
                  (int64_t)tj * TILE + pix % TILE;
    acc[q][14] = ta[q];
    acc[q][15] = ALBEDO ? 1.0f : tg[q];
#pragma unroll
    for (int ch = 0; ch < NUM_CH; ++ch) out[ch * plane + off] = acc[q][ch];
  }
}

}  // namespace

extern "C" int m2s_composite_forward(const float* fields, int64_t p,
                                     const int32_t* tile_starts, int ty,
                                     int tx, int height, int albedo_only,
                                     float* out, int32_t* walked,
                                     void* stream) {
  const int tiles = ty * tx;
  if (tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (albedo_only) {
      composite_kernel<true><<<tiles, THREADS, 0, s>>>(
          fields, p, tile_starts, tx, (float)height, out, walked);
    } else {
      composite_kernel<false><<<tiles, THREADS, 0, s>>>(
          fields, p, tile_starts, tx, (float)height, out, walked);
    }
  }
  return (int)cudaGetLastError();
}
