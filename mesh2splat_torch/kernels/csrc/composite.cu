// K3 composite forward: front-to-back compositing of each 32x32 tile's
// depth-ordered pair list into the 16-channel G-buffer.
//
// Replaces the Pallas kernel of mesh2splat_tpu/render/composite.py::
// _make_forward_kernel (launched by _composite_fwd), both its full and its
// albedo_only variants. Plain version: mesh2splat_torch/render/composite.py::
// composite_plain.
//
// Bound on the H100: f32 operations. A pair's fields are read once per tile;
// the work is the per-pair plane coefficients and, per (pair, pixel) the
// pair covers, the falloff, the two transmittance chains and up to 14
// accumulations. A splat covers a few percent of a tile, so a walk that
// evaluates every pair at every pixel spends nearly all its time on pixels
// the pair misses; and the pairs crowd into a fifth of the tiles, the
// fullest holding ~2.7x the mean, so one tile on one SM sets the pace.
//
// Design: a cluster of 4 blocks per tile, each block a band of 8 rows (256
// pixels, one per thread); warp w of band b walks the 8x4 cull block
// (w % 4, 2 b + w / 4) of composite_common.cuh. The tile walks its pairs in
// chunks of 128 from the 128-aligned start below its range, as the Pallas
// kernel does. Each block stages every chunk: its field rows arrive by
// cp.async while the previous chunk is walked, and its plane coefficients
// (quad axes from the conic, 1/det, the falloff and the quad's u/v planes)
// are computed once per pair into shared memory, pair-major beside the
// pair's fields (composite_common.cuh stage_pair).
// Each warp then tests the chunk's pairs against its block (each lane 4
// pairs, may_cover(), exact: a dropped pair covers no pixel of the block)
// and walks, in pair order, only the pairs of its ballot lists. Every pixel
// sees the same covered pairs in the same order as a walk over all pairs,
// so the sums are the same, bit for bit. The early exit is tested only at
// chunk ends, over all 1024 pixels of the tile (padding pixels included),
// which is where the Pallas kernel tests it: each band ORs its pixels with
// __syncthreads_or, and the four bands exchange their flags through
// distributed shared memory at a cluster barrier, so all four leave after
// the same chunk. The TPU's bf16x3 MXU accumulation is not carried over.
#include <cooperative_groups.h>

#include "composite_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace m2s_comp;

constexpr int CLUSTER = 4;  // blocks per tile, one band of 8 rows each
constexpr int NF_ALBEDO = F_ALPHA + 1;  // the field rows each variant reads
constexpr int NF_FULL = F_ROUGH + 1;

template <bool ALBEDO>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 4)
composite_kernel(const float* __restrict__ fields, int64_t p,
                 const int32_t* __restrict__ tile_starts, int tx,
                 float height, float* __restrict__ out,
                 int32_t* __restrict__ walked) {
  constexpr int NF = ALBEDO ? NF_ALBEDO : NF_FULL;
  constexpr int NACC = ALBEDO ? 4 : 14;  // accumulated channels 0..NACC-1
  __shared__ __align__(16) float raw[NF][CHUNK];
  __shared__ __align__(16) float pp[CHUNK][pair_row<NF, false>()];
  __shared__ float uv[C_END][CHUNK];
  __shared__ int band_open[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int band = (int)cluster.block_rank();
  const int tile = blockIdx.x / CLUSTER;
  const int ti = tile / tx;
  const int tj = tile - ti * tx;
  const int64_t start = tile_starts[tile];
  const int64_t end = tile_starts[tile + 1];
  const int64_t aligned = (start / CHUNK) * CHUNK;
  const int64_t num_chunks =
      end > start ? (end - aligned + CHUNK - 1) / CHUNK : 0;
  const float tjf = (float)tj * (float)TILE;
  const float py0 = height - (float)ti * (float)TILE;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bx = warp % CULL_BX;
  const int by = 2 * band + warp / CULL_BX;
  const float bxc = cull_xc(bx), byc = cull_yc(by);
  const int pix = cull_pixel(bx, by, lane);
  const float x = (float)(pix % TILE) + 0.5f;
  const float y = (float)(pix / TILE) + 0.5f;

  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
  float ta = 1.0f, tg = 1.0f;

  const float min_t = (float)(1.0 / 255.0);
  if (num_chunks > 0) stage_fields(raw, fields, p, aligned);
  wait_staged();
  __syncthreads();
  int64_t c = 0;
  bool go = num_chunks > 0;
  while (go) {
    const int64_t base = aligned + c * CHUNK;
    // the live rows of this chunk: [lo, hi)
    const int lo = (int)(start > base ? start - base : 0);
    const int hi = (int)(end - base < CHUNK ? end - base : CHUNK);
    if (threadIdx.x < CHUNK) {
      const int r = threadIdx.x;
      if (r >= lo && r < hi) stage_pair<false>(pp, uv, raw, r, tjf, py0);
    }
    __syncthreads();
    // the next chunk's rows land while this one is walked
    if (c + 1 < num_chunks) stage_fields(raw, fields, p, base + CHUNK);

    unsigned list[CHUNK / 32];
#pragma unroll
    for (int m = 0; m < CHUNK / 32; ++m) {
      const int r = 32 * m + lane;
      list[m] = __ballot_sync(FULL_MASK,
                              r >= lo && r < hi && may_cover(uv, r, bxc, byc));
    }

    // cum_*: this chunk's running transmittance products (exclusive of the
    // current pair), applied to the value at the chunk's start, as the plain
    // version's exclusive cumprod does
    float cum_a = 1.0f, cum_g = 1.0f;
#pragma unroll
    for (int m = 0; m < CHUNK / 32; ++m) {
      unsigned bits = list[m];
      while (bits) {
        const int r = 32 * m + __ffs(bits) - 1;
        bits &= bits - 1;
        float4 rgba;  // colour and alpha
        const Planes pl = row_planes(pp, r, rgba);
        float g;
        if (!covers(pl, x, y, g)) continue;
        float agr = rgba.w * g;
        float ag = fminf(agr, 0.9999f);
        float e_a = cum_a * ta;
        float agw = agr * e_a;
        acc[0] += rgba.x * agw;
        acc[1] += rgba.y * agw;
        acc[2] += rgba.z * agw;
        acc[3] += agw;
        if constexpr (!ALBEDO) {
          float pv[9];  // normal, position, depth, metal, rough
          row_rest(pp, r, pv);
          float gw_a = g * e_a;
          float omg = 1.0f - g;
          float gw_g = g * (cum_g * tg);
          acc[8] += pv[F_NRM_X - F_NRM_X] * gw_a;
          acc[9] += pv[F_NRM_Y - F_NRM_X] * gw_a;
          acc[10] += pv[F_NRM_Z - F_NRM_X] * gw_a;
          acc[11] += pv[F_DEPTH - F_NRM_X] * gw_a;
          acc[4] += pv[F_WS_X - F_NRM_X] * gw_g;
          acc[5] += pv[F_WS_Y - F_NRM_X] * gw_g;
          acc[6] += pv[F_WS_Z - F_NRM_X] * gw_g;
          acc[7] += gw_g;
          acc[12] += pv[F_METAL - F_NRM_X] * gw_g;
          acc[13] += pv[F_ROUGH - F_NRM_X] * gw_g;
          cum_g = cum_g * omg;
        }
        cum_a = cum_a * (1.0f - ag);
      }
    }
    ta = ta * cum_a;
    if (!ALBEDO) tg = tg * cum_g;
    ++c;
    // the next chunk's rows have landed once every thread has waited for its
    // pieces and passed the barrier, which also keeps the next chunk's
    // planes from overwriting this one's before every warp is done
    wait_staged();
    const int open = __syncthreads_or(ta > min_t);
    if (threadIdx.x == 0) band_open[c & 1] = open;
    // every band's flag of this chunk; a flag is written again two chunks
    // later, after the next cluster barrier, when every band has read it
    cluster.sync();
    bool any_open = false;
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b)
      any_open = any_open || *cluster.map_shared_rank(&band_open[c & 1], b);
    go = any_open && c < num_chunks;
  }
  // no band leaves while another may still read its flag
  cluster.sync();

  if (walked != nullptr && band == 0 && threadIdx.x == 0) {
    int64_t hi = aligned + c * CHUNK;
    hi = hi < end ? hi : end;
    walked[tile] = (int32_t)(num_chunks > 0 ? hi - start : 0);
  }

  const int64_t w_img = (int64_t)tx * TILE;
  const int64_t plane = (int64_t)gridDim.x / CLUSTER / tx * TILE * w_img;
  const int64_t off = ((int64_t)ti * TILE + pix / TILE) * w_img +
                      (int64_t)tj * TILE + pix % TILE;
#pragma unroll
  for (int ch = 0; ch < NUM_CH; ++ch) {
    float val = ch == 14 ? ta : ch == 15 ? (ALBEDO ? 1.0f : tg) : 0.0f;
    if (ch < NACC) val = acc[ch < NACC ? ch : 0];
    out[ch * plane + off] = val;
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
      composite_kernel<true><<<tiles * CLUSTER, THREADS, 0, s>>>(
          fields, p, tile_starts, tx, (float)height, out, walked);
    } else {
      composite_kernel<false><<<tiles * CLUSTER, THREADS, 0, s>>>(
          fields, p, tile_starts, tx, (float)height, out, walked);
    }
  }
  return (int)cudaGetLastError();
}

// Resident blocks of THREADS threads per SM for one variant, as the CUDA
// occupancy calculator gives them.
extern "C" int m2s_composite_forward_occupancy(int albedo_only, int* blocks) {
  return (int)(albedo_only
                   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, composite_kernel<true>, THREADS, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, composite_kernel<false>, THREADS, 0));
}
