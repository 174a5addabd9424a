// K4 composite backward: the VJP of the per-tile front-to-back composite
// (K3), from the G-buffer's cotangent to the gradient of every pair-field
// row.
//
// Replaces the Pallas kernel of mesh2splat_tpu/render/composite.py::
// _make_backward_kernel (launched by _composite_bwd), both its full and its
// albedo_only variants. Plain version: mesh2splat_torch/render/composite.py::
// composite_backward_plain.
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
// Bound on the H100: f32 operations. Every walked (pair, pixel) evaluates
// the coverage (22 flops, as K3) and every covered one the chain above and
// its 10 (albedo) or 19 (full) reduction terms; a pair's fields are read
// once per tile and its gradient rows written once.
//
// Design: one block per tile, 256 threads with 4 pixels each (rows
// 4w..4w+3 of the tile for warp w, one column per lane). Each chunk of 128
// pairs is staged in shared memory once (plane coefficients, as K3, plus
// the pair's values and its tile-local mean and conic); each pixel walks the
// chunk in pair order with its T_a, T_g, Bpref_a and Bpref_g in registers.
// The per-pair sums reduce within each warp with __shfl_xor_sync (skipped
// when no lane of the warp is covered, which gives an exact zero), then
// across the 8 warps in shared memory in a fixed order, in sub-chunks of 32
// pairs, so the result does not vary from run to run. Every pair row belongs
// to exactly one tile: the block stores only the rows of its own
// [start, end) with plain stores into a zeroed output, which replaces the
// Pallas kernel's read-modify-write of the gradient window it shares with
// the previous tile (safe there only because a TPU grid runs in order).
#include "composite_common.cuh"

namespace {

using namespace m2s_comp;

constexpr int WARPS = THREADS / 32;
constexpr int SUB = 32;  // pairs per cross-warp reduction

// per-pair terms staged after the plane coefficients
enum {
  S_ALPHA = S_PLANES_END, S_R, S_G, S_B, S_MXP, S_MYP, S_CA, S_CB, S_CC,
  S_ALBEDO_END,
  S_NX = S_ALBEDO_END, S_NY, S_NZ, S_DEPTH, S_WX, S_WY, S_WZ, S_METAL,
  S_ROUGH,
  S_FULL_END
};

// reduction terms per pair
enum {
  V_M0 = 0, V_MX, V_MY, V_MXX, V_MXY, V_MYY, V_ALPHA, V_R, V_G, V_B,
  V_ALBEDO_END,
  V_NX = V_ALBEDO_END, V_NY, V_NZ, V_DEPTH, V_WX, V_WY, V_WZ, V_METAL,
  V_ROUGH,
  V_FULL_END
};

template <bool ALBEDO>
__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const float* __restrict__ fields, int64_t p,
                     const int32_t* __restrict__ tile_starts, int tx,
                     float height, const float* __restrict__ ct,
                     const float* __restrict__ res,
                     float* __restrict__ dfields) {
  constexpr int NS = ALBEDO ? S_ALBEDO_END : S_FULL_END;
  constexpr int NV = ALBEDO ? V_ALBEDO_END : V_FULL_END;
  __shared__ float sp[NS][CHUNK];
  __shared__ unsigned char slive[CHUNK];
  __shared__ float part[SUB][WARPS][NV];
  __shared__ float red[SUB][NV];

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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // per pixel: coordinates, the cotangent, the two totals and the walk's
  // state (T, Bpref at the chunk's start, and this chunk's running terms)
  const int64_t w_img = (int64_t)tx * TILE;
  const int64_t plane = (int64_t)gridDim.x / tx * TILE * w_img;
  float xs[PPT], ys[PPT];
  float c_rgba[PPT][4], c_n[PPT][4], c_g[PPT][6];
  float res_a[PPT], res_g[PPT];
  float ta[PPT], tg[PPT], bpa[PPT], bpg[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int row = warp * PPT + q;
    xs[q] = (float)lane + 0.5f;
    ys[q] = (float)row + 0.5f;
    const int64_t off = ((int64_t)ti * TILE + row) * w_img +
                        (int64_t)tj * TILE + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) c_rgba[q][k] = ct[k * plane + off];
    res_a[q] = res[off];
    if constexpr (!ALBEDO) {
#pragma unroll
      for (int k = 0; k < 4; ++k) c_n[q][k] = ct[(8 + k) * plane + off];
#pragma unroll
      for (int k = 0; k < 4; ++k) c_g[q][k] = ct[(4 + k) * plane + off];
      c_g[q][4] = ct[12 * plane + off];
      c_g[q][5] = ct[13 * plane + off];
      res_g[q] = res[plane + off];
    }
    ta[q] = 1.0f;
    tg[q] = 1.0f;
    bpa[q] = 0.0f;
    bpg[q] = 0.0f;
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
        const float ca = fld(F_CONIC_A), cb = fld(F_CONIC_B),
                    cc = fld(F_CONIC_C);
        const float mxp = fld(F_MEAN_X) - tjf;
        const float myp = fld(F_MEAN_Y) - py0;
        stage_planes(sp, r, ca, cb, cc, mxp, myp);
        sp[S_ALPHA][r] = fld(F_ALPHA);
        sp[S_R][r] = fld(F_COL_R);
        sp[S_G][r] = fld(F_COL_G);
        sp[S_B][r] = fld(F_COL_B);
        sp[S_MXP][r] = mxp;
        sp[S_MYP][r] = myp;
        sp[S_CA][r] = ca;
        sp[S_CB][r] = cb;
        sp[S_CC][r] = cc;
        if constexpr (!ALBEDO) {
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
    for (int sub = 0; sub < CHUNK; sub += SUB) {
      for (int rr = 0; rr < SUB; ++rr) {
        const int r = sub + rr;
        float v[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k) v[k] = 0.0f;
        bool any = false;
        if (slive[r]) {
          const float alpha = sp[S_ALPHA][r];
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            const float xx = xs[q] * xs[q];
            const float xy = xs[q] * ys[q];
            const float yy = ys[q] * ys[q];
            float g;
            if (!falloff(sp, r, xs[q], ys[q], xx, xy, yy, g)) continue;
            any = true;
            const float agr = alpha * g;
            const float ag = fminf(agr, 0.9999f);
            const float e_a = cum_a[q] * ta[q];
            const float gw_a = g * e_a;
            const float ct_rgb3 = sp[S_R][r] * c_rgba[q][0] +
                                  sp[S_G][r] * c_rgba[q][1] +
                                  sp[S_B][r] * c_rgba[q][2] + c_rgba[q][3];
            float sdot_a = alpha * ct_rgb3;
            if constexpr (!ALBEDO) {
              sdot_a = sdot_a + (sp[S_NX][r] * c_n[q][0] +
                                 sp[S_NY][r] * c_n[q][1] +
                                 sp[S_NZ][r] * c_n[q][2] +
                                 sp[S_DEPTH][r] * c_n[q][3]);
            }
            run_a[q] = run_a[q] + sdot_a * gw_a;
            const float bpref_a = bpa[q] + run_a[q];
            const float da = -(res_a[q] - bpref_a) / (1.0f - ag);
            float dl_dg = sdot_a * e_a + da * alpha;
            float gw_g = 0.0f;
            if constexpr (!ALBEDO) {
              const float omg = 1.0f - g;
              const float e_g = cum_g[q] * tg[q];
              gw_g = g * e_g;
              const float sdot_g =
                  sp[S_WX][r] * c_g[q][0] + sp[S_WY][r] * c_g[q][1] +
                  sp[S_WZ][r] * c_g[q][2] + c_g[q][3] +
                  sp[S_METAL][r] * c_g[q][4] + sp[S_ROUGH][r] * c_g[q][5];
              run_g[q] = run_g[q] + sdot_g * gw_g;
              const float bpref_g = bpg[q] + run_g[q];
              const float dgg = -(res_g[q] - bpref_g) / fmaxf(omg, 1e-4f);
              dl_dg = dl_dg + sdot_g * e_g + dgg;
              cum_g[q] = cum_g[q] * omg;
            }
            const float gp = dl_dg * g;                    // dL/dpower
            const float dal = g * (ct_rgb3 * e_a + da);    // dL/dalpha
            const float w_rgb = agr * e_a;
            v[V_M0] += gp;
            v[V_MX] += gp * xs[q];
            v[V_MY] += gp * ys[q];
            v[V_MXX] += gp * xx;
            v[V_MXY] += gp * xy;
            v[V_MYY] += gp * yy;
            v[V_ALPHA] += dal;
            v[V_R] += w_rgb * c_rgba[q][0];
            v[V_G] += w_rgb * c_rgba[q][1];
            v[V_B] += w_rgb * c_rgba[q][2];
            if constexpr (!ALBEDO) {
              v[V_NX] += gw_a * c_n[q][0];
              v[V_NY] += gw_a * c_n[q][1];
              v[V_NZ] += gw_a * c_n[q][2];
              v[V_DEPTH] += gw_a * c_n[q][3];
              v[V_WX] += gw_g * c_g[q][0];
              v[V_WY] += gw_g * c_g[q][1];
              v[V_WZ] += gw_g * c_g[q][2];
              v[V_METAL] += gw_g * c_g[q][4];
              v[V_ROUGH] += gw_g * c_g[q][5];
            }
            cum_a[q] = cum_a[q] * (1.0f - ag);
          }
        }
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int k = 0; k < NV; ++k) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < NV; ++k) part[rr][warp][k] = v[k];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < SUB * NV; i += THREADS) {
        const int rr = i / NV;
        const int k = i - rr * NV;
        float s = part[rr][0][k];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += part[rr][w][k];
        red[rr][k] = s;
      }
      __syncthreads();
      if (threadIdx.x < SUB) {
        // the per-pair chain to the mean, conic, colour and alpha rows
        const int rr = threadIdx.x;
        const int r = sub + rr;
        if (slive[r]) {
          const int64_t row = base + r;
          const float* m = red[rr];
          const float mxp = sp[S_MXP][r], myp = sp[S_MYP][r];
          const float ca = sp[S_CA][r], cb = sp[S_CB][r], cc = sp[S_CC][r];
          const float gx = mxp * m[V_M0] - m[V_MX];   // sum gp * dx
          const float gy = myp * m[V_M0] + m[V_MY];   // sum gp * dy
          auto put = [&](int f, float val) { dfields[(int64_t)f * p + row] = val; };
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
    // the chain above reads this chunk's stage: wait before restaging
    __syncthreads();
  }
}

}  // namespace

extern "C" int m2s_composite_backward(const float* fields, int64_t p,
                                      const int32_t* tile_starts, int ty,
                                      int tx, int height, int albedo_only,
                                      const float* ct, const float* res,
                                      float* dfields, void* stream) {
  const int tiles = ty * tx;
  if (tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (albedo_only) {
      composite_bwd_kernel<true><<<tiles, THREADS, 0, s>>>(
          fields, p, tile_starts, tx, (float)height, ct, res, dfields);
    } else {
      composite_bwd_kernel<false><<<tiles, THREADS, 0, s>>>(
          fields, p, tile_starts, tx, (float)height, ct, res, dfields);
    }
  }
  return (int)cudaGetLastError();
}
