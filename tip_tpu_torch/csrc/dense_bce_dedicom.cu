// Fused dense BCE of Decagon's DEDICOM decoder over the full relation
// pages for Hopper (sm_90a), kernel B13: positives + Poissonized
// negatives, with the gradients (dz, dd, dR) from the same pass.
//
// Per relation t, per cell (i = dst row, j = src column) of the [n, n]
// page DA[t]:
//   L    = z_i D_t R D_t z_j^T                   (DEDICOM, not symmetric)
//   cnt  = #{k < 3 : u24 < q[t, k]}, zeroed where DA > 0
//   loss = sum softplus(-L) * DA + (softplus(-L) + L) * cnt
//   G    = cnt - sigmoid(-L) * (DA + cnt)
// with D_t = diag(d_t) and R [D, D] one global matrix.  With H = G z (rows)
// and H' = G^T z (columns), uI = (H * d_t) R^T, uJ = (H' * d_t) R:
//   dz   += d_t * (uI + uJ)
//   dd_t  = sum_i z_i * (uI + uJ)_i
//   dR   += sum_i (z_i * d_t)^T (H_i * d_t)
// The counter hash, the thresholds and the cell math are those of B2
// (dense_bce.cu): bce_cell.cuh's cell_u24 over the [n, n] plane, so the
// plain version (ops/dense_bce_dedicom.py) draws the same counts.  The JAX
// package has no Decagon model: this kernel replaces no pl.pallas_call.
//
// Design: B2's (dense_bce.cu), whose header gives the tiling, the page
// ring and the G tile.  A block owns one 128 x 128 tile (I, J) of the
// plane for a chunk of RC relations, z_I and z_J in shared memory across
// the chunk, split into TF32 high and low parts; every product is 3xTF32
// on the tensor cores (float32-level error).  What DEDICOM adds:
//  * the row operand X_I = ((z_I * d_t) R) * d_t, a [16, D] x [D, D]
//    product a warp and relation, its result's accumulator fragments read
//    as the logit's A fragments: R's columns are fed in the order
//    8 f + (g >> 1) + 4 (g & 1), so that an accumulator holds the features
//    8 f + t4 and 8 f + t4 + 4 the A fragment wants.  The logit then runs
//    as B2's, X_I against z_J;
//  * uI and uJ, [16, D] x [D, D] products a warp and relation, the H
//    fragments read as A fragments with the k order B2's G z_J uses;
//  * dR: each warp puts H * d_t of its 16 rows in shared memory, and lane
//    a adds (z_i * d_t)_a (H_i * d_t)_b over them into its row of dR, in
//    registers across the chunk; the block's eight rows sums are added in
//    warp order at its end.
// Every block writes its loss, dd, dz and dR partials to scratch, and
// small second passes sum them in a fixed order: the result is
// deterministic.  One fused launch (and four sums) a training step.
//
// Bound on an H100 at Decagon shape (R = 1,097, n = 645, D = 32: 456 M
// cells): the uint8 pages take 0.136 ms at 3.35 TB/s; the three D-long
// dots of a cell are 6 D flops, 18 D as 3xTF32, 263 GFLOP, 0.53 ms at 495
// TFLOP/s; ~20 elementwise float operations a cell take 0.136 ms at 67
// TFLOP/s beside them: the tensor cores bound it (chip_smoke.py reckons
// the bound from its run).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bce_cell.cuh"
#include "tile_math.cuh"

namespace dedicom {

using bce_cell::cell_u24;
using bce_cell::relation_key;
using tile_math::cell_loss;
using tile_math::mma3;
using tile_math::page_value;
using tile_math::sigmoid_neg;
using tile_math::softplus_neg;
using tile_math::split;

constexpr int B = 128;          // tile edge
constexpr int THREADS = 256;    // 8 warps, 16 rows each
constexpr int WARPS = THREADS / 32;
constexpr int CW = 32;          // columns a warp computes at a time
constexpr int GS = B + 4;       // row stride of the G tile
constexpr int STAGES = 3;       // page stages in a warp's ring

__host__ __device__ constexpr int zstride(int d) { return d + 4; }

__host__ __device__ constexpr int stage_row_bytes(int esize) {
  return (CW * esize + 15 + 15) & ~15;
}

__host__ __device__ inline int smem_bytes(int d, int esize, bool grads) {
  // z_I, z_J hi and lo [B][D + 4] and R hi and lo [D][D + 4] words; with
  // grads the G tile [B][GS], the dd partials [WARPS][D] and each warp's
  // H * d_t rows [16][D + 4]; each warp's page ring
  return 4 * (4 * B * zstride(d) + 2 * d * zstride(d) +
              (grads ? B * GS + WARPS * d + WARPS * 16 * zstride(d) : 0)) +
         WARPS * STAGES * 16 * stage_row_bytes(esize);
}

template <typename P>
__device__ __forceinline__ void fetch_stage(const P* pages, const uint8_t* end,
                                            int t, int n, int r0, int c0,
                                            uint8_t* st, int lane) {
  constexpr int ESZ = sizeof(P);
  constexpr int RS = stage_row_bytes(ESZ);
  constexpr int CH = RS / 16;
  const int nbytes = min(CW, n - c0) * ESZ;
  const int rows = min(16, n - r0);
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH;
    if (r >= rows) break;
    tile_math::stage_span_chunk(
        st + r * RS, (const uint8_t*)(pages + ((size_t)t * n + r0 + r) * n + c0),
        nbytes, end, idx % CH);
  }
  tile_math::cp_async_commit();
}

// the R column fed at position g of n-tile f of X's product
__device__ __forceinline__ int xcol(int f, int g) {
  return 8 * f + (g >> 1) + 4 * (g & 1);
}

// grid: (nb * nb tiles, ceil(n_et / rc) relation chunks); tile = I * nb + J.
// Writes loss_part[blk]; with GRADS also dd_part[tile][t], the tile's dz
// row and column partials dz_part[blk][side][r] and dR_part[blk], blk =
// chunk * nb^2 + tile.
template <typename P, int D, bool GRADS>
__global__ void __launch_bounds__(THREADS, 1)
dedicom_kernel(const float* __restrict__ dvec,
               const float* __restrict__ rmat, const float* __restrict__ z,
               const P* __restrict__ pages, const int32_t* __restrict__ q,
               uint32_t seed, int n_et, int n, int nb, int rc,
               float* __restrict__ loss_part, float* __restrict__ dd_part,
               float* __restrict__ dz_part, float* __restrict__ dr_part) {
  constexpr int ZS = zstride(D);
  constexpr int KK = D / 8;
  constexpr int ESZ = sizeof(P);
  constexpr int RS = stage_row_bytes(ESZ);
  constexpr int SB = 16 * RS;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float warp_loss[WARPS];
  uint32_t* zih = smem;
  uint32_t* zil = zih + B * ZS;
  uint32_t* zjh = zil + B * ZS;
  uint32_t* zjl = zjh + B * ZS;
  uint32_t* rh = zjl + B * ZS;      // [D][ZS] R, TF32 high part
  uint32_t* rl = rh + D * ZS;       // [D][ZS] low part
  float* Gt = (float*)(rl + D * ZS);                 // [B][GS]       (GRADS)
  float* red = Gt + (GRADS ? B * GS : 0);            // [WARPS][D]    (GRADS)
  float* hd = red + (GRADS ? WARPS * D : 0);         // [WARPS][16][ZS] (GRADS)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  uint8_t* ring = (uint8_t*)(hd + (GRADS ? WARPS * 16 * ZS : 0)) +
                  warp * STAGES * SB;
  const uint8_t* end = (const uint8_t*)(pages + (size_t)n_et * n * n);
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int row0 = (tile / nb) * B, col0 = (tile % nb) * B;
  const int t0 = blockIdx.y * rc;
  const int t1 = min(t0 + rc, n_et);

  const int m0 = warp * 16;
  const bool rows_live = row0 + m0 < n;
  const int ncw = (min(B, n - col0) + CW - 1) / CW;
  const int n_stages = rows_live ? (t1 - t0) * ncw : 0;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages)
      fetch_stage(pages, end, t0 + s / ncw, n, row0 + m0, col0 + (s % ncw) * CW,
                  ring + s * SB, lane);
    else
      tile_math::cp_async_commit();
  }

  for (int idx = tid; idx < B * D; idx += THREADS) {
    const int r = idx / D, k = idx % D;
    const float vi = row0 + r < n ? z[(size_t)(row0 + r) * D + k] : 0.f;
    const float vj = col0 + r < n ? z[(size_t)(col0 + r) * D + k] : 0.f;
    split(vi, zih[r * ZS + k], zil[r * ZS + k]);
    split(vj, zjh[r * ZS + k], zjl[r * ZS + k]);
  }
  for (int idx = tid; idx < D * D; idx += THREADS)
    split(rmat[idx], rh[(idx / D) * ZS + idx % D], rl[(idx / D) * ZS + idx % D]);
  if constexpr (GRADS) {
    for (int idx = tid; idx < B * GS; idx += THREADS) Gt[idx] = 0.f;
  }
  __syncthreads();

  // z_I in the A-fragment layout: rows m0+g, m0+g+8; features 8kk + t4,
  // 8kk + t4 + 4
  float za[KK][4];
  // z_I in the accumulator layout: rows m0+g, m0+g+8; features 8f + 2t4,
  // 8f + 2t4 + 1
  float zc[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int r0 = row0 + m0 + g, r1 = r0 + 8;
    const int f0 = 8 * kk + t4, f1 = 8 * kk + 2 * t4;
    za[kk][0] = r0 < n ? z[(size_t)r0 * D + f0] : 0.f;
    za[kk][1] = r1 < n ? z[(size_t)r1 * D + f0] : 0.f;
    za[kk][2] = r0 < n ? z[(size_t)r0 * D + f0 + 4] : 0.f;
    za[kk][3] = r1 < n ? z[(size_t)r1 * D + f0 + 4] : 0.f;
    zc[kk][0] = r0 < n ? z[(size_t)r0 * D + f1] : 0.f;
    zc[kk][1] = r0 < n ? z[(size_t)r0 * D + f1 + 1] : 0.f;
    zc[kk][2] = r1 < n ? z[(size_t)r1 * D + f1] : 0.f;
    zc[kk][3] = r1 < n ? z[(size_t)r1 * D + f1 + 1] : 0.f;
  }
  // z of this warp's 16 columns (G^T's rows) in the accumulator layout
  float zcj[KK][4];
  {
    const int j0 = col0 + warp * 16 + g, j1 = j0 + 8;
#pragma unroll
    for (int f = 0; f < KK; ++f) {
      const int f1 = 8 * f + 2 * t4;
      zcj[f][0] = j0 < n ? z[(size_t)j0 * D + f1] : 0.f;
      zcj[f][1] = j0 < n ? z[(size_t)j0 * D + f1 + 1] : 0.f;
      zcj[f][2] = j1 < n ? z[(size_t)j1 * D + f1] : 0.f;
      zcj[f][3] = j1 < n ? z[(size_t)j1 * D + f1 + 1] : 0.f;
    }
  }

  float loss_acc = 0.f;
  float accI[KK][4], accJ[KK][4];
  float dra[D];  // lane a's row of dR (a = lane < D)
#pragma unroll
  for (int f = 0; f < KK; ++f)
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) accI[f][q4] = accJ[f][q4] = 0.f;
#pragma unroll
  for (int b = 0; b < D; ++b) dra[b] = 0.f;

  int k = 0;
  for (int t = t0; t < t1; ++t) {
    if constexpr (GRADS) __syncthreads();  // the last relation's G reads
    const uint32_t key = relation_key(seed, (uint32_t)t);
    const int q0 = q[t * 3], q1 = q[t * 3 + 1], q2 = q[t * 3 + 2];
    const float* dt = dvec + (size_t)t * D;
    float dA[KK][2], dC[KK][2];  // d_t at 8f + t4 (+4) and 8f + 2t4 (+1)
#pragma unroll
    for (int f = 0; f < KK; ++f) {
      dA[f][0] = dt[8 * f + t4];
      dA[f][1] = dt[8 * f + t4 + 4];
      dC[f][0] = dt[8 * f + 2 * t4];
      dC[f][1] = dt[8 * f + 2 * t4 + 1];
    }
    // X_I = ((z_I * d_t) R) * d_t, then its A fragments
    uint32_t ah[KK][4], al[KK][4];
    {
      uint32_t zh[KK][4], zl[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        split(__fmul_rn(za[kk][0], dA[kk][0]), zh[kk][0], zl[kk][0]);
        split(__fmul_rn(za[kk][1], dA[kk][0]), zh[kk][1], zl[kk][1]);
        split(__fmul_rn(za[kk][2], dA[kk][1]), zh[kk][2], zl[kk][2]);
        split(__fmul_rn(za[kk][3], dA[kk][1]), zh[kk][3], zl[kk][3]);
      }
#pragma unroll
      for (int f = 0; f < KK; ++f) {
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        const int col = xcol(f, g);
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const int o = (8 * kk + t4) * ZS + col;
          mma3(x, zh[kk], zl[kk], rh[o], rh[o + 4 * ZS], rl[o], rl[o + 4 * ZS]);
        }
        // x: (g, 8f + t4), (g, 8f + t4 + 4), (g + 8, 8f + t4), (g + 8, +4)
        split(__fmul_rn(x[0], dA[f][0]), ah[f][0], al[f][0]);
        split(__fmul_rn(x[2], dA[f][0]), ah[f][1], al[f][1]);
        split(__fmul_rn(x[1], dA[f][1]), ah[f][2], al[f][2]);
        split(__fmul_rn(x[3], dA[f][1]), ah[f][3], al[f][3]);
      }
    }
    float hI[KK][4];  // (G z_J) rows m0+g(+8), features 8f + 2t4 (+1)
#pragma unroll
    for (int f = 0; f < KK; ++f)
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) hI[f][q4] = 0.f;

    for (int cw = 0; rows_live && cw < ncw; ++cw, ++k) {
      tile_math::cp_async_wait<STAGES - 2>();
      __syncwarp();
      const int kn = k + STAGES - 1;
      if (kn < n_stages)
        fetch_stage(pages, end, t0 + kn / ncw, n, row0 + m0,
                    col0 + (kn % ncw) * CW, ring + (kn % STAGES) * SB, lane);
      else
        tile_math::cp_async_commit();
      const int c0 = cw * CW;
      const uint8_t* st = ring + (k % STAGES) * SB;
      const uint8_t* prow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl2 = g + 8 * h;
        const size_t e = ((size_t)t * n + row0 + m0 + rl2) * n + col0 + c0;
        prow[h] = st + rl2 * RS + (int)((e * ESZ) & 15);
      }
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt) {
        const int cb = c0 + nt * 8;
        float L[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const int o = (cb + g) * ZS + 8 * kk + t4;
          mma3(L, ah[kk], al[kk], zjh[o], zjh[o + 4], zjl[o], zjl[o + 4]);
        }
        float Gv[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int q4 = 2 * h + e2;
            const int c = nt * 8 + 2 * t4 + e2;
            const int gr = row0 + m0 + g + 8 * h, gc = col0 + c0 + c;
            const bool inside = gr < n && gc < n;
            const float pv = page_value((const P*)(prow[h] + c * ESZ));
            const float da = inside ? pv : 0.f;
            const int u = cell_u24(key, (uint32_t)gr * (uint32_t)n + (uint32_t)gc);
            float cnt = (float)((u < q0) + (u < q1) + (u < q2));
            if (da > 0.f || !inside) cnt = 0.f;
            const float x = L[q4];
            float e;
            const float sp = softplus_neg(x, e);
            loss_acc = __fadd_rn(loss_acc, cell_loss(sp, x, da, cnt));
            if constexpr (GRADS) Gv[q4] = cnt - sigmoid_neg(x, e) * (da + cnt);
          }
        }
        if constexpr (GRADS) {
          *(float2*)(Gt + (m0 + g) * GS + cb + 2 * t4) = make_float2(Gv[0], Gv[1]);
          *(float2*)(Gt + (m0 + g + 8) * GS + cb + 2 * t4) =
              make_float2(Gv[2], Gv[3]);
          uint32_t gh[4], gl[4];
          split(Gv[0], gh[0], gl[0]);
          split(Gv[2], gh[1], gl[1]);
          split(Gv[1], gh[2], gl[2]);
          split(Gv[3], gh[3], gl[3]);
#pragma unroll
          for (int f = 0; f < KK; ++f) {
            const int o = (cb + 2 * t4) * ZS + 8 * f + g;
            mma3(hI[f], gh, gl, zjh[o], zjh[o + ZS], zjl[o], zjl[o + ZS]);
          }
        }
      }
    }

    if constexpr (GRADS) {
      // H * d_t as A fragments (k = t4 <-> feature 8f + 2t4, k = t4 + 4 <->
      // 8f + 2t4 + 1), kept for dR in this warp's rows of hd
      uint32_t hh[KK][4], hl[KK][4];
      float* hw = hd + warp * 16 * ZS;
#pragma unroll
      for (int f = 0; f < KK; ++f) {
        const float v0 = __fmul_rn(hI[f][0], dC[f][0]);
        const float v1 = __fmul_rn(hI[f][1], dC[f][1]);
        const float v2 = __fmul_rn(hI[f][2], dC[f][0]);
        const float v3 = __fmul_rn(hI[f][3], dC[f][1]);
        split(v0, hh[f][0], hl[f][0]);
        split(v2, hh[f][1], hl[f][1]);
        split(v1, hh[f][2], hl[f][2]);
        split(v3, hh[f][3], hl[f][3]);
        *(float2*)(hw + g * ZS + 8 * f + 2 * t4) = make_float2(v0, v1);
        *(float2*)(hw + (g + 8) * ZS + 8 * f + 2 * t4) = make_float2(v2, v3);
      }
      // uI = (H * d_t) R^T: accumulator (row, 8nf + 2t4 (+1))
#pragma unroll
      for (int nf = 0; nf < KK; ++nf) {
        float uI[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int f = 0; f < KK; ++f) {
          const int o = (8 * nf + g) * ZS + 8 * f + 2 * t4;
          mma3(uI, hh[f], hl[f], rh[o], rh[o + 1], rl[o], rl[o + 1]);
        }
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4)
          accI[nf][q4] = fmaf(dC[nf][q4 & 1], uI[q4], accI[nf][q4]);
        float s0 = fmaf(zc[nf][0], uI[0], zc[nf][2] * uI[2]);
        float s1 = fmaf(zc[nf][1], uI[1], zc[nf][3] * uI[3]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (g == 0) {
          red[warp * D + 8 * nf + 2 * t4] = s0;
          red[warp * D + 8 * nf + 2 * t4 + 1] = s1;
        }
      }
      __syncwarp();  // hd's rows are in
      if (lane < D) {
        for (int r = 0; r < 16; ++r) {
          const int row = row0 + m0 + r;
          const float zd = row < n ? __fmul_rn(z[(size_t)row * D + lane],
                                               dt[lane])
                                   : 0.f;
          const float* hr = hw + r * ZS;
#pragma unroll
          for (int b = 0; b < D; ++b) dra[b] = fmaf(zd, hr[b], dra[b]);
        }
      }
      __syncthreads();  // the G tile and the row dd partials are complete
      // G^T z_I for columns j0..j0+15, then uJ = (H' * d_t) R
      const int j0 = warp * 16;
      if (col0 + j0 < n) {
        float hJ[KK][4];
#pragma unroll
        for (int f = 0; f < KK; ++f)
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) hJ[f][q4] = 0.f;
        const int kend = min(B, n - row0);
        for (int kb = 0; kb < kend; kb += 8) {
          const float* g0 = Gt + (kb + 2 * t4) * GS + j0 + g;
          uint32_t gh[4], gl[4];
          split(g0[0], gh[0], gl[0]);
          split(g0[8], gh[1], gl[1]);
          split(g0[GS], gh[2], gl[2]);
          split(g0[GS + 8], gh[3], gl[3]);
#pragma unroll
          for (int f = 0; f < KK; ++f) {
            const int o = (kb + 2 * t4) * ZS + 8 * f + g;
            mma3(hJ[f], gh, gl, zih[o], zih[o + ZS], zil[o], zil[o + ZS]);
          }
        }
#pragma unroll
        for (int f = 0; f < KK; ++f) {
          split(__fmul_rn(hJ[f][0], dC[f][0]), hh[f][0], hl[f][0]);
          split(__fmul_rn(hJ[f][2], dC[f][0]), hh[f][1], hl[f][1]);
          split(__fmul_rn(hJ[f][1], dC[f][1]), hh[f][2], hl[f][2]);
          split(__fmul_rn(hJ[f][3], dC[f][1]), hh[f][3], hl[f][3]);
        }
#pragma unroll
        for (int nf = 0; nf < KK; ++nf) {
          float uJ[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int f = 0; f < KK; ++f) {
            const int o = (8 * f + 2 * t4) * ZS + 8 * nf + g;
            mma3(uJ, hh[f], hl[f], rh[o], rh[o + ZS], rl[o], rl[o + ZS]);
          }
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4)
            accJ[nf][q4] = fmaf(dC[nf][q4 & 1], uJ[q4], accJ[nf][q4]);
          float s0 = fmaf(zcj[nf][0], uJ[0], zcj[nf][2] * uJ[2]);
          float s1 = fmaf(zcj[nf][1], uJ[1], zcj[nf][3] * uJ[3]);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          }
          if (g == 0) {
            red[warp * D + 8 * nf + 2 * t4] += s0;
            red[warp * D + 8 * nf + 2 * t4 + 1] += s1;
          }
        }
      }
      __syncthreads();  // the column dd partials are in
      if (tid < D) {
        float s = 0.f;
        for (int kw = 0; kw < WARPS; ++kw) s += red[kw * D + tid];
        dd_part[((size_t)tile * n_et + t) * D + tid] = s;
      }
    }
  }
  tile_math::cp_async_wait<0>();

  const size_t blk = (size_t)blockIdx.y * n_tiles + tile;
  if constexpr (GRADS) {
    float* outI = dz_part + (blk * 2 * B + m0) * D;
    float* outJ = dz_part + ((blk * 2 + 1) * B + warp * 16) * D;
#pragma unroll
    for (int f = 0; f < KK; ++f) {
      const int kf = 8 * f + 2 * t4;
      *(float2*)(outI + g * D + kf) = make_float2(accI[f][0], accI[f][1]);
      *(float2*)(outI + (g + 8) * D + kf) = make_float2(accI[f][2], accI[f][3]);
      *(float2*)(outJ + g * D + kf) = make_float2(accJ[f][0], accJ[f][1]);
      *(float2*)(outJ + (g + 8) * D + kf) = make_float2(accJ[f][2], accJ[f][3]);
    }
    // dR: the warps' rows summed in warp order, through the G tile's room
    __syncthreads();
    float* dw = Gt;  // [WARPS][D][D]
    if (lane < D) {
#pragma unroll
      for (int b = 0; b < D; ++b) dw[(warp * D + lane) * D + b] = dra[b];
    }
    __syncthreads();
    for (int e = tid; e < D * D; e += THREADS) {
      float s = 0.f;
      for (int kw = 0; kw < WARPS; ++kw) s += dw[kw * D * D + e];
      dr_part[blk * D * D + e] = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    loss_acc = __fadd_rn(loss_acc, __shfl_down_sync(0xffffffffu, loss_acc, off));
  if (lane == 0) warp_loss[warp] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int kw = 0; kw < WARPS; ++kw) s = __fadd_rn(s, warp_loss[kw]);
    loss_part[blk] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
reduce_loss(const float* __restrict__ part, int count, float* __restrict__ out) {
  __shared__ float s[THREADS];
  float acc = 0.f;
  for (int k = threadIdx.x; k < count; k += THREADS) acc = __fadd_rn(acc, part[k]);
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s[0];
}

// out[e] = sum over k < count of part[k * m + e], in k order
__global__ void reduce_rows(const float* __restrict__ part, int count,
                           size_t m, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float s = 0.f;
  for (int k = 0; k < count; ++k) s += part[(size_t)k * m + e];
  out[e] = s;
}

// dz[row, k]: rows of block b collect the row part of tiles (b, J) and the
// column part of tiles (I, b), for every J and I, over every relation chunk
__global__ void reduce_dz(const float* __restrict__ part, int n_chunks, int nb,
                          int n, int d, float* __restrict__ dz) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * d) return;
  const int row = idx / d, k = idx % d;
  const int b = row / B, rr = row % B;
  const int n_tiles = nb * nb;
  float s = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t base = (size_t)ch * n_tiles;
    for (int jj = 0; jj < nb; ++jj)
      s += part[(((base + b * nb + jj) * 2 + 0) * B + rr) * d + k];
    for (int ii = 0; ii < nb; ++ii)
      s += part[(((base + ii * nb + b) * 2 + 1) * B + rr) * d + k];
  }
  dz[idx] = s;
}

template <typename P, int D, bool GRADS>
cudaError_t launch(const float* dvec, const float* rmat, const float* z,
                   const P* pages, const int32_t* q, uint32_t seed, int n_et,
                   int n, int rc, float* loss_part, float* dd_part,
                   float* dz_part, float* dr_part, float* loss, float* dd,
                   float* dz, float* dr, cudaStream_t stream) {
  const int nb = (n + B - 1) / B;
  const int n_tiles = nb * nb;
  const int n_chunks = (n_et + rc - 1) / rc;
  const int smem = smem_bytes(D, (int)sizeof(P), GRADS);
  cudaError_t err = cudaFuncSetAttribute(
      dedicom_kernel<P, D, GRADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dedicom_kernel<P, D, GRADS><<<dim3(n_tiles, n_chunks), THREADS, smem, stream>>>(
      dvec, rmat, z, pages, q, seed, n_et, n, nb, rc, loss_part, dd_part,
      dz_part, dr_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_loss<<<1, THREADS, 0, stream>>>(loss_part, n_tiles * n_chunks, loss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (GRADS) {
    const size_t mdd = (size_t)n_et * D, mdr = (size_t)D * D;
    reduce_rows<<<(unsigned)((mdd + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(dd_part, n_tiles, mdd, dd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    reduce_rows<<<(unsigned)((mdr + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(dr_part, n_tiles * n_chunks, mdr, dr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    reduce_dz<<<(n * D + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        dz_part, n_chunks, nb, n, D, dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename P, int D>
cudaError_t dispatch(int grads, const float* dvec, const float* rmat,
                     const float* z, const void* pages, const int32_t* q,
                     uint32_t seed, int n_et, int n, int rc, float* lp,
                     float* ddp, float* dzp, float* drp, float* loss,
                     float* dd, float* dz, float* dr, cudaStream_t stream) {
  const P* p = static_cast<const P*>(pages);
  if (grads)
    return launch<P, D, true>(dvec, rmat, z, p, q, seed, n_et, n, rc, lp, ddp,
                              dzp, drp, loss, dd, dz, dr, stream);
  return launch<P, D, false>(dvec, rmat, z, p, q, seed, n_et, n, rc, lp, ddp,
                             dzp, drp, loss, dd, dz, dr, stream);
}

template <typename P>
cudaError_t dispatch_d(int d, int grads, const float* dvec, const float* rmat,
                       const float* z, const void* pages, const int32_t* q,
                       uint32_t seed, int n_et, int n, int rc, float* lp,
                       float* ddp, float* dzp, float* drp, float* loss,
                       float* dd, float* dz, float* dr, cudaStream_t stream) {
  switch (d) {
    case 8:
      return dispatch<P, 8>(grads, dvec, rmat, z, pages, q, seed, n_et, n, rc,
                            lp, ddp, dzp, drp, loss, dd, dz, dr, stream);
    case 16:
      return dispatch<P, 16>(grads, dvec, rmat, z, pages, q, seed, n_et, n, rc,
                             lp, ddp, dzp, drp, loss, dd, dz, dr, stream);
    case 32:
      return dispatch<P, 32>(grads, dvec, rmat, z, pages, q, seed, n_et, n, rc,
                             lp, ddp, dzp, drp, loss, dd, dz, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dedicom

// Plain C entry point (bound with ctypes by ops/dense_bce_dedicom.py).
// dvec [n_et][d], rmat [d][d], z [n][d] float32; pages [n_et][n][n] uint8,
// 16-byte aligned; q [n_et][3] int32; d 8, 16 or 32.  Scratch sizes, in floats: loss_part nb^2 n_chunks;
// dd_part nb^2 n_et d; dz_part n_chunks nb^2 2 128 d; dr_part nb^2
// n_chunks d^2, where nb = ceil(n / 128) and n_chunks = ceil(n_et / rc).
// With grads 0 the gradient pointers are not touched.  Returns the first
// CUDA error.
extern "C" int tip_dense_bce_dedicom(
    const float* dvec, const float* rmat, const float* z, const void* pages,
    const int32_t* q, unsigned int seed, int n_et, int n, int d, int rc,
    int grads, float* loss_part, float* dd_part, float* dz_part,
    float* dr_part, float* loss, float* dd, float* dz, float* dr,
    void* stream) {
  using namespace dedicom;
  cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)pages % 16 != 0) return (int)cudaErrorInvalidValue;
  return dispatch_d<uint8_t>(d, grads, dvec, rmat, z, pages, q, seed, n_et, n,
                             rc, loss_part, dd_part, dz_part, dr_part, loss,
                             dd, dz, dr, s);
}
