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
// Design.  A block owns one 128 x 128 tile (I, J) of the plane for a
// chunk of RC relations, its eight warps 16 rows each, each warp streaming
// the uint8 pages of its rows through a cp.async ring; every product is
// 3xTF32 (operands split into TF32 high and low parts, lo*hi + hi*lo +
// hi*hi: float32-level error).  Two kinds of tensor-core product:
//  * per warp, on mma.sync inside the cell math: X_I = ((z_I * d_t) R) *
//    d_t, [16, D] x [D, D] (R's columns fed in the order 8 f + (g >> 1) +
//    4 (g & 1), so that an accumulator holds the features 8 f + t4 and
//    8 f + t4 + 4 the logit's A fragment wants); then 32 columns at a time
//    the logits L = X_I z_J^T, the cells, G into a float32 tile in shared
//    memory and H += G z_J (G's accumulator read as the A fragment, k =
//    2 t4, 2 t4 + 1).  These small products hide in the warp's own cell
//    math; on warpgroup MMA each 32 columns' issue and waits would hold
//    the four warps of a warpgroup together, which costs more than they
//    do (measured: PERF.md §6);
//  * per warpgroup (warps 4 w .. 4 w + 3, 64 rows), on asynchronous wgmma
//    (wgmma_tf32.cuh: A from registers, B K-major in shared memory, its k
//    in the same 2 t4, 2 t4 + 1 order): uI = (H * d_t) R^T; after a block
//    barrier P^T = H^T z_I over its 64 rows (A read from H's rows in
//    shared memory), then H' = G^T z_I for its 64 columns over the 128
//    rows (A read from the G tile), then uJ = (H' * d_t) R.
// dR and dd come from P = z_I^T G z_J [D, D], without z: dR += D_t P D_t,
// dd_t[a] = sum_b R[a][b] d_b P[a][b] (uI's dots with z) + sum_b R[b][a]
// d_b P[b][a] (uJ's).  P's sum over the rows can cancel, and the tensor
// cores' own adds truncate: each 8 rows' P goes to a fresh accumulator,
// and the steps are added in float32.  Every block writes its loss, dd, dz
// and dR partials to scratch, and small second passes sum them in a fixed
// order: the result is deterministic.  One fused launch (and four sums) a
// training step.
//
// Bound on an H100 at Decagon shape (R = 1,097, n = 645, D = 32: 456 M
// cells): the uint8 pages take 0.136 ms at 3.35 TB/s; the three D-long
// dots of a cell are 6 D flops, 18 D as 3xTF32, 263 GFLOP, 0.53 ms at 495
// TFLOP/s; ~20 elementwise float operations a cell take 0.136 ms at 67
// TFLOP/s beside them: the tensor cores bound it (chip_smoke.py reckons
// the bound from its run).  What holds it above that is the cell's ~60
// instructions (the hash's integer work most of them) on the SIMT pipes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bce_cell.cuh"
#include "tile_math.cuh"
#include "wgmma_tf32.cuh"

namespace dedicom {

using bce_cell::cell_u24;
using bce_cell::relation_key;
using tile_math::cell_loss;
using tile_math::mma3;
using tile_math::page_value;
using tile_math::sigmoid_neg;
using tile_math::softplus_neg;
using tile_math::split;
using wgmma_tf32::desc;
using wgmma_tf32::kmajor;
using wgmma_tf32::mma3_rs;

constexpr int B = 128;          // tile edge
constexpr int THREADS = 256;    // two warpgroups of 4 warps, 16 rows a warp
constexpr int WARPS = THREADS / 32;
constexpr int CW = 32;          // columns a warp computes at a time
constexpr int GS = B + 4;       // row stride of the G tile
constexpr int STAGES = 3;       // page stages in a warp's ring
constexpr int RC_MAX = 16;      // relations a block, at most

__host__ __device__ constexpr int zstride(int d) { return d + 4; }

__host__ __device__ constexpr int stage_row_bytes(int esize) {
  return (CW * esize + 15 + 15) & ~15;
}

__host__ __device__ inline int smem_bytes(int d, int esize, bool grads) {
  // words: with grads z_I^T hi and lo [D][B] and R hi and lo twice [D][D]
  // (wgmma's K-major operands), the G tile [B][GS], H's rows [B][D + 4]
  // and the dd partials of two relations [2][WARPS][D]; z_J hi and lo
  // [B][D + 4], R hi and lo [D][D + 4] (mma.sync's), the chunk's d_t
  // [RC_MAX][D], thresholds [RC_MAX][3] and keys [RC_MAX]; then each
  // warp's page ring
  return 4 * ((grads ? 2 * d * B + 4 * d * d + B * GS + B * zstride(d) +
                           2 * WARPS * d
                     : 0) +
              2 * B * zstride(d) + 2 * d * zstride(d) + RC_MAX * (d + 4)) +
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

// The k position, within its 8, that index c of an accumulator's 8
// columns takes as an A operand: column 2 t4 is position t4, 2 t4 + 1 is
// t4 + 4.  The K-major B operands of wgmma order their k so.
__host__ __device__ constexpr int kpos(int c) {
  return 8 * (c >> 3) + ((c & 1) << 2) + ((c & 7) >> 1);
}

// A [64, D] accumulator (features 8 f + 2 t4 (+1)) times d (by feature),
// as the A operand of a product over its features: k position t4 is
// feature 8 f + 2 t4, t4 + 4 is 8 f + 2 t4 + 1
template <int D>
__device__ __forceinline__ void scaled_a(const float (&acc)[D / 2],
                                         const float* d, int t4,
                                         uint32_t (&ah)[D / 8][4],
                                         uint32_t (&al)[D / 8][4]) {
#pragma unroll
  for (int f = 0; f < D / 8; ++f) {
    const float d0 = d[8 * f + 2 * t4], d1 = d[8 * f + 2 * t4 + 1];
    split(__fmul_rn(acc[4 * f + 0], d0), ah[f][0], al[f][0]);
    split(__fmul_rn(acc[4 * f + 2], d0), ah[f][1], al[f][1]);
    split(__fmul_rn(acc[4 * f + 1], d1), ah[f][2], al[f][2]);
    split(__fmul_rn(acc[4 * f + 3], d1), ah[f][3], al[f][3]);
  }
}

// u (=) (acc * d) B for a [D][D] K-major B (bh, bl): issued, not waited
template <int D>
__device__ __forceinline__ void issue_dd(float (&u)[D / 2],
                                         const float (&acc)[D / 2],
                                         const float* d, int t4,
                                         const uint32_t* bh,
                                         const uint32_t* bl) {
  uint32_t ah[D / 8][4], al[D / 8][4];
  scaled_a<D>(acc, d, t4, ah, al);
  wgmma_tf32::fence();
#pragma unroll
  for (int f = 0; f < D / 8; ++f)
    mma3_rs<D>(u, ah[f], al[f], desc(bh, 0, 8 * f, D), desc(bl, 0, 8 * f, D),
               f > 0);
  wgmma_tf32::commit();
}

// acc += d * u (both [64, D] accumulators, d by feature)
template <int D>
__device__ __forceinline__ void fold(float (&acc)[D / 2],
                                     const float (&u)[D / 2], const float* d,
                                     int t4) {
#pragma unroll
  for (int f = 0; f < D / 8; ++f) {
    const float d0 = d[8 * f + 2 * t4], d1 = d[8 * f + 2 * t4 + 1];
    acc[4 * f + 0] = fmaf(d0, u[4 * f + 0], acc[4 * f + 0]);
    acc[4 * f + 1] = fmaf(d1, u[4 * f + 1], acc[4 * f + 1]);
    acc[4 * f + 2] = fmaf(d0, u[4 * f + 2], acc[4 * f + 2]);
    acc[4 * f + 3] = fmaf(d1, u[4 * f + 3], acc[4 * f + 3]);
  }
}

// One k step (8 rows) of a [64, 8] A operand read from a float32 tile in
// shared memory, a[m][k] = src[row(k) * stride + m], split: row(k) of k
// position t4 is 2 t4, of t4 + 4 it is 2 t4 + 1 (kpos's order); rows m
// (live0) and m + 8 (live1) that are not live read as zeros.  src points
// at (row 8 kb, column m = 16 w' + g).
__device__ __forceinline__ void load_at(const float* src, int stride, int t4,
                                        bool live0, bool live1,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float* p = src + 2 * t4 * stride;
  split(live0 ? p[0] : 0.f, ah[0], al[0]);
  split(live1 ? p[8] : 0.f, ah[1], al[1]);
  split(live0 ? p[stride] : 0.f, ah[2], al[2]);
  split(live1 ? p[stride + 8] : 0.f, ah[3], al[3]);
}

// k steps of 8 rows a wgmma group in H' (2 and 8 measured slower)
constexpr int PK = 4;

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
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ float warp_loss[WARPS];
  // wgmma's K-major operands first (GRADS): z_I^T with k in kpos order
  // (the B of P and of H'), R with row a and k = kpos(b) (uI's B), R with
  // row b and k = kpos(a) (uJ's B)
  uint32_t* zih = smem;
  uint32_t* zil = zih + (GRADS ? D * B : 0);
  uint32_t* rih = zil + (GRADS ? D * B : 0);
  uint32_t* ril = rih + (GRADS ? D * D : 0);
  uint32_t* rjh = ril + (GRADS ? D * D : 0);
  uint32_t* rjl = rjh + (GRADS ? D * D : 0);
  float* Gt = (float*)(rjl + (GRADS ? D * D : 0));  // [B][GS]         (GRADS)
  float* hs = Gt + (GRADS ? B * GS : 0);            // [B][ZS] H       (GRADS)
  float* red = hs + (GRADS ? B * ZS : 0);           // [2][WARPS][D]   (GRADS)
  uint32_t* zjh = (uint32_t*)(red + (GRADS ? 2 * WARPS * D : 0));  // [B][ZS]
  uint32_t* zjl = zjh + B * ZS;
  uint32_t* rh = zjl + B * ZS;      // [D][ZS] R, TF32 high part
  uint32_t* rl = rh + D * ZS;       // [D][ZS] low part
  float* dts = (float*)(rl + D * ZS);             // [RC_MAX][D] d_t
  int32_t* qs = (int32_t*)(dts + RC_MAX * D);     // [RC_MAX][3]
  uint32_t* keys = (uint32_t*)(qs + 3 * RC_MAX);  // [RC_MAX]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  uint8_t* ring = (uint8_t*)(keys + RC_MAX) + warp * STAGES * SB;
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
    const float vj = col0 + r < n ? z[(size_t)(col0 + r) * D + k] : 0.f;
    split(vj, zjh[r * ZS + k], zjl[r * ZS + k]);
    if constexpr (GRADS) {
      const float vi = row0 + r < n ? z[(size_t)(row0 + r) * D + k] : 0.f;
      split(vi, zih[kmajor(k, kpos(r), B)], zil[kmajor(k, kpos(r), B)]);
    }
  }
  for (int idx = tid; idx < D * D; idx += THREADS) {
    const int a = idx / D, b = idx % D;  // R[a][b]
    uint32_t h, l;
    split(rmat[idx], h, l);
    rh[a * ZS + b] = h;
    rl[a * ZS + b] = l;
    if constexpr (GRADS) {
      rih[kmajor(a, kpos(b), D)] = h;
      ril[kmajor(a, kpos(b), D)] = l;
      rjh[kmajor(b, kpos(a), D)] = h;
      rjl[kmajor(b, kpos(a), D)] = l;
    }
  }
  for (int idx = tid; idx < (t1 - t0) * D; idx += THREADS)
    dts[idx] = dvec[(size_t)t0 * D + idx];
  for (int idx = tid; idx < (t1 - t0) * 3; idx += THREADS)
    qs[idx] = q[t0 * 3 + idx];
  for (int idx = tid; idx < t1 - t0; idx += THREADS)
    keys[idx] = relation_key(seed, (uint32_t)(t0 + idx));
  if constexpr (GRADS) {
    for (int idx = tid; idx < B * GS; idx += THREADS) Gt[idx] = 0.f;
  }
  wgmma_tf32::fence_smem();
  __syncthreads();

  // z_I in the A-fragment layout: rows m0+g, m0+g+8; features 8kk + t4,
  // 8kk + t4 + 4
  float za[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int r0 = row0 + m0 + g, r1 = r0 + 8;
    const int f0 = 8 * kk + t4;
    za[kk][0] = r0 < n ? z[(size_t)r0 * D + f0] : 0.f;
    za[kk][1] = r1 < n ? z[(size_t)r1 * D + f0] : 0.f;
    za[kk][2] = r0 < n ? z[(size_t)r0 * D + f0 + 4] : 0.f;
    za[kk][3] = r1 < n ? z[(size_t)r1 * D + f0 + 4] : 0.f;
  }

  float loss_acc = 0.f;
  float accI[D / 2], accJ[D / 2];
  float drt[D / 2];  // dR^T at (b = br (+8), a = 8f + 2t4 (+1))
#pragma unroll
  for (int i = 0; i < D / 2; ++i) accI[i] = accJ[i] = drt[i] = 0.f;
  const int br = 16 * (warp & 3) + g;

  int k = 0;
  for (int t = t0; t < t1; ++t) {
    const int tr = t - t0;
    if constexpr (GRADS) {
      __syncthreads();  // the last relation's G and H reads, dd partials
      if (t > t0 && tid < D) {
        const float* rp = red + ((t - 1) & 1) * WARPS * D;
        float s = 0.f;
        for (int kw = 0; kw < WARPS; ++kw) s += rp[kw * D + tid];
        dd_part[((size_t)tile * n_et + t - 1) * D + tid] = s;
      }
    }
    const uint32_t key = keys[tr];
    const int q0 = qs[3 * tr], q1 = qs[3 * tr + 1], q2 = qs[3 * tr + 2];
    const float* dt = dts + tr * D;
    // X_I = ((z_I * d_t) R) * d_t, then its A fragments (mma.sync)
    uint32_t ah[KK][4], al[KK][4];
    {
      uint32_t zh[KK][4], zl[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const float d0 = dt[8 * kk + t4], d1 = dt[8 * kk + t4 + 4];
        split(__fmul_rn(za[kk][0], d0), zh[kk][0], zl[kk][0]);
        split(__fmul_rn(za[kk][1], d0), zh[kk][1], zl[kk][1]);
        split(__fmul_rn(za[kk][2], d1), zh[kk][2], zl[kk][2]);
        split(__fmul_rn(za[kk][3], d1), zh[kk][3], zl[kk][3]);
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
        const float d0 = dt[8 * f + t4], d1 = dt[8 * f + t4 + 4];
        split(__fmul_rn(x[0], d0), ah[f][0], al[f][0]);
        split(__fmul_rn(x[2], d0), ah[f][1], al[f][1]);
        split(__fmul_rn(x[1], d1), ah[f][2], al[f][2]);
        split(__fmul_rn(x[3], d1), ah[f][3], al[f][3]);
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
      // H in wgmma's accumulator layout (mma.sync's C fragments side by
      // side) and in this warp's rows of hs; uI = (H * d_t) R^T (wgmma from
      // here on)
      float hacc[D / 2];
#pragma unroll
      for (int f = 0; f < KK; ++f)
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) hacc[4 * f + q4] = hI[f][q4];
#pragma unroll
      for (int f = 0; f < KK; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *(float2*)(hs + (m0 + g + 8 * h) * ZS + 8 * f + 2 * t4) =
              make_float2(hacc[4 * f + 2 * h], hacc[4 * f + 2 * h + 1]);
      float u[D / 2];
      issue_dd<D>(u, hacc, dt, t4, rih, ril);
      __syncthreads();  // the G tile and H's rows are complete
      // P^T = H^T z_I over this warpgroup's 64 rows (P = z_I^T H [D][D];
      // the product's rows b past D are zeros), each k step (8 rows) into
      // a fresh accumulator and the steps added in float32: the tensor
      // cores' own adds truncate, and P's sum over the rows can cancel
      float pt[D / 2], pa[2][D / 2];
      {
        uint32_t ah[2][4], al[2][4];
        const float* src = hs + 64 * wg * ZS + br;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) pt[i] = 0.f;
#pragma unroll
        for (int kb = 0; kb < 8 + 2; ++kb) {
          if (kb >= 2) {  // step kb - 2 is done
            if (kb < 9)
              wgmma_tf32::wait<1>();
            else
              wgmma_tf32::wait<0>();
            wgmma_tf32::fence_acc(pa[kb & 1]);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) pt[i] += pa[kb & 1][i];
          }
          if (kb < 8) {
            load_at(src + 8 * kb * ZS, ZS, t4, br < D, br + 8 < D, ah[kb & 1],
                    al[kb & 1]);
            wgmma_tf32::fence();
            mma3_rs<D>(pa[kb & 1], ah[kb & 1], al[kb & 1],
                       desc(zih, 0, 64 * wg + 8 * kb, B),
                       desc(zil, 0, 64 * wg + 8 * kb, B), 0);
            wgmma_tf32::commit();
          }
        }
      }
      // H' = G^T z_I for this warpgroup's 64 columns over the tile's 128
      // rows, PK k steps a group, A from the G tile in two register buffers
      float pacc[D / 2];
      {
        uint32_t fh[2][PK][4], fl[2][PK][4];
        const float* src = Gt + 64 * wg + br;
#pragma unroll
        for (int bt = 0; bt < B / 8 / PK; ++bt) {
          if (bt >= 2) wgmma_tf32::wait<1>();
#pragma unroll
          for (int qk = 0; qk < PK; ++qk)
            load_at(src + (8 * PK * bt + 8 * qk) * GS, GS, t4, true, true,
                    fh[bt & 1][qk], fl[bt & 1][qk]);
          wgmma_tf32::fence();
#pragma unroll
          for (int qk = 0; qk < PK; ++qk) {
            const int kb = PK * bt + qk;
            mma3_rs<D>(pacc, fh[bt & 1][qk], fl[bt & 1][qk],
                       desc(zih, 0, 8 * kb, B), desc(zil, 0, 8 * kb, B), kb > 0);
          }
          wgmma_tf32::commit();
        }
      }
      // pt[4f + 2h + e] = P[a][b], a = 8f + 2t4 + e, b = br + 8h:
      //   dR[a][b] += d_a d_b P[a][b]
      //   dd[a] += sum_b R[a][b] d_b P[a][b]   (the rows' share: uI's)
      //   dd[b] += sum_a R[a][b] d_a P[a][b]   (the columns': uJ's)
      float* dw = red + ((t & 1) * WARPS + warp) * D;
      if (16 * (warp & 3) < D) {
        float sa[D / 4], sb[2] = {0.f, 0.f};
#pragma unroll
        for (int f = 0; f < KK; ++f)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 8 * f + 2 * t4 + e;
            const float dA = dt[a];
            float sv = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int b = br + 8 * h;
              if (b < D) {
                const float pv = pt[4 * f + 2 * h + e];
                const float r = rmat[a * D + b];
                const float dB = dt[b];
                drt[4 * f + 2 * h + e] =
                    fmaf(__fmul_rn(dA, dB), pv, drt[4 * f + 2 * h + e]);
                sv = fmaf(__fmul_rn(r, dB), pv, sv);
                sb[h] = fmaf(__fmul_rn(r, dA), pv, sb[h]);
              }
            }
            sa[2 * f + e] = sv;
          }
#pragma unroll
        for (int i = 0; i < D / 4; ++i)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            sa[i] += __shfl_xor_sync(0xffffffffu, sa[i], off);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            sb[h] += __shfl_xor_sync(0xffffffffu, sb[h], off);
        if (g == 0) {
#pragma unroll
          for (int f = 0; f < KK; ++f) {
            dw[8 * f + 2 * t4] = sa[2 * f];
            dw[8 * f + 2 * t4 + 1] = sa[2 * f + 1];
          }
        }
        __syncwarp();
        if (t4 == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (br + 8 * h < D) dw[br + 8 * h] += sb[h];
        }
      } else if (lane < D) {
        dw[lane] = 0.f;
      }
      wgmma_tf32::wait<0>();
      wgmma_tf32::fence_acc(u);
      wgmma_tf32::fence_acc(pacc);
      // uJ = (H' * d_t) R, while uI folds in
      float uj[D / 2];
      issue_dd<D>(uj, pacc, dt, t4, rjh, rjl);
      fold<D>(accI, u, dt, t4);
      wgmma_tf32::wait<0>();
      wgmma_tf32::fence_acc(uj);
      fold<D>(accJ, uj, dt, t4);
    }
  }
  tile_math::cp_async_wait<0>();

  const size_t blk = (size_t)blockIdx.y * n_tiles + tile;
  if constexpr (GRADS) {
    __syncthreads();  // the last relation's dd partials; G's room is free
    if (tid < D) {
      const float* rp = red + ((t1 - 1) & 1) * WARPS * D;
      float s = 0.f;
      for (int kw = 0; kw < WARPS; ++kw) s += rp[kw * D + tid];
      dd_part[((size_t)tile * n_et + t1 - 1) * D + tid] = s;
    }
    float* outI = dz_part + (blk * 2 * B + m0) * D;
    float* outJ = dz_part + ((blk * 2 + 1) * B + warp * 16) * D;
#pragma unroll
    for (int f = 0; f < KK; ++f) {
      const int kf = 8 * f + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *(float2*)(outI + (g + 8 * h) * D + kf) =
            make_float2(accI[4 * f + 2 * h], accI[4 * f + 2 * h + 1]);
        *(float2*)(outJ + (g + 8 * h) * D + kf) =
            make_float2(accJ[4 * f + 2 * h], accJ[4 * f + 2 * h + 1]);
      }
    }
    // dR: warpgroup 1's share through G's room, added to warpgroup 0's
    float* sr = Gt;  // [D][D], row b
    if (wg == 1) {
#pragma unroll
      for (int f = 0; f < KK; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (br + 8 * h < D)
            *(float2*)(sr + (br + 8 * h) * D + 8 * f + 2 * t4) =
                make_float2(drt[4 * f + 2 * h], drt[4 * f + 2 * h + 1]);
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int f = 0; f < KK; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = br + 8 * h, a = 8 * f + 2 * t4 + e;
            if (b < D)
              dr_part[blk * D * D + a * D + b] =
                  drt[4 * f + 2 * h + e] + sr[b * D + a];
          }
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

// The tile kernel's launch for an [n_et, n, n] problem at width d (8, 16
// or 32): out = {grid x, grid y, threads, dynamic shared memory bytes}.
extern "C" int tip_dense_bce_dedicom_config(int n, int n_et, int d, int rc,
                                            int grads, int* out) {
  using namespace dedicom;
  if (d != 8 && d != 16 && d != 32) return (int)cudaErrorInvalidValue;
  const int nb = (n + B - 1) / B;
  out[0] = nb * nb;
  out[1] = (n_et + rc - 1) / rc;
  out[2] = THREADS;
  out[3] = smem_bytes(d, 1, grads != 0);
  return 0;
}

// Plain C entry point (bound with ctypes by ops/dense_bce_dedicom.py).
// dvec [n_et][d], rmat [d][d], z [n][d] float32; pages [n_et][n][n] uint8,
// 16-byte aligned; q [n_et][3] int32; d 8, 16 or 32; rc <= 16.  Scratch sizes, in floats: loss_part nb^2 n_chunks;
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
  if ((uintptr_t)pages % 16 != 0 || rc < 1 || rc > RC_MAX)
    return (int)cudaErrorInvalidValue;
  return dispatch_d<uint8_t>(d, grads, dvec, rmat, z, pages, q, seed, n_et, n,
                             rc, loss_part, dd_part, dz_part, dr_part, loss,
                             dd, dz, dr, s);
}
