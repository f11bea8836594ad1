// Fused dense BCE over the full relation pages for Hopper (sm_90a):
// positives + Poissonized negatives of the DistMult decoder, with the
// gradients (dw, dz) from the same pass.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_dense_bce.py
// (dense_bce_sum: _fwd_kernel / _fwd_manual_kernel and _bwd_kernel, whose
// per-page math is _common).  Per relation t, per cell (i = dst row, j = src
// column) of the [n, n] page DA[t]:
//   L    = (z_i * w_t) . z_j                       (DistMult logit)
//   cnt  = #{k < 3 : u24 < q[t, k]}, zeroed where DA > 0
//   loss = sum softplus(-L) * DA + (softplus(-L) + L) * cnt
//   G    = cnt - sigmoid(-L) * (DA + cnt)
//   dw_t = sum_i z_i * (G z)_i;  dz += w_t * (G z + G^T z)
// The TPU kernel draws u24 from its on-chip PRNG, reseeded per relation;
// here u24 is the counter hash of (seed, t, i, j) over the [n, n] plane --
// cell_u24 of bce_cell.cuh, the field B3 draws -- and ops/dense_bce.py
// computes the same field in PyTorch, so the kernel and its plain version
// see identical counts.  Self-pairs (i = j) are cells like any other, as in
// the TPU kernel.  The pages are the unpadded counts in float32 or bf16 (the
// two page dtypes the JAX package gives its kernel), read as float.
//
// Design (that of dense_bce_sym.cu, B1, over the whole plane).  One block
// (8 warps) owns one 128 x 128 tile (I, J) of the page plane for a chunk of
// RC relations; z_I and z_J stay in shared memory across the chunk (only
// w_t changes), split into TF32 high and low parts.  Warp w owns rows
// 16w..16w+15 of the tile.  Every (I, J) tile of the plane is visited, not
// only the upper triangle: the pages need not be symmetric, so there is no
// mirror weight, and one rate class of three thresholds.
//  * The three contractions run on the tensor cores as 3xTF32 mma.sync
//    m16n8k8 (tile_math.cuh).  L comes 32 columns at a time into
//    accumulator fragments; the cell math turns them into G in the same
//    registers, which are at once the A operand of G z_J.  G also goes to a
//    shared [128][132] tile, from which each warp reads the transposed
//    fragments of G^T z_I for 16 columns (free of bank conflicts).
//  * One exponential a cell (tile_math.cuh: softplus_neg, sigmoid_neg).
//  * Warps skip the rows and the 32-column groups of the tile past n: at n =
//    645 the 36 tiles evaluate 441 K cells a relation, not 768^2 = 590 K.
//  * The page stream is asynchronous and per warp.  A float32 128 x 128
//    page tile (64 KB) does not fit twice beside the z and G tiles (142 KB
//    at d = 32), so each warp streams its own 16 rows of the 32-column group
//    it computes next: a ring of STAGES stages of [16][RS] bytes (2.3 KB
//    float32, 1.3 KB bf16) that runs STAGES - 1 groups ahead, across
//    relations, by cp.async.  The pages are unpadded (row stride n), so a
//    row segment starts at any byte: it is copied as the whole 16-byte
//    chunks that cover it (tile_math.cuh: stage_span_chunk), and read back
//    at its shift into the first chunk.  A warp waits only for its own copies
//    (cp.async.wait_group, __syncwarp); block barriers remain only around
//    the G tile, with gradients.
// Every block writes its loss, dw and dz partials to scratch, and small
// second passes sum them in a fixed order: the result is deterministic, and
// the value-only and fused launches give the same loss bit for bit (the
// logits come from the same tensor-core sequence, and the loss arithmetic
// uses explicit round-to-nearest intrinsics).  One fused launch a training
// step.
//
// Bound on an H100 at Decagon shape (R = 1,097, n = 645, d = 16: 456 M
// cells): the float32 page read takes 0.545 ms at 3.35 TB/s (bf16 pages
// 0.273 ms); the three d-long dots are 6 d flops a cell, 18 d as 3xTF32,
// 131 GFLOP, 0.266 ms at 495 TFLOP/s; ~20 elementwise float operations a
// cell take 0.136 ms at 67 TFLOP/s beside them.  So the bytes bound it
// (chip_smoke.py reckons the bound from its run); the cell's integer hash
// (~20 operations) is not counted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bce_cell.cuh"
#include "tile_math.cuh"

namespace {

using bce_cell::cell_u24;  // cell = row * n + col of relation t's plane
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
constexpr int CW = 32;          // columns a warp computes at a time (4 n-tiles)
constexpr int GS = B + 4;       // row stride of the G tile (== 4 mod 16)
constexpr int STAGES = 3;       // page stages in a warp's ring

// row stride of the z tiles: D + 4 spreads the fragment reads over banks
__host__ __device__ constexpr int zstride(int d) { return d + 4; }

// bytes of a staged row: CW page values after a shift of up to 15 bytes,
// in whole 16-byte chunks
__host__ __device__ constexpr int stage_row_bytes(int esize) {
  return (CW * esize + 15 + 15) & ~15;
}

__host__ __device__ inline int smem_bytes(int d, int esize, bool grads) {
  // zI hi, zI lo, zJ hi, zJ lo [B][D + 4] words; with grads the G tile
  // [B][GS] and the dw partials [WARPS][D]; each warp's page ring
  return 4 * (4 * B * zstride(d) + (grads ? B * GS + WARPS * d : 0)) +
         WARPS * STAGES * 16 * stage_row_bytes(esize);
}

// Start copying a warp's page stage: rows row0 + m0 .. + 15 (those below n)
// of relation t, columns c0 .. c0 + CW - 1 (those below n), row r at
// st + r * RS from its 16-byte chunk on.  One cp.async group.
template <typename P>
__device__ __forceinline__ void fetch_stage(const P* pages, const uint8_t* end,
                                            int t, int n, int r0, int c0,
                                            uint8_t* st, int lane) {
  constexpr int ESZ = sizeof(P);
  constexpr int RS = stage_row_bytes(ESZ);
  constexpr int CH = RS / 16;  // chunks a row may need
  const int nbytes = min(CW, n - c0) * ESZ;
  const int rows = min(16, n - r0);
  for (int idx = lane; idx < 16 * CH; idx += 32) {  // lanes over rows x chunks
    const int r = idx / CH;
    if (r >= rows) break;
    tile_math::stage_span_chunk(
        st + r * RS, (const uint8_t*)(pages + ((size_t)t * n + r0 + r) * n + c0),
        nbytes, end, idx % CH);
  }
  tile_math::cp_async_commit();
}

// grid: (nb * nb tiles, ceil(n_et / rc) relation chunks); tile = I * nb + J.
// Writes loss_part[blk]; with GRADS also dw_part[tile][t] and the tile's dz
// row and column partials dz_part[blk][side][r], blk = chunk * nb^2 + tile.
template <typename P, int D, bool GRADS>
__global__ void __launch_bounds__(THREADS, 1)
tile_kernel(const float* __restrict__ w, const float* __restrict__ z,
            const P* __restrict__ pages, const int32_t* __restrict__ q,
            uint32_t seed, int n_et, int n, int nb, int rc,
            float* __restrict__ loss_part, float* __restrict__ dw_part,
            float* __restrict__ dz_part) {
  constexpr int ZS = zstride(D);
  constexpr int KK = D / 8;  // k-steps of the logit, n-tiles of the gradients
  constexpr int ESZ = sizeof(P);
  constexpr int RS = stage_row_bytes(ESZ);
  constexpr int SB = 16 * RS;  // bytes of one stage
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float warp_loss[WARPS];
  uint32_t* zih = smem;            // [B][ZS] z_I, TF32 high part
  uint32_t* zil = zih + B * ZS;    // [B][ZS] z_I, low part
  uint32_t* zjh = zil + B * ZS;    // [B][ZS] z_J
  uint32_t* zjl = zjh + B * ZS;
  float* Gt = (float*)(zjl + B * ZS);             // [B][GS]      (GRADS)
  float* red = Gt + (GRADS ? B * GS : 0);         // [WARPS][D]   (GRADS)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  uint8_t* ring = (uint8_t*)(red + (GRADS ? WARPS * D : 0)) +
                  warp * STAGES * SB;  // this warp's [STAGES][16][RS]
  const uint8_t* end = (const uint8_t*)(pages + (size_t)n_et * n * n);
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int row0 = (tile / nb) * B, col0 = (tile % nb) * B;
  const int t0 = blockIdx.y * rc;
  const int t1 = min(t0 + rc, n_et);

  const int m0 = warp * 16;  // this warp's first row of the tile
  const bool rows_live = row0 + m0 < n;
  const int ncw = (min(B, n - col0) + CW - 1) / CW;  // live column groups
  // the warp's stages: k = (t - t0) * ncw + cw
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
  if constexpr (GRADS) {  // skipped rows and columns keep G = 0
    for (int idx = tid; idx < B * GS; idx += THREADS) Gt[idx] = 0.f;
  }
  __syncthreads();  // the z tiles

  // z_I in the logit's A-fragment layout: rows m0+g, m0+g+8; features
  // 8kk + t4, 8kk + t4 + 4
  float za[KK][4];
  // z_I in the accumulator layout (for dw): rows m0+g, m0+g+8; features
  // 8f + 2t4, 8f + 2t4 + 1
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

  float loss_acc = 0.f;
  float accI[KK][4], accJ[KK][4];  // dz of rows m0+g(+8) and columns 16w+g(+8)
#pragma unroll
  for (int f = 0; f < KK; ++f)
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) accI[f][q4] = accJ[f][q4] = 0.f;

  int k = 0;  // this warp's next stage
  for (int t = t0; t < t1; ++t) {
    if constexpr (GRADS) __syncthreads();  // the last relation's G reads
    const uint32_t key = relation_key(seed, (uint32_t)t);
    const int q0 = q[t * 3], q1 = q[t * 3 + 1], q2 = q[t * 3 + 2];
    float wv[KK][2];  // w_t at features 8f + 2t4, 8f + 2t4 + 1
    uint32_t ah[KK][4], al[KK][4];  // (z_I * w_t) as A fragments
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const float wa = w[(size_t)t * D + 8 * kk + t4];
      const float wb = w[(size_t)t * D + 8 * kk + t4 + 4];
      split(__fmul_rn(za[kk][0], wa), ah[kk][0], al[kk][0]);
      split(__fmul_rn(za[kk][1], wa), ah[kk][1], al[kk][1]);
      split(__fmul_rn(za[kk][2], wb), ah[kk][2], al[kk][2]);
      split(__fmul_rn(za[kk][3], wb), ah[kk][3], al[kk][3]);
      wv[kk][0] = w[(size_t)t * D + 8 * kk + 2 * t4];
      wv[kk][1] = w[(size_t)t * D + 8 * kk + 2 * t4 + 1];
    }
    float hI[KK][4];  // (G z_J) rows m0+g(+8), features 8f + 2t4 (+1)
#pragma unroll
    for (int f = 0; f < KK; ++f)
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) hI[f][q4] = 0.f;

    for (int cw = 0; rows_live && cw < ncw; ++cw, ++k) {
      tile_math::cp_async_wait<STAGES - 2>();
      __syncwarp();  // stage k is in; every lane is done with stage k - 1
      const int kn = k + STAGES - 1;
      if (kn < n_stages)
        fetch_stage(pages, end, t0 + kn / ncw, n, row0 + m0,
                    col0 + (kn % ncw) * CW, ring + (kn % STAGES) * SB, lane);
      else
        tile_math::cp_async_commit();
      const int c0 = cw * CW;
      // rows m0+g and m0+g+8 of the stage, at their shifts
      const uint8_t* st = ring + (k % STAGES) * SB;
      const uint8_t* prow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = g + 8 * h;
        const size_t e = ((size_t)t * n + row0 + m0 + rl) * n + col0 + c0;
        prow[h] = st + rl * RS + (int)((e * ESZ) & 15);
      }
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt) {
        const int cb = c0 + nt * 8;  // this n-tile's first column
        float L[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const int o = (cb + g) * ZS + 8 * kk + t4;
          mma3(L, ah[kk], al[kk], zjh[o], zjh[o + 4], zjl[o], zjl[o + 4]);
        }
        // cells (m0+g, cb+2t4), (m0+g, +1), (m0+g+8, cb+2t4), (m0+g+8, +1)
        float Gv[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int q4 = 2 * h + e2;
            const int c = nt * 8 + 2 * t4 + e2;  // column in the stage
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
          // G z_J over these 8 columns: A fragment k = t4 <-> column
          // cb + 2t4, k = t4 + 4 <-> column cb + 2t4 + 1
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
      // dz rows I and this warp's share of dw_t
#pragma unroll
      for (int f = 0; f < KK; ++f) {
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4)
          accI[f][q4] = fmaf(wv[f][q4 & 1], hI[f][q4], accI[f][q4]);
        float s0 = fmaf(zc[f][0], hI[f][0], zc[f][2] * hI[f][2]);
        float s1 = fmaf(zc[f][1], hI[f][1], zc[f][3] * hI[f][3]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (g == 0) {
          red[warp * D + 8 * f + 2 * t4] = s0;
          red[warp * D + 8 * f + 2 * t4 + 1] = s1;
        }
      }
      __syncthreads();  // the G tile and the dw partials are complete
      // G^T z_I for columns j0..j0+15: A[m = column][k = row], k = t4 <->
      // row kb + 2t4, k = t4 + 4 <-> row kb + 2t4 + 1
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
        for (int f = 0; f < KK; ++f)
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4)
            accJ[f][q4] = fmaf(wv[f][q4 & 1], hJ[f][q4], accJ[f][q4]);
      }
      if (tid < D) {
        float s = 0.f;
        for (int kw = 0; kw < WARPS; ++kw) s += red[kw * D + tid];
        dw_part[((size_t)tile * n_et + t) * D + tid] = s;
      }
    }
  }
  tile_math::cp_async_wait<0>();  // no copy outlives the block

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
  }
  // fixed-order block reduction of the loss
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

// Sum of the per-block loss partials in a fixed order.
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

// dw[t, k] = sum over tiles of the per-tile partials, in tile order.
__global__ void reduce_dw(const float* __restrict__ part, int n_tiles, int n_et,
                          int d, float* __restrict__ dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_et * d) return;
  float s = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) s += part[(size_t)tile * n_et * d + idx];
  dw[idx] = s;
}

// dz[row, k]: rows of block b collect the row part of tiles (b, J) and the
// column part of tiles (I, b), for every J and I, over every relation chunk.
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
cudaError_t launch(const float* w, const float* z, const P* pages,
                   const int32_t* q, uint32_t seed, int n_et, int n, int rc,
                   float* loss_part, float* dw_part, float* dz_part,
                   float* loss, float* dw, float* dz, cudaStream_t stream) {
  const int nb = (n + B - 1) / B;
  const int n_tiles = nb * nb;
  const int n_chunks = (n_et + rc - 1) / rc;
  const int smem = smem_bytes(D, (int)sizeof(P), GRADS);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<P, D, GRADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  tile_kernel<P, D, GRADS><<<dim3(n_tiles, n_chunks), THREADS, smem, stream>>>(
      w, z, pages, q, seed, n_et, n, nb, rc, loss_part, dw_part, dz_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_loss<<<1, THREADS, 0, stream>>>(loss_part, n_tiles * n_chunks, loss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (GRADS) {
    reduce_dw<<<(n_et * D + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        dw_part, n_tiles, n_et, D, dw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    reduce_dz<<<(n * D + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        dz_part, n_chunks, nb, n, D, dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename P, int D>
cudaError_t dispatch(int grads, const float* w, const float* z,
                     const void* pages, const int32_t* q, uint32_t seed,
                     int n_et, int n, int rc, float* loss_part, float* dw_part,
                     float* dz_part, float* loss, float* dw, float* dz,
                     cudaStream_t stream) {
  const P* p = static_cast<const P*>(pages);
  if (grads)
    return launch<P, D, true>(w, z, p, q, seed, n_et, n, rc, loss_part,
                              dw_part, dz_part, loss, dw, dz, stream);
  return launch<P, D, false>(w, z, p, q, seed, n_et, n, rc, loss_part,
                             dw_part, dz_part, loss, dw, dz, stream);
}

template <typename P>
cudaError_t dispatch_d(int d, int grads, const float* w, const float* z,
                       const void* pages, const int32_t* q, uint32_t seed,
                       int n_et, int n, int rc, float* loss_part,
                       float* dw_part, float* dz_part, float* loss, float* dw,
                       float* dz, cudaStream_t stream) {
  switch (d) {
    case 8:
      return dispatch<P, 8>(grads, w, z, pages, q, seed, n_et, n, rc,
                            loss_part, dw_part, dz_part, loss, dw, dz, stream);
    case 16:
      return dispatch<P, 16>(grads, w, z, pages, q, seed, n_et, n, rc,
                             loss_part, dw_part, dz_part, loss, dw, dz, stream);
    case 32:
      return dispatch<P, 32>(grads, w, z, pages, q, seed, n_et, n, rc,
                             loss_part, dw_part, dz_part, loss, dw, dz, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/dense_bce.py).  w [n_et][d],
// z [n][d] float32; pages [n_et][n][n] float32 (page_bf16 0) or bf16
// (page_bf16 1), 16-byte aligned (its rows are staged from the 16-byte
// chunks that cover them); q [n_et][3] int32.  Scratch sizes, in floats:
// loss_part nb^2 * n_chunks; dw_part nb^2 * n_et * d; dz_part n_chunks *
// nb^2 * 2 * 128 * d, where nb = ceil(n / 128) and n_chunks = ceil(n_et /
// rc).  With grads 0 the dw/dz pointers are not touched.  Returns the first
// CUDA error.
extern "C" int tip_dense_bce(const float* w, const float* z, const void* pages,
                             int page_bf16, const int32_t* q, unsigned int seed,
                             int n_et, int n, int d, int rc, int grads,
                             float* loss_part, float* dw_part, float* dz_part,
                             float* loss, float* dw, float* dz, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)pages % 16 != 0) return (int)cudaErrorInvalidValue;
  if (page_bf16)
    return dispatch_d<__nv_bfloat16>(d, grads, w, z, pages, q, seed, n_et, n,
                                     rc, loss_part, dw_part, dz_part, loss, dw,
                                     dz, s);
  return dispatch_d<float>(d, grads, w, z, pages, q, seed, n_et, n, rc,
                           loss_part, dw_part, dz_part, loss, dw, dz, s);
}
