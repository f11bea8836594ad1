// Fused symmetric dense BCE for Hopper (sm_90a): positives + Poissonized
// negatives over the upper-triangle strip-packed adjacency, with the
// gradients (dw, dz) from the same pass.
//
// Replaces the Pallas TPU kernel tip_tpu/ops/pallas_dense_bce_sym.py
// (dense_bce_sym_sum; bodies _page_math, _manual_kernel, _auto_kernel).
// The arithmetic is _page_math's, cell for cell:
//   L    = (z_I * w_t) . z_J                       (DistMult logit)
//   cnt  = #{k : u24 < q8[t, k]}  (k in 0..3 on the diagonal block, 4..7
//          on the tail), zeroed where da > 0 or the cell lies past n
//   daw  = da * (1 on the diagonal block, 2 on the tail)
//   loss = sum softplus(-L) * daw + (softplus(-L) + L) * cnt
//   G    = cnt - sigmoid(-L) * (daw + cnt)
//   dw_t += sum_r z_I[r] * (G z_J)[r];  dz[I] += w_t * (G z_J);
//   dz[J] += w_t * (G^T z_I)
// The TPU kernel draws u24 from the on-chip PRNG in strip order.  Here u24
// is a counter-based hash of (seed, t, row, col) -- cell_u24 of
// bce_cell.cuh, shared with B2 and B3 -- and ops/dense_bce_sym.py computes
// the same field in PyTorch, so the kernel and its plain version see
// identical counts.
//
// Design.  One block (8 warps) owns one 128 x 128 tile (I, J) of the strip
// layout for a chunk of RC relations; z_I and z_J stay in shared memory
// across the chunk (only w_t changes), split into TF32 high and low parts.
// Warp w owns rows 16w..16w+15 of the tile.
//  * The three contractions run on the tensor cores, mma.sync m16n8k8 TF32,
//    each float32 product as three TF32 products (hi*hi + hi*lo + lo*hi,
//    "3xTF32": float32-level error, where one TF32 product would keep ~3
//    digits).  L comes 32 columns at a time into accumulator fragments; the
//    cell math turns them into G in the same registers, which are at once
//    the A operand of G z_J (the contraction index permuted to the
//    fragment's column order, so G never goes through shared memory for
//    it).  G is also stored to a shared [128][132] tile, from which each
//    warp reads the transposed fragments of G^T z_I for 16 columns (the
//    row stride makes those reads free of bank conflicts).
//  * One exponential per cell: e = exp(-|L|) gives softplus(-L) =
//    max(-L, 0) + log(1 + e) and sigmoid(-L) = (L >= 0 ? e : 1) / (1 + e).
//    Fast intrinsics: ex2.approx and lg2.approx (a few 1e-7 absolute in
//    softplus), __fdividef in the sigmoid (gradients only).  These helpers
//    and the 3xTF32 ones are tile_math.cuh's, shared with B2 and B3.
//  * The page stream is asynchronous: the next relation's 16 KB int8 page
//    tile is copied into shared memory by cp.async while the current one
//    computes (double buffer).
//  * Warps skip the rows and 32-column groups of the tile that lie past n.
// Every block writes its loss, dw and dz partials to scratch, and small
// second passes sum them in a fixed order: the result is deterministic, and
// the value-only and fused launches give the same loss bit for bit (the
// logits come from the same tensor-core sequence, and the loss arithmetic
// uses explicit round-to-nearest intrinsics, so the compiler contracts
// nothing differently between the two instantiations).
//
// Bound on an H100 at Decagon shape (R = 1097, n = 645, d = 16; ~273 M
// cells inside n x n): the 377 MB page read takes 0.11 ms at 3.35 TB/s;
// the three d-long dots are 6 d flops a cell, 18 d as 3xTF32, ~79 GFLOP,
// 0.16 ms at 495 TFLOP/s (dense TF32); the ~20 elementwise float operations
// a cell (softplus, counts, G) take 0.08 ms at 67 TFLOP/s beside them (the
// units overlap).  So the tensor-core operations bound it, at ~0.16 ms
// (chip_smoke.py reckons the bound from its run).  The cell's integer hash
// (~20 operations) is not counted.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bce_cell.cuh"
#include "tile_math.cuh"

namespace {

using bce_cell::cell_u24;  // cell = row * npad + col of the padded plane
using bce_cell::relation_key;
using tile_math::cell_loss;
using tile_math::cp_async16;
using tile_math::mma3;
using tile_math::sigmoid_neg;
using tile_math::softplus_neg;
using tile_math::split;

constexpr int B = 128;          // block edge of the strip layout
constexpr int THREADS = 256;    // 8 warps, 16 rows each
constexpr int WARPS = THREADS / 32;
constexpr int CW = 32;          // columns a warp computes at a time (4 n-tiles)
constexpr int GS = B + 4;       // row stride of the G tile (== 4 mod 16)
constexpr int PS = B + 16;      // row stride of a page tile, in bytes

// row stride of the z tiles: D + 4 spreads the fragment reads over banks
__host__ __device__ constexpr int zstride(int d) { return d + 4; }

__host__ __device__ inline int smem_bytes(int d, bool grads) {
  // zI hi, zI lo, zJ hi, zJ lo [B][D + 4] words; two page tiles [B][PS]
  // bytes; with grads the G tile [B][GS] and the dw partials [WARPS][D]
  return 4 * (4 * B * zstride(d) + (grads ? B * GS + WARPS * d : 0)) +
         2 * B * PS;
}

// Start copying relation t's 128 x 128 page tile into pg [B][PS].
__device__ __forceinline__ void fetch_page(const int8_t* pages, int t,
                                           int tile, int totcols, int8_t* pg) {
  const int8_t* src = pages + ((size_t)t * B) * totcols + (size_t)tile * B;
  for (int i = threadIdx.x; i < B * (B / 16); i += THREADS) {
    const int r = i / (B / 16), c = (i % (B / 16)) * 16;
    cp_async16(pg + r * PS + c, src + (size_t)r * totcols + c);
  }
  tile_math::cp_async_commit();
}

template <int D, bool GRADS>
__global__ void __launch_bounds__(THREADS, 1)
tile_kernel(const float* __restrict__ w, const float* __restrict__ z,
            const int8_t* __restrict__ pages, const int32_t* __restrict__ q8,
            uint32_t seed, int n_et, int n, int nb, int totcols, int rc,
            float* __restrict__ loss_part, float* __restrict__ dw_part,
            float* __restrict__ dz_part) {
  constexpr int ZS = zstride(D);
  constexpr int KK = D / 8;  // k-steps of the logit, n-tiles of the gradients
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float warp_loss[WARPS];
  uint32_t* zih = smem;            // [B][ZS] z_I, TF32 high part
  uint32_t* zil = zih + B * ZS;    // [B][ZS] z_I, low part
  uint32_t* zjh = zil + B * ZS;    // [B][ZS] z_J
  uint32_t* zjl = zjh + B * ZS;
  float* Gt = (float*)(zjl + B * ZS);             // [B][GS]      (GRADS)
  float* red = Gt + (GRADS ? B * GS : 0);         // [WARPS][D]   (GRADS)
  int8_t* pg = (int8_t*)(red + (GRADS ? WARPS * D : 0));  // [2][B][PS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // blockIdx.x is the tile's column-block index in the packed layout,
  // which enumerates the upper block triangle row by row
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  int i = 0, rem = tile;
  while (rem >= nb - i) {
    rem -= nb - i;
    ++i;
  }
  const int j = i + rem;
  const int row0 = i * B, col0 = j * B;
  const uint32_t npad = (uint32_t)nb * B;
  const bool diag = i == j;
  const int qoff = diag ? 0 : 4;
  const float posw = diag ? 1.f : 2.f;
  const int t0 = blockIdx.y * rc;
  const int t1 = min(t0 + rc, n_et);

  fetch_page(pages, t0, tile, totcols, pg);
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

  const int m0 = warp * 16;  // this warp's first row of the tile
  const bool rows_live = row0 + m0 < n;
  const int ncw = (min(B, n - col0) + CW - 1) / CW;  // live column groups
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
    for (int q = 0; q < 4; ++q) accI[f][q] = accJ[f][q] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    tile_math::cp_async_wait<0>();
    __syncthreads();  // page t, the z tiles, and the last relation's G reads
    if (t + 1 < t1) fetch_page(pages, t + 1, tile, totcols, pg + (buf ^ 1) * B * PS);
    const int8_t* page = pg + buf * B * PS;

    const uint32_t key = relation_key(seed, (uint32_t)t);
    const int q0 = q8[t * 8 + qoff], q1 = q8[t * 8 + qoff + 1];
    const int q2 = q8[t * 8 + qoff + 2], q3 = q8[t * 8 + qoff + 3];
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
      for (int q = 0; q < 4; ++q) hI[f][q] = 0.f;

    for (int cw = 0; rows_live && cw < ncw; ++cw) {
      const int c0 = cw * CW;
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
          const int rl = m0 + g + 8 * h;
          const char2 da2 = *(const char2*)(page + rl * PS + cb + 2 * t4);
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int q = 2 * h + e2;
            const int gr = row0 + rl, gc = col0 + cb + 2 * t4 + e2;
            const float da = (float)(e2 ? da2.y : da2.x);
            const int u = cell_u24(key, (uint32_t)gr * npad + (uint32_t)gc);
            float cnt = (float)((u < q0) + (u < q1) + (u < q2) + (u < q3));
            if (da > 0.f || gr >= n || gc >= n) cnt = 0.f;
            const float x = L[q];
            const float daw = __fmul_rn(posw, da);
            float e;
            const float sp = softplus_neg(x, e);
            loss_acc = __fadd_rn(loss_acc, cell_loss(sp, x, daw, cnt));
            if constexpr (GRADS) Gv[q] = cnt - sigmoid_neg(x, e) * (daw + cnt);
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
        for (int q = 0; q < 4; ++q) accI[f][q] = fmaf(wv[f][q & 1], hI[f][q], accI[f][q]);
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
          for (int q = 0; q < 4; ++q) hJ[f][q] = 0.f;
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
          for (int q = 0; q < 4; ++q)
            accJ[f][q] = fmaf(wv[f][q & 1], hJ[f][q], accJ[f][q]);
      }
      if (tid < D) {
        float s = 0.f;
        for (int k = 0; k < WARPS; ++k) s += red[k * D + tid];
        dw_part[((size_t)tile * n_et + t) * D + tid] = s;
      }
    }
  }

  const size_t blk = (size_t)blockIdx.y * n_tiles + tile;
  if constexpr (GRADS) {
    float* outI = dz_part + (blk * 2 * B + m0) * D;
    float* outJ = dz_part + ((blk * 2 + 1) * B + warp * 16) * D;
#pragma unroll
    for (int f = 0; f < KK; ++f) {
      const int k = 8 * f + 2 * t4;
      *(float2*)(outI + g * D + k) = make_float2(accI[f][0], accI[f][1]);
      *(float2*)(outI + (g + 8) * D + k) = make_float2(accI[f][2], accI[f][3]);
      *(float2*)(outJ + g * D + k) = make_float2(accJ[f][0], accJ[f][1]);
      *(float2*)(outJ + (g + 8) * D + k) = make_float2(accJ[f][2], accJ[f][3]);
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
    for (int k = 0; k < WARPS; ++k) s = __fadd_rn(s, warp_loss[k]);
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

// dw[t, k] = sum over tiles of the per-tile partials.
__global__ void reduce_dw(const float* __restrict__ part, int n_tiles, int n_et,
                          int d, float* __restrict__ dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_et * d) return;
  float s = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) s += part[(size_t)tile * n_et * d + idx];
  dw[idx] = s;
}

// dz[row, k]: rows of block b collect the row part of tiles (b, j >= b) and
// the column part of tiles (i <= b, b), over every relation chunk.
__global__ void reduce_dz(const float* __restrict__ part, int n_chunks, int nb,
                          int n, int d, float* __restrict__ dz) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * d) return;
  const int row = idx / d, k = idx % d;
  const int b = row / B, rr = row % B;
  const int n_tiles = nb * (nb + 1) / 2;
  float s = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    for (int jj = b; jj < nb; ++jj) {
      const int tile = b * nb - b * (b - 1) / 2 + (jj - b);
      s += part[((((size_t)ch * n_tiles + tile) * 2 + 0) * B + rr) * d + k];
    }
    for (int ii = 0; ii <= b; ++ii) {
      const int tile = ii * nb - ii * (ii - 1) / 2 + (b - ii);
      s += part[((((size_t)ch * n_tiles + tile) * 2 + 1) * B + rr) * d + k];
    }
  }
  dz[idx] = s;
}

template <int D, bool GRADS>
cudaError_t launch(const float* w, const float* z, const int8_t* pages,
                   const int32_t* q8, uint32_t seed, int n_et, int n, int nb,
                   int totcols, int rc, float* loss_part, float* dw_part,
                   float* dz_part, float* loss, float* dw, float* dz,
                   cudaStream_t stream) {
  const int n_tiles = nb * (nb + 1) / 2;
  const int n_chunks = (n_et + rc - 1) / rc;
  const int smem = smem_bytes(D, GRADS);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<D, GRADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tile_kernel<D, GRADS><<<dim3(n_tiles, n_chunks), THREADS, smem, stream>>>(
      w, z, pages, q8, seed, n_et, n, nb, totcols, rc, loss_part, dw_part,
      dz_part);
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

template <int D>
cudaError_t dispatch(int grads, const float* w, const float* z,
                     const int8_t* pages, const int32_t* q8, uint32_t seed,
                     int n_et, int n, int nb, int totcols, int rc,
                     float* loss_part, float* dw_part, float* dz_part,
                     float* loss, float* dw, float* dz, cudaStream_t stream) {
  if (grads)
    return launch<D, true>(w, z, pages, q8, seed, n_et, n, nb, totcols, rc,
                           loss_part, dw_part, dz_part, loss, dw, dz, stream);
  return launch<D, false>(w, z, pages, q8, seed, n_et, n, nb, totcols, rc,
                          loss_part, dw_part, dz_part, loss, dw, dz, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// The wide instance (32 < d <= 232; CompGCN's d = 200, models/compgcn.py).
//
// At d = 200 a 128 x 128 tile's z_I and z_J, split into TF32 parts, would
// take 418 KB of shared memory, and the tile kernel's 3xTF32 logits and
// gradients 1.3 TFLOP a step, for cells that mostly add nothing: a cell
// with no positive (da = 0) and no negative drawn (cnt = 0) has G = 0 and
// adds exactly 0 to the loss, and at Decagon shape about 1.5 cells in a
// hundred are active (the positives, about n_train / 2, and the cells that
// draw a negative, about n_train).  So the wide instance draws every cell's
// count as the tile kernel does (the same u24 = f(seed, t, row, col) and
// thresholds: the same estimator) and computes the logit and G of the
// active cells alone, in float32 FMAs over z's columns, no TF32:
//  * A block owns a 64 x 64 subtile of one strip tile (I, J) for a chunk
//    of relations: z_I and z_J (float32, [64][d]) and the column side of dz
//    stay in shared memory; each relation's 64 x 64 int8 page subtile comes
//    through registers into a double buffer (row pitch 68 bytes, so the
//    column-wise reads of the second sweep are free of bank conflicts).
//    16 warps, so that the SM holds enough of the cells' dependent chains
//    (logit, butterfly, softplus) to issue every cycle.
//  * Sweep 1: warp w owns rows 4w..4w+3; a lane draws one cell's count, a
//    ballot gives the row's active cells, and for each the warp computes
//    the logit (lane j sums columns j, j + 32, ..., then a butterfly) and
//    the loss and G in every lane; G z_J[c] adds into the row's h, which
//    leaves into the row side of dz (w_t * h, registers) and dw (z_I * h);
//    each active cell's (row, column, G) is appended to the warp's list.
//  * Sweep 2: warp w owns columns 4w..4w+3 and walks the 16 lists in
//    order, adding w_t * G z_I[r] into its columns of the column side.
//  * dw_t's warp partials are added in warp order; the block's loss, dw and
//    dz partials go to scratch and reduce_loss, reduce_dw and
//    wide_reduce_dz sum them in a fixed order: deterministic, no atomics.
// The loss and dw of a cell are taken once (sweep 1), as the tile kernel
// takes them; the diagonal tiles' cells (r, c) and (c, r) are two cells.
// The sums differ from the tile kernel's only in float32 order: every
// logit is a float32 dot product where the tile kernel's 3xTF32 keeps
// about float32's accuracy.
//
// Bound on an H100 at Decagon shape (d = 200): the strips, 377 MB, take
// 0.11 ms; ~12.7 M active cells at 7 d float32 operations each take 0.26
// ms at 67 TFLOP/s; every cell's count is ~20 integer operations more.
// ---------------------------------------------------------------------------
namespace b1w {

using bce_cell::cell_u24;
using bce_cell::relation_key;
using tile_math::cell_loss;
using tile_math::sigmoid_neg;
using tile_math::softplus_neg;

constexpr int B = 128;            // block edge of the strip layout
constexpr int H = 64;             // subtile edge
constexpr int WARPS = 16;        // 4 rows or columns each: more warps hide
constexpr int THREADS = 32 * WARPS;  // the dependent chains of a cell
constexpr int RW = H / WARPS;     // rows (sweep 1) or columns (sweep 2) a warp
constexpr int PW = H + 4;         // bytes a staged page row (17 words)
constexpr int LCAP = RW * H;      // a warp's list holds every cell of its rows

__host__ __device__ inline int smem_bytes(int d) {
  // z_I, z_J, the column side of dz [H][d] floats; dw partials [WARPS][d];
  // the lists' G [WARPS][LCAP] floats and (row, column) [WARPS][LCAP]
  // uint16; their counts; two page subtiles [H][PW] bytes
  return 4 * (3 * H * d + WARPS * d + WARPS * LCAP + WARPS) +
         2 * WARPS * LCAP + 2 * H * PW;
}

// The page subtile's 16 bytes thread tid < 256 carries: row tid / 4,
// bytes 16 (tid % 4) on.
constexpr int PAGE_THREADS = H * H / 16;

__device__ __forceinline__ int4 load_page(const int8_t* pages, int t,
                                          size_t sub_off, int totcols) {
  const int row = threadIdx.x >> 2, c = (threadIdx.x & 3) * 16;
  if (threadIdx.x >= PAGE_THREADS) return make_int4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const int4*>(
      pages + ((size_t)t * B + row) * totcols + sub_off + c));
}

__device__ __forceinline__ void store_page(int8_t* pg, int4 v) {
  const int row = threadIdx.x >> 2, c = (threadIdx.x & 3) * 16;
  if (threadIdx.x >= PAGE_THREADS) return;
  int* dst = reinterpret_cast<int*>(pg + row * PW + c);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

template <int KL, bool GRADS>
__global__ void __launch_bounds__(THREADS, 1)
wide_kernel(const float* __restrict__ w, const float* __restrict__ z,
            const int8_t* __restrict__ pages, const int32_t* __restrict__ q8,
            uint32_t seed, int n_et, int n, int d, int nb, int totcols,
            int rc, float* __restrict__ loss_part,
            float* __restrict__ dw_part, float* __restrict__ dz_part) {
  extern __shared__ __align__(16) float wsm[];
  float* zI = wsm;                      // [H][d]
  float* zJ = zI + H * d;               // [H][d]
  float* accJ = zJ + H * d;             // [H][d]
  float* red = accJ + H * d;            // [WARPS][d]
  float* lg = red + WARPS * d;          // [WARPS][LCAP]
  int* lcnt = reinterpret_cast<int*>(lg + WARPS * LCAP);           // [WARPS]
  uint16_t* lidx = reinterpret_cast<uint16_t*>(lcnt + WARPS);      // [WARPS][LCAP]
  int8_t* pg = reinterpret_cast<int8_t*>(lidx + WARPS * LCAP);     // [2][H][PW]
  __shared__ float warp_loss[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = blockIdx.x, tile = sub >> 2;
  const int sa = (sub >> 1) & 1, sb = sub & 1;
  int i = 0, rem = tile;
  while (rem >= nb - i) {
    rem -= nb - i;
    ++i;
  }
  const int j = i + rem;
  const int r0 = i * B + sa * H, c0 = j * B + sb * H;
  const uint32_t npad = (uint32_t)nb * B;
  const bool diag = i == j;
  const int qoff = diag ? 0 : 4;
  const float posw = diag ? 1.f : 2.f;
  const int t0 = blockIdx.y * rc;
  const int t1 = min(t0 + rc, n_et);
  const size_t blk = (size_t)blockIdx.y * gridDim.x + sub;
  const bool live = r0 < n && c0 < n;
  const size_t sub_off =
      ((size_t)i * nb - (size_t)i * (i - 1) / 2 + (j - i)) * B +
      (size_t)sa * H * totcols + (size_t)sb * H;

  for (int idx = tid; idx < H * d; idx += THREADS) {
    const int rr = idx / d, k = idx - rr * d;
    zI[idx] = r0 + rr < n ? z[(size_t)(r0 + rr) * d + k] : 0.f;
    zJ[idx] = c0 + rr < n ? z[(size_t)(c0 + rr) * d + k] : 0.f;
    accJ[idx] = 0.f;
  }

  float accI[RW][KL];  // the row side of dz: rows RW warp + rr, columns lane + 32 jj
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
#pragma unroll
    for (int jj = 0; jj < KL; ++jj) accI[rr][jj] = 0.f;
  float loss_acc = 0.f;

  int4 nxt = make_int4(0, 0, 0, 0);
  if (live && t0 < t1) nxt = load_page(pages, t0, sub_off, totcols);
  for (int t = t0; live && t < t1; ++t) {
    int8_t* page = pg + ((t - t0) & 1) * H * PW;
    store_page(page, nxt);
    if (t + 1 < t1) nxt = load_page(pages, t + 1, sub_off, totcols);
    __syncthreads();  // page t; the last relation's lists and dw partials read

    const uint32_t key = relation_key(seed, (uint32_t)t);
    const int q0 = q8[t * 8 + qoff], q1 = q8[t * 8 + qoff + 1];
    const int q2 = q8[t * 8 + qoff + 2], q3 = q8[t * 8 + qoff + 3];
    float wv[KL], dwa[KL];
#pragma unroll
    for (int jj = 0; jj < KL; ++jj) {
      const int k = lane + 32 * jj;
      wv[jj] = k < d ? w[(size_t)t * d + k] : 0.f;
      dwa[jj] = 0.f;
    }
    int count = 0;  // this warp's list, the same in every lane

#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int lr = warp * RW + rr;
      const int gr = r0 + lr;
      if (gr >= n) continue;  // the same in every lane
      float zw[KL], h[KL];
#pragma unroll
      for (int jj = 0; jj < KL; ++jj) {
        const int k = lane + 32 * jj;
        zw[jj] = k < d ? __fmul_rn(zI[lr * d + k], wv[jj]) : 0.f;
        h[jj] = 0.f;
      }
      for (int cg = 0; cg < H / 32; ++cg) {
        const int lc = cg * 32 + lane, gc = c0 + lc;
        const int da = page[lr * PW + lc];
        const int u = cell_u24(key, (uint32_t)gr * npad + (uint32_t)gc);
        int cnt = (u < q0) + (u < q1) + (u < q2) + (u < q3);
        if (da > 0 || gc >= n) cnt = 0;
        unsigned mask = __ballot_sync(0xffffffffu, gc < n && (da > 0 || cnt > 0));
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const int cda = __shfl_sync(0xffffffffu, da, src);
          const float ccnt = (float)__shfl_sync(0xffffffffu, cnt, src);
          const int cc = cg * 32 + src;
          float zj[KL];
          float x = 0.f;
#pragma unroll
          for (int jj = 0; jj < KL; ++jj) {
            const int k = lane + 32 * jj;
            zj[jj] = k < d ? zJ[cc * d + k] : 0.f;
            x = fmaf(zw[jj], zj[jj], x);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
          const float daw = __fmul_rn(posw, (float)cda);
          float e;
          const float sp = softplus_neg(x, e);
          loss_acc = __fadd_rn(loss_acc, cell_loss(sp, x, daw, ccnt));
          if constexpr (GRADS) {
            const float gv = ccnt - sigmoid_neg(x, e) * (daw + ccnt);
#pragma unroll
            for (int jj = 0; jj < KL; ++jj) h[jj] = fmaf(gv, zj[jj], h[jj]);
            if (lane == 0) {
              lg[warp * LCAP + count] = gv;
              lidx[warp * LCAP + count] = (uint16_t)((lr << 6) | cc);
            }
            ++count;
          }
        }
      }
      if constexpr (GRADS) {
#pragma unroll
        for (int jj = 0; jj < KL; ++jj) {
          const int k = lane + 32 * jj;
          accI[rr][jj] = fmaf(wv[jj], h[jj], accI[rr][jj]);
          dwa[jj] = fmaf(k < d ? zI[lr * d + k] : 0.f, h[jj], dwa[jj]);
        }
      }
    }
    if constexpr (!GRADS) continue;
#pragma unroll
    for (int jj = 0; jj < KL; ++jj) {
      const int k = lane + 32 * jj;
      if (k < d) red[warp * d + k] = dwa[jj];
    }
    if (lane == 0) lcnt[warp] = count;
    __syncthreads();  // the lists and the dw partials are complete
    for (int k = tid; k < d; k += THREADS) {
      float s = 0.f;
      for (int ww = 0; ww < WARPS; ++ww) s += red[ww * d + k];
      dw_part[((size_t)sub * n_et + t) * d + k] = s;
    }
    // sweep 2: this warp's columns, from the warps' lists in order
    for (int src_w = 0; src_w < WARPS; ++src_w) {
      const int cnt_w = lcnt[src_w];
      for (int base = 0; base < cnt_w; base += 32) {
        const int e = base + lane;
        const int ix = e < cnt_w ? lidx[src_w * LCAP + e] : 0;
        unsigned mask = __ballot_sync(0xffffffffu,
                                      e < cnt_w && (ix & 63) / RW == warp);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const int cix = __shfl_sync(0xffffffffu, ix, src);
          const float gv = lg[src_w * LCAP + base + src];
          const int lr = cix >> 6, lc = cix & 63;
#pragma unroll
          for (int jj = 0; jj < KL; ++jj) {
            const int k = lane + 32 * jj;
            if (k < d)
              accJ[lc * d + k] =
                  fmaf(__fmul_rn(gv, wv[jj]), zI[lr * d + k], accJ[lc * d + k]);
          }
        }
      }
    }
  }
  if (!live) {  // a subtile past n: zero partials
    for (int t = t0; GRADS && t < t1; ++t)
      for (int k = tid; k < d; k += THREADS)
        dw_part[((size_t)sub * n_et + t) * d + k] = 0.f;
  }
  __syncthreads();  // the column side is complete

  if constexpr (GRADS) {
    float* outI = dz_part + (blk * 2 * H) * d;
    float* outJ = dz_part + ((blk * 2 + 1) * H) * d;
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
#pragma unroll
      for (int jj = 0; jj < KL; ++jj) {
        const int k = lane + 32 * jj;
        if (k < d) outI[(warp * RW + rr) * d + k] = accI[rr][jj];
      }
    for (int idx = tid; idx < H * d; idx += THREADS) outJ[idx] = accJ[idx];
  }
  if (lane == 0) warp_loss[warp] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < WARPS; ++k) s = __fadd_rn(s, warp_loss[k]);
    loss_part[blk] = s;
  }
}

__device__ __forceinline__ int tile_of(int i, int j, int nb) {
  return i * nb - i * (i - 1) / 2 + (j - i);
}

// dz[v, k]: v's rows of the subtiles (I, J >= I) and its columns of the
// subtiles (I' <= I, I), over every relation chunk, in that order.
__global__ void wide_reduce_dz(const float* __restrict__ part, int n_chunks,
                               int nb, int n, int d, float* __restrict__ dz) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * d) return;
  const int v = idx / d, k = idx % d;
  const int bi = v / B, half = (v % B) / H, rr = v % H;
  const int n_sub = 4 * (nb * (nb + 1) / 2);
  float s = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t base = (size_t)ch * n_sub;
    for (int jj = bi; jj < nb; ++jj)
      for (int sb = 0; sb < 2; ++sb) {
        const size_t blk = base + 4 * tile_of(bi, jj, nb) + 2 * half + sb;
        s += part[((blk * 2) * H + rr) * d + k];
      }
    for (int ii = 0; ii <= bi; ++ii)
      for (int sa = 0; sa < 2; ++sa) {
        const size_t blk = base + 4 * tile_of(ii, bi, nb) + 2 * sa + half;
        s += part[((blk * 2 + 1) * H + rr) * d + k];
      }
  }
  dz[idx] = s;
}

template <int KL, bool GRADS>
cudaError_t launch(const float* w, const float* z, const int8_t* pages,
                   const int32_t* q8, uint32_t seed, int n_et, int n, int d,
                   int nb, int totcols, int rc, float* loss_part,
                   float* dw_part, float* dz_part, float* loss, float* dw,
                   float* dz, cudaStream_t stream) {
  const int n_sub = 4 * (nb * (nb + 1) / 2);
  const int n_chunks = (n_et + rc - 1) / rc;
  const int smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      wide_kernel<KL, GRADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  wide_kernel<KL, GRADS><<<dim3(n_sub, n_chunks), THREADS, smem, stream>>>(
      w, z, pages, q8, seed, n_et, n, d, nb, totcols, rc, loss_part, dw_part,
      dz_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_loss<<<1, 256, 0, stream>>>(loss_part, n_sub * n_chunks, loss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (GRADS) {
    reduce_dw<<<(n_et * d + 255) / 256, 256, 0, stream>>>(dw_part, n_sub,
                                                          n_et, d, dw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    wide_reduce_dz<<<(n * d + 255) / 256, 256, 0, stream>>>(
        dz_part, n_chunks, nb, n, d, dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int KL>
cudaError_t dispatch(int grads, const float* w, const float* z,
                     const int8_t* pages, const int32_t* q8, uint32_t seed,
                     int n_et, int n, int d, int nb, int totcols, int rc,
                     float* loss_part, float* dw_part, float* dz_part,
                     float* loss, float* dw, float* dz, cudaStream_t stream) {
  if (grads)
    return launch<KL, true>(w, z, pages, q8, seed, n_et, n, d, nb, totcols,
                            rc, loss_part, dw_part, dz_part, loss, dw, dz,
                            stream);
  return launch<KL, false>(w, z, pages, q8, seed, n_et, n, d, nb, totcols, rc,
                           loss_part, dw_part, dz_part, loss, dw, dz, stream);
}

}  // namespace b1w

// Plain C entry point (bound with ctypes by ops/dense_bce_sym.py).
// Scratch sizes, in floats: loss_part n_tiles * n_chunks; dw_part
// n_tiles * n_et * d; dz_part n_chunks * n_tiles * 2 * 128 * d, where
// n_tiles = nb (nb + 1) / 2 and n_chunks = ceil(n_et / rc).  pages and
// totcols 16-byte aligned (the page tiles are copied 16 bytes at a time).
// With grads 0 the dw/dz pointers are not touched.  Returns the first CUDA
// error.
extern "C" int tip_dense_bce_sym(const float* w, const float* z,
                                 const int8_t* pages, const int32_t* q8,
                                 unsigned int seed, int n_et, int n, int d,
                                 int nb, int totcols, int rc, int grads,
                                 float* loss_part, float* dw_part,
                                 float* dz_part, float* loss, float* dw,
                                 float* dz, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (((uintptr_t)pages | (uintptr_t)totcols) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 8:
      return dispatch<8>(grads, w, z, pages, q8, seed, n_et, n, nb, totcols,
                         rc, loss_part, dw_part, dz_part, loss, dw, dz, s);
    case 16:
      return dispatch<16>(grads, w, z, pages, q8, seed, n_et, n, nb, totcols,
                          rc, loss_part, dw_part, dz_part, loss, dw, dz, s);
    case 32:
      return dispatch<32>(grads, w, z, pages, q8, seed, n_et, n, nb, totcols,
                          rc, loss_part, dw_part, dz_part, loss, dw, dz, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The wide instance's entry (32 < d <= 232), the same arguments as
// tip_dense_bce_sym.  Scratch sizes, in floats: loss_part n_sub * n_chunks;
// dw_part n_sub * n_et * d; dz_part n_chunks * n_sub * 2 * 64 * d, where
// n_sub = 4 nb (nb + 1) / 2 (each strip tile's four 64 x 64 subtiles) and
// n_chunks = ceil(n_et / rc).
extern "C" int tip_dense_bce_sym_wide(const float* w, const float* z,
                                      const int8_t* pages, const int32_t* q8,
                                      unsigned int seed, int n_et, int n,
                                      int d, int nb, int totcols, int rc,
                                      int grads, float* loss_part,
                                      float* dw_part, float* dz_part,
                                      float* loss, float* dw, float* dz,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (((uintptr_t)pages | (uintptr_t)totcols) % 16 != 0 || d <= 32 ||
      d > 232 || rc < 1)
    return (int)cudaErrorInvalidValue;
  switch ((d + 31) / 32) {
#define B1W_CASE(KL)                                                        \
  case KL:                                                                  \
    return b1w::dispatch<KL>(grads, w, z, pages, q8, seed, n_et, n, d, nb,  \
                             totcols, rc, loss_part, dw_part, dz_part, loss, \
                             dw, dz, s);
    B1W_CASE(2)
    B1W_CASE(3)
    B1W_CASE(4)
    B1W_CASE(5)
    B1W_CASE(6)
    B1W_CASE(7)
    B1W_CASE(8)
#undef B1W_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
