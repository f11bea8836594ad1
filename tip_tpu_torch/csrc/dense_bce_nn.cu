// Fused dense BCE of the NN decoder for Hopper (sm_90a): positives +
// Poissonized negatives over the full relation pages, with the gradients
// (dw1, dw2, dh1, dh2) from the same pass.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_dense_bce_nn.py
// (dense_bce_nn_sum: _fwd_kernel, _bwd_kernel).  Per relation t, per cell
// (i = dst row, j = src column) of the [n, n] page:
//   L    = s2_t[i] + s1_t[j],  s1_t[j] = h1[j] . w1[t],  s2_t[i] = h2[i] . w2[t]
//   cnt  = #{k < 3 : u24 < q[t, k]}, zeroed where the page count da > 0
//   loss = sum softplus(-L) * da + (softplus(-L) + L) * cnt
//   G    = cnt - sigmoid(-L) * (da + cnt)
// The TPU kernel's backward spends four MXU dots per page on G.  Here they
// reduce to the row sums r_t = G 1 and column sums c_t = G^T 1:
//   dw2[t] = r_t . h2,  dh2 = sum_t r_t (x) w2[t],
//   dw1[t] = c_t . h1,  dh1 = sum_t c_t (x) w1[t],
// so the O(R n^2) work is elementwise plus two reductions, and the
// O(R n 16) contractions run after it (contract.cuh).  u24 is the counter
// hash of (seed, t, i, j) -- cell_u24 of bce_cell.cuh, the same function as
// ops/dense_bce_sym.py:u24_field over the [n, n] plane -- so the kernel and
// its plain version (ops/dense_bce_nn.py) see identical counts.
//
// Design.  One block (8 warps) owns relation t and a tile of ROWS = 128 page
// rows; warp w owns rows 16w..16w+15 of the tile and covers each of them
// whole, a strip of SW = 32 KC columns at a time (KC = 21: one strip for
// n <= 672), lane l taking columns l, l + 32, ...: only the last 32
// columns of a strip leave lanes idle (27 of 672 at n = 645).
//  * The page rows come in by cp.async, two rows ahead of the row a warp
//    computes, into a ring of STAGES row buffers per warp.  The pages are
//    unpadded (row stride n), so a row starts at any byte: it is copied as
//    the whole 16-byte chunks that cover it (tile_math.cuh: stage_span) and
//    read back at its shift into the first chunk, neighbouring lanes on
//    neighbouring page values (no bank conflicts).
//  * One exponential a cell (tile_math.cuh: softplus_neg, sigmoid_neg).
//  * s1_t of the strip's columns is computed once a block into shared
//    memory and kept in registers, KC values a lane; s2_t of the tile's
//    rows in shared memory.
//  * Row sums: a lane adds G over its columns of the row in a register, and
//    the warp reduces it once a row (and strip); column sums: a lane keeps
//    its KC columns' sums over the warp's 16 rows in registers, and the 8
//    warps' sums are added in warp order through shared memory and written
//    as the tile's partial (then summed over tiles in order).
// The loss is per-lane serial, then a fixed-order block and grid reduction.
// Everything is deterministic, and the value-only and fused launches give
// the same loss bit for bit (the loss arithmetic uses explicit
// round-to-nearest intrinsics).  One fused launch a training step.
//
// Bound on an H100 at Decagon shape (R = 1,097, n = 645: 456 M cells): the
// uint8 page read takes 0.136 ms at 3.35 TB/s; the ~25 float operations a
// cell (the outer sum, softplus, sigmoid, the counts, G and the two
// running sums; 3 of them transcendental) take ~0.17 ms at 67 TFLOP/s, so
// operations bound it, besides the hash's integer work.  chip_smoke.py
// reckons the bound from its run.
//
// Pages come in the dtype the graph ships them in, as the TPU kernel reads
// the pages of whatever dtype preferred_dense_dtype picked: uint8 beside
// DR-NN's strips (every count there is at most 127), bf16 (counts up to
// 256) or float32 (any count) as the full-page layout.  One template on the
// page type reads a cell as float, with the same arithmetic after the read,
// so the three give one result bit for bit; the uint8 read takes 0.136 ms
// of the bound above, bf16 0.272 ms, float32 0.545 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bce_cell.cuh"
#include "contract.cuh"
#include "tile_math.cuh"

namespace {

using bce_cell::cell_u24;  // cell = row * n + col of relation t's plane
using bce_cell::relation_key;
using tile_math::cell_loss;
using tile_math::page_value;
using tile_math::sigmoid_neg;
using tile_math::softplus_neg;

constexpr int D = 16;                // the hidden width l1
constexpr int THREADS = 256;         // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 128;            // page rows per block
constexpr int RW = ROWS / WARPS;     // rows per warp
constexpr int KC = 21;               // columns per lane in a strip
constexpr int SW = 32 * KC;          // columns per strip
constexpr int STAGES = 3;            // row buffers in a warp's ring
constexpr unsigned FULL = 0xffffffffu;

// bytes of a staged strip row: SW page values after a shift of up to 15
// bytes, in whole 16-byte chunks
__host__ __device__ constexpr int stage_bytes(int esize) {
  return (SW * esize + 15 + 15) & ~15;
}

__device__ __forceinline__ float dot16(const float* __restrict__ a,
                                       const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) s = fmaf(a[k], b[k], s);
  return s;
}

// Start copying the warp's stage k (strip k / rows, row k % rows of the
// warp, from row r0) of relation t into its ring.  One cp.async group.
template <typename P>
__device__ __forceinline__ void fetch_row(const P* pages, const uint8_t* end,
                                          int t, int n, int r0, int rows, int k,
                                          uint8_t* ring, int lane) {
  constexpr int SB = stage_bytes(sizeof(P));
  const int j0 = (k / rows) * SW;
  const P* src = pages + ((size_t)t * n + r0 + k % rows) * n + j0;
  tile_math::stage_span(ring + (k % STAGES) * SB, (const uint8_t*)src,
                        min(SW, n - j0) * (int)sizeof(P), end, lane, 32);
  tile_math::cp_async_commit();
}

// grid: n_et * n_tiles blocks, block b = (t = b / n_tiles, tile = b %
// n_tiles).  Writes loss_part[b]; with GRADS also col_part[t][tile][j] and
// the row sums rows[t][i] of the tile's rows.
template <typename P, bool GRADS>
__global__ void __launch_bounds__(THREADS, 2)
page_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
            const float* __restrict__ h1, const float* __restrict__ h2,
            const P* __restrict__ pages, const int32_t* __restrict__ q,
            uint32_t seed, int n, int n_et, int n_tiles,
            float* __restrict__ loss_part, float* __restrict__ col_part,
            float* __restrict__ rows) {
  constexpr int SB = stage_bytes(sizeof(P));
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s2[ROWS];
  __shared__ float s1[SW];
  __shared__ float rowacc[ROWS];
  __shared__ float warp_loss[WARPS];
  float* colred = (float*)smem;  // [WARPS][SW]   (GRADS)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint8_t* ring = smem + (GRADS ? WARPS * SW * 4 : 0) + warp * STAGES * SB;
  const uint8_t* end = (const uint8_t*)(pages + (size_t)n_et * n * n);
  const int t = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int row0 = tile * ROWS, nrows = min(ROWS, n - row0);
  const int r0 = row0 + warp * RW;                // the warp's first row
  const int wrows = max(0, min(RW, n - r0));      // its rows below n
  const int n_strips = (n + SW - 1) / SW;
  const int n_stages = n_strips * wrows;          // k = strip * wrows + row
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages)
      fetch_row(pages, end, t, n, r0, wrows, s, ring, lane);
    else
      tile_math::cp_async_commit();
  }

  float wv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) wv[k] = w2[(size_t)t * D + k];
  if (tid < nrows) s2[tid] = dot16(h2 + (size_t)(row0 + tid) * D, wv);
  if (GRADS && tid < ROWS) rowacc[tid] = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) wv[k] = w1[(size_t)t * D + k];
  const int q0 = q[t * 3], q1 = q[t * 3 + 1], q2 = q[t * 3 + 2];
  const uint32_t key = relation_key(seed, (uint32_t)t);

  float loss_acc = 0.f;
  int k = 0;  // the warp's next stage
  for (int strip = 0; strip < n_strips; ++strip) {
    const int j0 = strip * SW;
    const int ncol = min(SW, n - j0);
    __syncthreads();  // s2 and rowacc; the last strip's s1 and colred reads
    for (int c = tid; c < ncol; c += THREADS)
      s1[c] = dot16(h1 + (size_t)(j0 + c) * D, wv);
    __syncthreads();
    float s1r[KC], cacc[KC];  // the lane's columns j0 + lane + 32 kc
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      s1r[kc] = lane + 32 * kc < ncol ? s1[lane + 32 * kc] : 0.f;
      cacc[kc] = 0.f;
    }
    for (int r = 0; r < wrows; ++r, ++k) {
      tile_math::cp_async_wait<STAGES - 2>();
      __syncwarp();  // row k is in; every lane is done with row k - 1
      if (k + STAGES - 1 < n_stages)
        fetch_row(pages, end, t, n, r0, wrows, k + STAGES - 1, ring, lane);
      else
        tile_math::cp_async_commit();
      const int gi = r0 + r;
      const P* src = pages + ((size_t)t * n + gi) * n + j0;
      const uint8_t* prow =
          ring + (k % STAGES) * SB + tile_math::span_shift(src);
      const float a = s2[warp * RW + r];
      const uint32_t cell0 = (uint32_t)gi * (uint32_t)n + (uint32_t)j0;
      float rsum = 0.f;
      // every lane computes all KC cells, those past the strip with a
      // count and a page value of 0 (whose terms are +0 exactly): no branch
      // splits the unrolled cells, so their chains interleave
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int c = lane + 32 * kc;
        const bool live = c < ncol;
        const float L = __fadd_rn(a, s1r[kc]);
        const float pv = page_value((const P*)(prow + c * (int)sizeof(P)));
        const float da = live ? pv : 0.f;
        const int u = cell_u24(key, cell0 + (uint32_t)c);
        float cnt = (float)((u < q0) + (u < q1) + (u < q2));
        if (da > 0.f || !live) cnt = 0.f;
        float e;
        const float sp = softplus_neg(L, e);
        loss_acc = __fadd_rn(loss_acc, cell_loss(sp, L, da, cnt));
        if constexpr (GRADS) {
          const float G = cnt - sigmoid_neg(L, e) * (da + cnt);
          rsum += G;
          cacc[kc] += G;
        }
      }
      if constexpr (GRADS) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          rsum += __shfl_xor_sync(FULL, rsum, off);
        if (lane == 0) rowacc[warp * RW + r] += rsum;
      }
    }
    if constexpr (GRADS) {
      float* mine = colred + warp * SW;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) mine[lane + 32 * kc] = cacc[kc];
      __syncthreads();
      float* out = col_part + ((size_t)t * n_tiles + tile) * n + j0;
      for (int c = tid; c < ncol; c += THREADS) {
        float s = 0.f;
        for (int kw = 0; kw < WARPS; ++kw) s += colred[kw * SW + c];
        out[c] = s;
      }
    }
  }
  tile_math::cp_async_wait<0>();  // no copy outlives the block

  if constexpr (GRADS) {
    __syncthreads();
    if (tid < nrows) rows[(size_t)t * n + row0 + tid] = rowacc[tid];
  }
  // fixed-order block reduction of the loss
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    loss_acc = __fadd_rn(loss_acc, __shfl_down_sync(FULL, loss_acc, off));
  if (lane == 0) warp_loss[warp] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int kw = 0; kw < WARPS; ++kw) s = __fadd_rn(s, warp_loss[kw]);
    loss_part[blockIdx.x] = s;
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

// cols[t][j] = sum over tiles of col_part[t][tile][j], in tile order.
__global__ void sum_tiles(const float* __restrict__ col_part, int n_et,
                          int n_tiles, int n, float* __restrict__ cols) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_et * n) return;
  const size_t t = idx / n, j = idx % n;
  const float* p = col_part + t * n_tiles * n + j;
  float s = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) s += p[(size_t)tile * n];
  cols[idx] = s;
}

template <typename P, bool GRADS>
cudaError_t launch_pages(int blocks, const float* w1, const float* w2,
                         const float* h1, const float* h2, const void* pages,
                         const int32_t* q, uint32_t seed, int n, int n_et,
                         int n_tiles, float* loss_part, float* col_part,
                         float* rows, cudaStream_t s) {
  const int smem =
      (GRADS ? WARPS * SW * 4 : 0) + WARPS * STAGES * stage_bytes(sizeof(P));
  cudaError_t err = cudaFuncSetAttribute(
      page_kernel<P, GRADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  page_kernel<P, GRADS><<<blocks, THREADS, smem, s>>>(
      w1, w2, h1, h2, static_cast<const P*>(pages), q, seed, n, n_et, n_tiles,
      loss_part, col_part, rows);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_kind(int grads, int blocks, const float* w1,
                        const float* w2, const float* h1, const float* h2,
                        const void* pages, const int32_t* q, uint32_t seed,
                        int n, int n_et, int n_tiles, float* loss_part,
                        float* col_part, float* rows, cudaStream_t s) {
  if (grads)
    return launch_pages<P, true>(blocks, w1, w2, h1, h2, pages, q, seed, n,
                                 n_et, n_tiles, loss_part, col_part, rows, s);
  return launch_pages<P, false>(blocks, w1, w2, h1, h2, pages, q, seed, n,
                                n_et, n_tiles, loss_part, col_part, rows, s);
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/dense_bce_nn.py).  w1, w2
// [n_et][16], h1, h2 [n][16] float32; pages [n_et][n][n] of page_kind 0
// (uint8), 1 (bf16) or 2 (float32), 16-byte aligned (its rows are staged
// from the 16-byte chunks that cover them); q [n_et][3] int32.  Scratch:
// loss_part [n_et * n_tiles], and with grads col_part [n_et][n_tiles][n],
// rows and cols [n_et][n], where n_tiles = ceil(n / 128), and the
// contractions' slab partials slab_part [2][slabs][n][16] (slabs =
// ceil(n_et / contract::SLAB)).  Outputs: loss
// [1]; with grads dw1, dw2 [n_et][16], dh1, dh2 [n][16] (not touched
// without).  Returns the first CUDA error (cudaErrorInvalidValue for an
// unknown page_kind or unaligned pages).
extern "C" int tip_dense_bce_nn(const float* w1, const float* w2,
                                const float* h1, const float* h2,
                                const void* pages, int page_kind,
                                const int32_t* q, unsigned int seed, int n_et,
                                int n, int grads, float* loss_part,
                                float* col_part, float* rows, float* cols,
                                int slabs, float* slab_part,
                                float* loss, float* dw1, float* dw2,
                                float* dh1, float* dh2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)pages % 16 != 0) return cudaErrorInvalidValue;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int blocks = n_et * n_tiles;
  cudaError_t err;
  if (page_kind == 0)
    err = launch_kind<uint8_t>(grads, blocks, w1, w2, h1, h2, pages, q, seed,
                               n, n_et, n_tiles, loss_part, col_part, rows, s);
  else if (page_kind == 1)
    err = launch_kind<__nv_bfloat16>(grads, blocks, w1, w2, h1, h2, pages, q,
                                     seed, n, n_et, n_tiles, loss_part,
                                     col_part, rows, s);
  else if (page_kind == 2)
    err = launch_kind<float>(grads, blocks, w1, w2, h1, h2, pages, q, seed, n,
                             n_et, n_tiles, loss_part, col_part, rows, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  reduce_loss<<<1, THREADS, 0, s>>>(loss_part, blocks, loss);
  if ((err = cudaGetLastError()) != cudaSuccess || !grads) return err;
  const size_t cells = (size_t)n_et * n;
  sum_tiles<<<(unsigned)((cells + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      col_part, n_et, n_tiles, n, cols);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // r_t feeds dw2 and dh2, c_t feeds dw1 and dh1
  return contract::run({rows, n, h2, w2, dw2, dh2}, {cols, n, h1, w1, dw1, dh1},
                       {nullptr, nullptr}, n_et, n, slabs, slab_part, s);
}
