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
// Design.  One block owns relation t and a tile of ROWS page rows: it
// computes s2_t for its rows into shared memory, and each thread computes
// s1_t for its own columns (CPT of them per strip of STRIP columns) into
// registers, so neither score table touches device memory.  Each thread
// keeps its columns' running sums of G over the tile's rows in registers
// (written as per-tile partials, then summed over tiles in order); a row's
// sum is a warp shuffle reduction per row, added per warp into shared
// memory and summed over the warps in order.  The loss is per-thread
// serial, then a fixed-order block and grid reduction.  Everything is
// deterministic, and the value-only and fused launches give the same loss
// bit for bit (the loss arithmetic uses explicit round-to-nearest
// intrinsics).  One fused launch a training step.
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
// page type reads a cell as float; the uint8 read takes 0.136 ms of the
// bound above, bf16 0.272 ms, float32 0.545 ms, all below the operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bce_cell.cuh"
#include "contract.cuh"

namespace {

using bce_cell::cell_u24;  // cell = row * n + col of relation t's plane
using bce_cell::relation_key;
using bce_cell::softplus;

constexpr int D = 16;                // the hidden width l1
constexpr int THREADS = 256;         // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 128;            // page rows per block
constexpr int CPT = 3;               // columns per thread in a strip
constexpr int STRIP = THREADS * CPT;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float page_value(uint8_t x) { return (float)x; }
__device__ __forceinline__ float page_value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float page_value(float x) { return x; }

__device__ __forceinline__ float dot16(const float* __restrict__ a,
                                       const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) s = fmaf(a[k], b[k], s);
  return s;
}

// grid: n_et * n_tiles blocks, block b = (t = b / n_tiles, tile = b %
// n_tiles).  Writes loss_part[b]; with GRADS also col_part[t][tile][j] and
// the row sums rows[t][i] of the tile's rows.
template <typename P, bool GRADS>
__global__ void __launch_bounds__(THREADS)
page_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
            const float* __restrict__ h1, const float* __restrict__ h2,
            const P* __restrict__ pages, const int32_t* __restrict__ q,
            uint32_t seed, int n, int n_tiles, float* __restrict__ loss_part,
            float* __restrict__ col_part, float* __restrict__ rows) {
  __shared__ float s2[ROWS];
  __shared__ float rowpart[WARPS][ROWS];
  __shared__ float warp_loss[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int row0 = tile * ROWS, nrows = min(ROWS, n - row0);

  float wv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) wv[k] = w2[(size_t)t * D + k];
  if (tid < nrows) s2[tid] = dot16(h2 + (size_t)(row0 + tid) * D, wv);
  if (GRADS)
    for (int i = tid; i < WARPS * ROWS; i += THREADS) (&rowpart[0][0])[i] = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) wv[k] = w1[(size_t)t * D + k];
  const int q0 = q[t * 3], q1 = q[t * 3 + 1], q2 = q[t * 3 + 2];
  const uint32_t key = relation_key(seed, (uint32_t)t);
  __syncthreads();

  float loss_acc = 0.f;
  for (int j0 = 0; j0 < n; j0 += STRIP) {
    float s1[CPT], cacc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + tid + c * THREADS;
      s1[c] = j < n ? dot16(h1 + (size_t)j * D, wv) : 0.f;
      cacc[c] = 0.f;
    }
    for (int i = 0; i < nrows; ++i) {
      const int gi = row0 + i;
      const float a = s2[i];
      const P* prow = pages + ((size_t)t * n + gi) * n;
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = j0 + tid + c * THREADS;
        if (j < n) {
          const float L = __fadd_rn(a, s1[c]);
          const float da = page_value(prow[j]);
          const int u = cell_u24(key, (uint32_t)gi * (uint32_t)n + (uint32_t)j);
          float cnt = (float)((u < q0) + (u < q1) + (u < q2));
          if (da > 0.f) cnt = 0.f;
          const float sp = softplus(-L);
          loss_acc = __fadd_rn(
              loss_acc, __fadd_rn(__fmul_rn(sp, da),
                                  __fmul_rn(__fadd_rn(sp, L), cnt)));
          if constexpr (GRADS) {
            const float sg = 1.f / (1.f + expf(L));  // sigmoid(-L)
            const float G = cnt - sg * (da + cnt);
            rsum += G;
            cacc[c] += G;
          }
        }
      }
      if constexpr (GRADS) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          rsum += __shfl_down_sync(FULL, rsum, off);
        if (lane == 0) rowpart[warp][i] += rsum;
      }
    }
    if constexpr (GRADS) {
      float* out = col_part + ((size_t)t * n_tiles + tile) * n;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = j0 + tid + c * THREADS;
        if (j < n) out[j] = cacc[c];
      }
    }
  }

  if constexpr (GRADS) {
    __syncthreads();
    if (tid < nrows) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += rowpart[w][tid];
      rows[(size_t)t * n + row0 + tid] = s;
    }
  }
  // fixed-order block reduction of the loss
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    loss_acc = __fadd_rn(loss_acc, __shfl_down_sync(FULL, loss_acc, off));
  if (lane == 0) warp_loss[warp] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, warp_loss[w]);
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

template <typename P>
void launch_pages(int grads, int blocks, const float* w1, const float* w2,
                  const float* h1, const float* h2, const void* pages,
                  const int32_t* q, uint32_t seed, int n, int n_tiles,
                  float* loss_part, float* col_part, float* rows,
                  cudaStream_t s) {
  const P* pg = static_cast<const P*>(pages);
  if (grads)
    page_kernel<P, true><<<blocks, THREADS, 0, s>>>(
        w1, w2, h1, h2, pg, q, seed, n, n_tiles, loss_part, col_part, rows);
  else
    page_kernel<P, false><<<blocks, THREADS, 0, s>>>(
        w1, w2, h1, h2, pg, q, seed, n, n_tiles, loss_part, col_part, rows);
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/dense_bce_nn.py).  w1, w2
// [n_et][16], h1, h2 [n][16] float32; pages [n_et][n][n] of page_kind 0
// (uint8), 1 (bf16) or 2 (float32); q [n_et][3] int32.  Scratch: loss_part
// [n_et * n_tiles], and with grads col_part [n_et][n_tiles][n], rows and
// cols [n_et][n], where n_tiles = ceil(n / 128).  Outputs: loss [1]; with
// grads dw1, dw2 [n_et][16], dh1, dh2 [n][16] (not touched without).
// Returns the first CUDA error (cudaErrorInvalidValue for an unknown
// page_kind).
extern "C" int tip_dense_bce_nn(const float* w1, const float* w2,
                                const float* h1, const float* h2,
                                const void* pages, int page_kind,
                                const int32_t* q, unsigned int seed, int n_et,
                                int n, int grads, float* loss_part,
                                float* col_part, float* rows, float* cols,
                                float* loss, float* dw1, float* dw2,
                                float* dh1, float* dh2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int blocks = n_et * n_tiles;
  if (page_kind == 0)
    launch_pages<uint8_t>(grads, blocks, w1, w2, h1, h2, pages, q, seed, n,
                          n_tiles, loss_part, col_part, rows, s);
  else if (page_kind == 1)
    launch_pages<__nv_bfloat16>(grads, blocks, w1, w2, h1, h2, pages, q, seed,
                                n, n_tiles, loss_part, col_part, rows, s);
  else if (page_kind == 2)
    launch_pages<float>(grads, blocks, w1, w2, h1, h2, pages, q, seed, n,
                        n_tiles, loss_part, col_part, rows, s);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_loss<<<1, THREADS, 0, s>>>(loss_part, blocks, loss);
  if ((err = cudaGetLastError()) != cudaSuccess || !grads) return err;
  const size_t cells = (size_t)n_et * n;
  sum_tiles<<<(unsigned)((cells + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      col_part, n_et, n_tiles, n, cols);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // r_t feeds dw2 and dh2, c_t feeds dw1 and dh1
  err = contract::both(rows, n, h2, w2, n_et, n, dw2, dh2, s);
  if (err != cudaSuccess) return err;
  return contract::both(cols, n, h1, w1, n_et, n, dw1, dh1, s);
}
