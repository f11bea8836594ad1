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
// Design (that of dense_bce_sym.cu, B1).  The TPU kernel streams pages
// through a VMEM ring on one core and adds dz up serially.  Here one block
// owns one 128 x 128 tile (I, J) of the page plane for a chunk of RC
// relations: z_I and z_J stay in shared memory across the chunk (only w_t
// changes), the G tile goes through shared memory for the two gradient
// contractions, and dz for the tile's rows (threads 0..127) and columns
// (threads 128..255) accumulates in registers across the chunk.  Unlike B1
// every (I, J) tile of the plane is visited, not only the upper triangle:
// the pages need not be symmetric, so there is no mirror weight.  Every
// block writes its loss, dw and dz partials to scratch, and small second
// passes sum them in a fixed order: the result is deterministic, and the
// value-only and fused launches give the same loss bit for bit (the loss
// arithmetic uses explicit round-to-nearest intrinsics).  One fused launch
// a training step.
//
// Bound on an H100 at Decagon shape (R = 1,097, n = 645, d = 16: 456 M
// cells): the float32 page read takes 0.545 ms at 3.35 TB/s (bf16 pages
// 0.272 ms); three d-long dots (6 d flops) and ~20 elementwise float
// operations a cell (softplus, sigmoid, counts, G) take ~0.79 ms at 67
// TFLOP/s, so operations bound it, besides the hash's integer work.
// chip_smoke.py reckons the bound from its run.  The 128-wide tiles cover
// a 768 x 768 plane at n = 645, so 29 % of the cells evaluated are padding;
// wgmma for the contractions and TMA for the page stream are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bce_cell.cuh"

namespace {

using bce_cell::cell_u24;  // cell = row * n + col of relation t's plane
using bce_cell::relation_key;
using bce_cell::softplus;

constexpr int B = 128;          // tile edge
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int GSTRIDE = B + 1;  // padded row stride of the G tile

__device__ __forceinline__ float page_value(float x) { return x; }
__device__ __forceinline__ float page_value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ __forceinline__ int smem_floats(int d, bool grads) {
  // zi [B][d], ziw [B][d], zjT [d][B]; with grads also red [B][d] and G
  return 3 * B * d + (grads ? B * d + B * GSTRIDE : 0);
}

// grid: (nb * nb tiles, ceil(n_et / rc) relation chunks); tile = I * nb + J.
// Writes loss_part[blk]; with GRADS also dw_part[tile][t] and the tile's dz
// row and column partials dz_part[blk][side][r], blk = chunk * nb^2 + tile.
template <typename P, int D, bool GRADS>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const float* __restrict__ w, const float* __restrict__ z,
            const P* __restrict__ pages, const int32_t* __restrict__ q,
            uint32_t seed, int n_et, int n, int nb, int rc,
            float* __restrict__ loss_part, float* __restrict__ dw_part,
            float* __restrict__ dz_part) {
  extern __shared__ float smem[];
  __shared__ float warp_loss[WARPS];
  float* zi = smem;           // [B][D]
  float* ziw = zi + B * D;    // [B][D]
  float* zjT = ziw + B * D;   // [D][B]
  float* red = zjT + D * B;   // [B][D]      (GRADS)
  float* G = red + B * D;     // [B][GSTRIDE] (GRADS)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int row0 = (tile / nb) * B, col0 = (tile % nb) * B;

  for (int idx = tid; idx < B * D; idx += THREADS) {
    const int r = idx / D, k = idx % D;
    zi[idx] = row0 + r < n ? z[(size_t)(row0 + r) * D + k] : 0.f;
    zjT[k * B + r] = col0 + r < n ? z[(size_t)(col0 + r) * D + k] : 0.f;
  }

  const int t0 = blockIdx.y * rc;
  const int t1 = min(t0 + rc, n_et);
  float loss_acc = 0.f;
  float acc[D];  // this thread's dz row (tid < B) or column, over the chunk
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const uint32_t key = relation_key(seed, (uint32_t)t);
    const int q0 = q[t * 3], q1 = q[t * 3 + 1], q2 = q[t * 3 + 2];
    for (int idx = tid; idx < B * D; idx += THREADS)
      ziw[idx] = __fmul_rn(zi[idx], w[(size_t)t * D + idx % D]);
    __syncthreads();

    const P* page = pages + (size_t)t * n * n;
    for (int m = 0; m < B / WARPS; ++m) {
      const int r = warp + WARPS * m;
      const int gr = row0 + r;
      float a[D];
#pragma unroll
      for (int k = 0; k < D; ++k) a[k] = ziw[r * D + k];
#pragma unroll
      for (int qq = 0; qq < B / 32; ++qq) {
        const int c = lane + 32 * qq;
        const int gc = col0 + c;
        float L = __fmul_rn(a[0], zjT[c]);
#pragma unroll
        for (int k = 1; k < D; ++k) L = __fmaf_rn(a[k], zjT[k * B + c], L);
        const bool inside = gr < n && gc < n;
        const float da =
            inside ? page_value(page[(size_t)gr * n + gc]) : 0.f;
        const int u = cell_u24(key, (uint32_t)gr * (uint32_t)n + (uint32_t)gc);
        float cnt = (float)((u < q0) + (u < q1) + (u < q2));
        if (da > 0.f || !inside) cnt = 0.f;
        const float sp = softplus(-L);
        loss_acc = __fadd_rn(
            loss_acc, __fadd_rn(__fmul_rn(sp, da),
                                __fmul_rn(__fadd_rn(sp, L), cnt)));
        if constexpr (GRADS) {
          const float sg = 1.f / (1.f + expf(L));  // sigmoid(-L)
          G[r * GSTRIDE + c] = cnt - sg * (da + cnt);
        }
      }
    }
    __syncthreads();
    if constexpr (GRADS) {
      // tid < B: row r of G z_J (dz rows I, and dw_t); else column c of
      // G^T z_I (dz rows J)
      float h[D];
#pragma unroll
      for (int k = 0; k < D; ++k) h[k] = 0.f;
      if (tid < B) {
        const int r = tid;
        for (int c = 0; c < B; ++c) {
          const float g = G[r * GSTRIDE + c];
#pragma unroll
          for (int k = 0; k < D; ++k) h[k] = fmaf(g, zjT[k * B + c], h[k]);
        }
#pragma unroll
        for (int k = 0; k < D; ++k) red[r * D + k] = zi[r * D + k] * h[k];
      } else {
        const int c = tid - B;
        for (int r = 0; r < B; ++r) {
          const float g = G[r * GSTRIDE + c];
#pragma unroll
          for (int k = 0; k < D; ++k) h[k] = fmaf(g, zi[r * D + k], h[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = fmaf(w[(size_t)t * D + k], h[k], acc[k]);
      __syncthreads();
      if (tid < D) {
        float s = 0.f;
        for (int r = 0; r < B; ++r) s += red[r * D + tid];
        dw_part[((size_t)tile * n_et + t) * D + tid] = s;
      }
    }
  }

  const size_t blk = (size_t)blockIdx.y * n_tiles + tile;
  if constexpr (GRADS) {
    float* out = dz_part + ((blk * 2 + (tid < B ? 0 : 1)) * B + (tid % B)) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) out[k] = acc[k];
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
  const int smem = smem_floats(D, GRADS) * (int)sizeof(float);
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
// (page_bf16 1); q [n_et][3] int32.  Scratch sizes, in floats: loss_part
// nb^2 * n_chunks; dw_part nb^2 * n_et * d; dz_part n_chunks * nb^2 * 2 *
// 128 * d, where nb = ceil(n / 128) and n_chunks = ceil(n_et / rc).  With
// grads 0 the dw/dz pointers are not touched.  Returns the first CUDA error.
extern "C" int tip_dense_bce(const float* w, const float* z, const void* pages,
                             int page_bf16, const int32_t* q, unsigned int seed,
                             int n_et, int n, int d, int rc, int grads,
                             float* loss_part, float* dw_part, float* dz_part,
                             float* loss, float* dw, float* dz, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (page_bf16)
    return dispatch_d<__nv_bfloat16>(d, grads, w, z, pages, q, seed, n_et, n,
                                     rc, loss_part, dw_part, dz_part, loss, dw,
                                     dz, s);
  return dispatch_d<float>(d, grads, w, z, pages, q, seed, n_et, n, rc,
                           loss_part, dw_part, dz_part, loss, dw, dz, s);
}
