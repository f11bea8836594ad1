// DistMult SDDMM over chunk-aligned typed edges for Hopper (sm_90a),
// forward and backward.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_sddmm2.py
// (distmult_logits_padded2: _dm2_fwd_kernel, _dm2_bwd_kernel):
//   logit[c, j] = sum_k (z[src, k] * z[dst, k]) * w[ct[c], k]
//   dz[src] += (g * z[dst]) * w[t];  dz[dst] += (g * z[src]) * w[t]
//   dwc[c, k] = sum_j (z[src, k] * z[dst, k]) * g[c, j];
//   dw[t] = sum over t's chunks of dwc, in chunk order
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing.  The wrapper hands in zp = z with a zero row n
// appended, so pad logits are exactly 0.0.  With round_bf16 each scattered
// dz contribution is rounded to bf16 (z comes in bf16-rounded from the
// wrapper), as the TPU kernel's casts do; accumulation is float32.  The
// feature width is 16 (n_hid2 of every configuration; the wrapper refuses
// others).
//
// The TPU kernel gathers with a two-level one-hot matmul and keeps the
// gathered endpoints as residuals; here each thread reads its slot's two
// rows of z directly, and the backward gathers again rather than reading
// saved endpoints (2 x 0.58 GB a call at Decagon shape).
//
// Design.  One thread per slot; persistent blocks walk the chunks.  The
// forward is distmult_fwd.cuh's, which the v1 kernel B6 launches too.  Two
// table modes, which the wrapper picks by what fits a block's shared
// memory:
//   shared (forward n <= 3,417, backward n <= 1,693): the whole table (n + 1
//     rows of d + 1 floats: the odd row stride spreads random rows over the
//     banks) is loaded once per block; the backward keeps a second table,
//     the dz accumulator, in shared memory too, writes one partial per
//     block, and a second pass sums the partials in block order;
//   global (any n): the rows are read from zp in global memory (L2-resident:
//     64 bytes a node) and dz is added straight into a zeroed global
//     [n + 1, d] accumulator.
// In both, a warp whose slots share a dst, as the dst-sorted positives do,
// first sums its dst contributions with a segmented shuffle scan and adds
// each run's total once.  dwc is a fixed-order block reduction per chunk,
// and dw a per-relation sum over its chunk range (found by binary search on
// the sorted chunk_type), so dw does not depend on the chunks' order of
// execution.  The forward is deterministic; dz adds atomically in no fixed
// order, so the backward's dz is not bit-for-bit deterministic.
//
// Bound on an H100 at Decagon shape (~9.0 M slots, d = 16): the forward
// must read src and dst and write the logit, 12 bytes a slot (~108 MB),
// ~0.03 ms at 3.35 TB/s; its 3 d float operations a slot (~0.43 G) take
// ~0.006 ms at 67 TFLOP/s, so bytes bound it.  The backward reads src, dst
// and g (12 bytes a slot) and does ~9 d operations a slot: bytes bound it
// too.  chip_smoke.py reckons the bounds from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "distmult_fwd.cuh"

namespace {

using distmult_fwd::load_table;
using distmult_fwd::table_bytes;

constexpr int D = 16;
constexpr int BWD_THREADS = 1024;
constexpr int AUX_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float maybe_bf16(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// shared: writes this block's dz partial to dz_out[blockIdx.x] ([n][D]);
// global: adds into dz_out itself ([n + 1][D], zeroed by the caller).
template <bool SHARED>
__global__ void __launch_bounds__(BWD_THREADS)
dm_bwd(const float* __restrict__ zp, const float* __restrict__ w,
       const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
       const int32_t* __restrict__ ct, const float* __restrict__ g, int n_chunks,
       int C, int n, int round_bf16, float* __restrict__ dz_out,
       float* __restrict__ dwc) {
  extern __shared__ float smem[];  // shared: z [n + 1][D + 1], then dz the same
  __shared__ float red[BWD_THREADS / 32][D];
  constexpr int S = SHARED ? D + 1 : D;
  const float* tab = zp;
  float* acc = dz_out;
  if (SHARED) {
    load_table(zp, n, smem);
    acc = smem + (n + 1) * (D + 1);
    for (int i = threadIdx.x; i < (n + 1) * (D + 1); i += blockDim.x) acc[i] = 0.f;
    __syncthreads();
    tab = smem;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const float* wt = w + (size_t)ct[c] * D;
    float wr[D], dwl[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      wr[k] = wt[k];
      dwl[k] = 0.f;
    }
    const size_t base = (size_t)c * C;
    for (int j0 = 0; j0 < C; j0 += blockDim.x) {  // uniform: whole warps
      const int j = j0 + threadIdx.x;
      const bool act = j < C;
      const int s = act ? src[base + j] : 0;
      const int dd = act ? dst[base + j] : n;  // row n: the zero row
      const float gv = act ? g[base + j] : 0.f;
      // The positive buffer is dst-sorted inside a chunk, so a warp's lanes
      // often share one dst: there they sum their dst contributions with a
      // segmented warp scan and one lane adds the run's total, instead of
      // 32 atomics on one address.  Unsorted warps (the negatives) add
      // their own.
      const int key = act ? dd : INT_MAX;
      const int prev = __shfl_up_sync(FULL, key, 1);
      const bool sorted = __all_sync(FULL, lane == 0 || prev <= key);
      int head = lane, tail = lane;
      if (sorted) {
        const unsigned seg = __match_any_sync(FULL, key);
        head = __ffs(seg) - 1;
        tail = 31 - __clz(seg);
      }
      const float* a = tab + (size_t)s * S;
      const float* b = tab + (size_t)dd * S;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float ak = a[k], bk = b[k];
        if (act)
          atomicAdd(&acc[(size_t)s * S + k],
                    maybe_bf16(__fmul_rn(__fmul_rn(gv, bk), wr[k]), round_bf16));
        float cd = maybe_bf16(__fmul_rn(__fmul_rn(gv, ak), wr[k]), round_bf16);
        if (sorted) {
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float o = __shfl_up_sync(FULL, cd, off);
            if (lane - off >= head) cd = __fadd_rn(cd, o);
          }
        }
        if (act && lane == tail) atomicAdd(&acc[(size_t)dd * S + k], cd);
        dwl[k] = __fadd_rn(dwl[k], __fmul_rn(__fmul_rn(ak, bk), gv));
      }
    }
    // fixed-order reduction of dwl over the block
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float v = dwl[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(FULL, v, off));
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < D) {
      float v = 0.f;
      for (int q = 0; q < nwarps; ++q) v = __fadd_rn(v, red[q][threadIdx.x]);
      dwc[(size_t)c * D + threadIdx.x] = v;
    }
    __syncthreads();
  }

  if (SHARED) {
    float* out = dz_out + (size_t)blockIdx.x * n * D;
    for (int i = threadIdx.x; i < n * D; i += blockDim.x)
      out[i] = acc[(i / D) * (D + 1) + i % D];
  }
}

// out[i] = sum over b of part[b][i], in b order.
__global__ void sum_parts(const float* __restrict__ part, int blocks, int count,
                          float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * count + i];
  out[i] = s;
}

// dw[t, k] = sum of dwc[c, k] over the chunks c of relation t, in chunk
// order (chunk_type is sorted; a relation without chunks gets 0).
__global__ void dw_by_relation(const float* __restrict__ dwc,
                               const int32_t* __restrict__ ct, int n_chunks,
                               int n_et, float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_et * D) return;
  const int t = i / D, k = i % D;
  int lo = 0, hi = n_chunks;  // first chunk with ct >= t
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (ct[mid] < t) lo = mid + 1; else hi = mid;
  }
  float s = 0.f;
  for (int c = lo; c < n_chunks && ct[c] == t; ++c) s += dwc[(size_t)c * D + k];
  dw[i] = s;
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/sddmm2.py).  zp is z
// [n, 16] with a zero row appended; `shared` picks the table mode, and
// the wrapper checks that a shared table fits.  Each returns the first
// CUDA error.

// out: [n_chunks, C] float32.
extern "C" int tip_dm_fwd(const float* zp, const float* w, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, int n_chunks,
                          int C, int n, int shared, int blocks, float* out,
                          void* stream) {
  return distmult_fwd::launch(zp, w, src, dst, ct, n_chunks, C, n, shared,
                              blocks, out, (cudaStream_t)stream);
}

// g: [n_chunks, C]; scratch dz_part [blocks, n, 16] (shared mode only) and
// dwc [n_chunks, 16]; outputs dz [n + 1, 16] (row n is scratch), dw
// [n_et, 16].
extern "C" int tip_dm_bwd(const float* zp, const float* w, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, const float* g,
                          int n_chunks, int C, int n, int n_et, int round_bf16,
                          int shared, int blocks, float* dz_part, float* dwc,
                          float* dz, float* dw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (shared) {
    const int smem = 2 * table_bytes(n);
    err = cudaFuncSetAttribute(dm_bwd<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dm_bwd<true><<<blocks, BWD_THREADS, smem, s>>>(
        zp, w, src, dst, ct, g, n_chunks, C, n, round_bf16, dz_part, dwc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int count = n * D;
    sum_parts<<<(count + AUX_THREADS - 1) / AUX_THREADS, AUX_THREADS, 0, s>>>(
        dz_part, blocks, count, dz);
  } else {
    err = cudaMemsetAsync(dz, 0, (size_t)(n + 1) * D * sizeof(float), s);
    if (err != cudaSuccess) return err;
    dm_bwd<false><<<blocks, BWD_THREADS, 0, s>>>(
        zp, w, src, dst, ct, g, n_chunks, C, n, round_bf16, dz, dwc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dw_by_relation<<<(n_et * D + AUX_THREADS - 1) / AUX_THREADS, AUX_THREADS, 0,
                   s>>>(dwc, ct, n_chunks, n_et, dw);
  return cudaGetLastError();
}
