// v1 NN-decoder SDDMM over chunk-aligned typed edges for Hopper (sm_90a),
// forward and backward: kernel B7.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_segment.py
// (nn_logits_padded: _nn_fwd_kernel, _nn_bwd_kernel):
//   logit[c, j] = sum_l h1[src, l] * w1[t, l] + h2[dst, l] * w2[t, l],
//                 t = ct[c]
//   dh1[src] += bf16?(w1[t] * g);  dh2[dst] += bf16?(w2[t] * g)
//   dwc1[c] = sum_j h1[src] * g;   dwc2[c] = sum_j h2[dst] * g
//   dw1[t], dw2[t] = sums over t's chunks of dwc1, dwc2, in chunk order
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing, C taken at run time.  The wrapper hands in h1p
// and h2p = h1, h2 (rounded to the compute dtype) with a zero row n
// appended.  A pad slot's dst term is exactly 0 (the TPU kernel's all-zero
// one-hot column), but its src term is real: the TPU kernel scores, and
// differentiates, the pad src too and leaves the masking to the caller
// (pallas_segment.py:nn_logits_padded), and so does this kernel.  With
// round_bf16 each scattered dh contribution w[t] * g is rounded to bf16
// before it is added (the TPU kernel's `(w * g).astype`), with float32
// everywhere else; v2 (nn_sddmm.cu) rounds per (relation, endpoint) sum
// instead, so the two agree exactly in float32 on valid slots and differ by
// design in bf16.  The hidden width l1 is 16 (the wrapper refuses others).
//
// Design.  One thread per slot; persistent blocks walk the chunks with a
// stride of the grid, each thread reading its slot's rows of h1 and h2
// directly (the TPU kernel's one-hot matmuls over the whole node axis).
// Forward: both tables sit in shared memory where they fit (n <= 1,708;
// rows of l1 + 1 floats), else rows are read from global memory
// (L2-resident).  Backward: rows come from global memory; dh1 and dh2 are
// added with atomics into per-block shared-memory tables where both fit (n
// <= 1,693), whose partials a second pass sums in block order, else straight
// into a zeroed global table.  dwc1 | dwc2 are fixed-order block sums per
// chunk and dw1 | dw2 per-relation sums over the chunk ranges
// (chunk_sums.cuh): the logits, dw1 and dw2 are deterministic, dh1 and dh2
// (atomics in no fixed order) are not bit for bit.  A relation that owns no
// chunk gets dw = 0.
//
// Bound on an H100 at Decagon shape (~9.0 M slots, l1 = 16): the forward
// reads src and dst and writes the logit, 12 bytes a slot (~108 MB, ~0.032
// ms at 3.35 TB/s) against 4 l1 float operations a slot (~0.009 ms at 67
// TFLOP/s): bytes bound it.  The backward reads src, dst and g (12 bytes a
// slot) and does ~6 l1 operations a slot: bytes bound it too.
// chip_smoke.py reckons the bounds from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_sums.cuh"

namespace {

constexpr int D = 16;
constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 512;
constexpr int AUX_THREADS = 256;
constexpr int S = D + 1;  // row stride of a shared-memory table

template <bool SHARED>
__global__ void __launch_bounds__(FWD_THREADS)
nn1_fwd(const float* __restrict__ h1p, const float* __restrict__ h2p,
        const float* __restrict__ w1, const float* __restrict__ w2,
        const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
        const int32_t* __restrict__ ct, int n_chunks, int C, int n,
        float* __restrict__ out) {
  extern __shared__ float tabs[];  // SHARED: h1 [n + 1][S], then h2
  const float* t1 = h1p;
  const float* t2 = h2p;
  if (SHARED) {
    float* s2 = tabs + (size_t)(n + 1) * S;
    for (int i = threadIdx.x; i < (n + 1) * D; i += blockDim.x) {
      tabs[(i / D) * S + i % D] = h1p[i];
      s2[(i / D) * S + i % D] = h2p[i];
    }
    __syncthreads();
    t1 = tabs;
    t2 = s2;
  }
  constexpr int RS = SHARED ? S : D;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    float w1r[D], w2r[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      w1r[k] = w1[(size_t)ct[c] * D + k];
      w2r[k] = w2[(size_t)ct[c] * D + k];
    }
    const size_t base = (size_t)c * C;
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const float* a = t1 + (size_t)src[base + j] * RS;
      const float* b = t2 + (size_t)dst[base + j] * RS;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k)
        acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(a[k], w1r[k]),
                                       __fmul_rn(b[k], w2r[k])));
      out[base + j] = acc;
    }
  }
}

__device__ __forceinline__ float maybe_bf16(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// dh_out holds dh1 [n + 1][D] then dh2 [n + 1][D].  SHARED: adds into two
// shared [n + 1][S] tables and writes them to dh_out[blockIdx.x]; else adds
// into dh_out itself (zeroed by the caller).  dwc[c] gets chunk c's
// partials dw1 | dw2 (2 D floats).
template <bool SHARED>
__global__ void __launch_bounds__(BWD_THREADS)
nn1_bwd(const float* __restrict__ h1p, const float* __restrict__ h2p,
        const float* __restrict__ w1, const float* __restrict__ w2,
        const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
        const int32_t* __restrict__ ct, const float* __restrict__ g,
        int n_chunks, int C, int n, int round_bf16, float* __restrict__ dh_out,
        float* __restrict__ dwc) {
  extern __shared__ float acc_tabs[];  // SHARED: dh1 [n + 1][S], then dh2
  __shared__ float red[(BWD_THREADS / 32) * 2 * D];
  constexpr int AS = SHARED ? S : D;
  float* acc1 = SHARED ? acc_tabs : dh_out;
  float* acc2 = acc1 + (size_t)(n + 1) * AS;
  if (SHARED) {
    for (int i = threadIdx.x; i < 2 * (n + 1) * S; i += blockDim.x)
      acc_tabs[i] = 0.f;
    __syncthreads();
  }
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    float w1r[D], w2r[D], dwl[2 * D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      w1r[k] = w1[(size_t)ct[c] * D + k];
      w2r[k] = w2[(size_t)ct[c] * D + k];
      dwl[k] = dwl[D + k] = 0.f;
    }
    const size_t base = (size_t)c * C;
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const int s = src[base + j], d = dst[base + j];
      const float gv = g[base + j];
      const float* a = h1p + (size_t)s * D;
      const float* b = h2p + (size_t)d * D;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        atomicAdd(&acc1[(size_t)s * AS + k],
                  maybe_bf16(__fmul_rn(w1r[k], gv), round_bf16));
        if (d < n)  // a pad dst scatters nowhere
          atomicAdd(&acc2[(size_t)d * AS + k],
                    maybe_bf16(__fmul_rn(w2r[k], gv), round_bf16));
        dwl[k] = __fadd_rn(dwl[k], __fmul_rn(a[k], gv));
        dwl[D + k] = __fadd_rn(dwl[D + k], __fmul_rn(b[k], gv));
      }
    }
    chunk_sums::block_sum<2 * D>(dwl, red, dwc + (size_t)c * 2 * D);
  }
  if (SHARED) {
    __syncthreads();
    float* out = dh_out + (size_t)blockIdx.x * 2 * (n + 1) * D;
    for (int i = threadIdx.x; i < 2 * (n + 1) * D; i += blockDim.x)
      out[i] = acc_tabs[(i / D) * S + i % D];
  }
}

int tables_bytes(int n) { return 2 * (n + 1) * S * (int)sizeof(float); }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/typed_segment.py).  h1p,
// h2p are h1, h2 [n, 16] with a zero row appended; `shared` picks the table
// mode, and the wrapper checks that shared tables fit.  Each returns the
// first CUDA error.

// out: [n_chunks, C] float32.
extern "C" int tip_nn1_fwd(const float* h1p, const float* h2p, const float* w1,
                           const float* w2, const int32_t* src,
                           const int32_t* dst, const int32_t* ct, int n_chunks,
                           int C, int n, int shared, int blocks, float* out,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!shared) {
    nn1_fwd<false><<<blocks, FWD_THREADS, 0, s>>>(h1p, h2p, w1, w2, src, dst,
                                                   ct, n_chunks, C, n, out);
    return cudaGetLastError();
  }
  const int smem = tables_bytes(n);
  cudaError_t err = allow_smem(nn1_fwd<true>, smem);
  if (err != cudaSuccess) return err;
  nn1_fwd<true><<<blocks, FWD_THREADS, smem, s>>>(h1p, h2p, w1, w2, src, dst,
                                                   ct, n_chunks, C, n, out);
  return cudaGetLastError();
}

// g: [n_chunks, C]; scratch dh_part [blocks, 2, n + 1, 16] (shared mode
// only) and dwc [n_chunks, 2, 16]; outputs dh [2, n + 1, 16] (dh1, dh2; row
// n of dh2 stays 0, row n of dh1 is unused) and dw [n_et, 2, 16] (dw1,
// dw2).
extern "C" int tip_nn1_bwd(const float* h1p, const float* h2p, const float* w1,
                           const float* w2, const int32_t* src,
                           const int32_t* dst, const int32_t* ct,
                           const float* g, int n_chunks, int C, int n,
                           int n_et, int round_bf16, int shared, int blocks,
                           float* dh_part, float* dwc, float* dh, float* dw,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (shared) {
    const int smem = tables_bytes(n);
    if ((err = allow_smem(nn1_bwd<true>, smem)) != cudaSuccess) return err;
    nn1_bwd<true><<<blocks, BWD_THREADS, smem, s>>>(
        h1p, h2p, w1, w2, src, dst, ct, g, n_chunks, C, n, round_bf16,
        dh_part, dwc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int count = 2 * (n + 1) * D;
    chunk_sums::sum_parts<<<(count + AUX_THREADS - 1) / AUX_THREADS,
                            AUX_THREADS, 0, s>>>(dh_part, blocks, count, dh);
  } else {
    err = cudaMemsetAsync(dh, 0, (size_t)2 * (n + 1) * D * sizeof(float), s);
    if (err != cudaSuccess) return err;
    nn1_bwd<false><<<blocks, BWD_THREADS, 0, s>>>(
        h1p, h2p, w1, w2, src, dst, ct, g, n_chunks, C, n, round_bf16, dh,
        dwc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_sums::by_relation<<<(n_et * 2 * D + AUX_THREADS - 1) / AUX_THREADS,
                            AUX_THREADS, 0, s>>>(dwc, ct, n_chunks, n_et,
                                                 2 * D, dw);
  return cudaGetLastError();
}
