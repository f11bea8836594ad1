// The DistMult SDDMM forward over chunk-aligned typed edges, shared by the
// v2 kernel B8 (distmult_sddmm.cu) and the v1 kernel B6
// (distmult_sddmm_v1.cu): the two TPU kernels' forwards compute the same
// logits (they differ only in where their backwards round to bf16), so one
// CUDA forward serves both.
//   logit[c, j] = sum_k (z[src, k] * z[dst, k]) * w[ct[c], k]
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks], C taken at run time.  zp is z [n, 16] with a zero row n
// appended, so a pad slot's logit is exactly 0.
//
// One thread per slot; persistent blocks walk the chunks with a stride of
// the grid.  Two table modes, picked by the caller: shared (n <= 3,417) loads
// the whole table (n + 1 rows of d + 1 floats: the odd row stride spreads
// random rows over the banks) once per block; global reads the rows from zp
// in global memory (L2-resident: 64 bytes a node).  Deterministic: each
// logit is one thread's sum in k order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace distmult_fwd {

constexpr int D = 16;
constexpr int THREADS = 512;

// tab[r][D + 1] = zp[r][D] for the n + 1 rows of zp.
__device__ __forceinline__ void load_table(const float* __restrict__ zp, int n,
                                           float* tab) {
  for (int i = threadIdx.x; i < (n + 1) * D; i += blockDim.x)
    tab[(i / D) * (D + 1) + i % D] = zp[i];
}

// Bytes of one shared-memory table of n + 1 rows.
inline int table_bytes(int n) { return (n + 1) * (D + 1) * (int)sizeof(float); }

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
logits(const float* __restrict__ zp, const float* __restrict__ w,
       const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
       const int32_t* __restrict__ ct, int n_chunks, int C, int n,
       float* __restrict__ out) {
  extern __shared__ float smem[];  // shared: [n + 1][D + 1]
  constexpr int S = SHARED ? D + 1 : D;  // row stride of the table
  const float* tab = zp;
  if (SHARED) {
    load_table(zp, n, smem);
    __syncthreads();
    tab = smem;
  }
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const float* wt = w + (size_t)ct[c] * D;
    float wr[D];
#pragma unroll
    for (int k = 0; k < D; ++k) wr[k] = wt[k];
    const size_t base = (size_t)c * C;
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const float* a = tab + (size_t)src[base + j] * S;
      const float* b = tab + (size_t)dst[base + j] * S;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k)
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(a[k], b[k]), wr[k]));
      out[base + j] = s;
    }
  }
}

// out: [n_chunks, C] float32.  Returns the first CUDA error.
inline cudaError_t launch(const float* zp, const float* w, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, int n_chunks,
                          int C, int n, int shared, int blocks, float* out,
                          cudaStream_t s) {
  if (!shared) {
    logits<false><<<blocks, THREADS, 0, s>>>(zp, w, src, dst, ct, n_chunks, C,
                                             n, out);
    return cudaGetLastError();
  }
  const int smem = table_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      logits<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  logits<true><<<blocks, THREADS, smem, s>>>(zp, w, src, dst, ct, n_chunks, C,
                                             n, out);
  return cudaGetLastError();
}

}  // namespace distmult_fwd
