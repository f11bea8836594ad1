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
// Persistent blocks walk the chunks with a stride of the grid.  Two table
// modes, picked by the caller:
//   shared (n <= 3,417): the whole table (n + 1 rows of d + 1 floats: the
//     odd row stride spreads random rows over the banks) is loaded once per
//     block, and one thread a slot sums its 16 products in k order;
//   global (any n): one lane quad a slot.  Lane q reads float4 q of the
//     slot's two z rows from zp in global memory through L1 (L2-resident:
//     64 bytes a node) and of w's row, sums its four products in k order,
//     and the quad adds the four partial sums by two shuffles, ((p0 + p1) +
//     (p2 + p3)).  The first global mode, one thread a slot reading the
//     rows a float at a time, was 3.5 times slower; a float4 table in
//     shared memory measured slower than the 17-float rows (PERF.md).
// Deterministic: each logit is one fixed sum, and a pad slot's is +0.0.

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

// The shared mode: one thread a slot over the block's copy of the table.
__global__ void __launch_bounds__(THREADS)
logits_shared(const float* __restrict__ zp, const float* __restrict__ w,
              const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
              const int32_t* __restrict__ ct, int n_chunks, int C, int n,
              float* __restrict__ out) {
  extern __shared__ float tab[];  // [n + 1][D + 1]
  constexpr int S = D + 1;  // row stride of the table
  load_table(zp, n, tab);
  __syncthreads();
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

// The global mode: one lane quad a slot (see the top of this file).
__global__ void __launch_bounds__(THREADS)
logits_quad(const float* __restrict__ zp, const float* __restrict__ w,
            const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
            const int32_t* __restrict__ ct, int n_chunks, int C, int n,
            float* __restrict__ out) {
  const float4* tab = reinterpret_cast<const float4*>(zp);
  const int q = threadIdx.x & 3;
  const int per = blockDim.x / 4;  // slots a block takes at once
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const float4 wv = reinterpret_cast<const float4*>(w + (size_t)ct[c] * D)[q];
    const size_t base = (size_t)c * C;
    for (int j0 = 0; j0 < C; j0 += per) {  // uniform: whole warps
      const int j = j0 + (threadIdx.x >> 2);
      const bool act = j < C;
      const float4 a = __ldg(tab + (size_t)(act ? src[base + j] : 0) * (D / 4) + q);
      const float4 b = __ldg(tab + (size_t)(act ? dst[base + j] : n) * (D / 4) + q);
      float p = __fadd_rn(0.f, __fmul_rn(__fmul_rn(a.x, b.x), wv.x));
      p = __fadd_rn(p, __fmul_rn(__fmul_rn(a.y, b.y), wv.y));
      p = __fadd_rn(p, __fmul_rn(__fmul_rn(a.z, b.z), wv.z));
      p = __fadd_rn(p, __fmul_rn(__fmul_rn(a.w, b.w), wv.w));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
      if (act && q == 0) out[base + j] = p;
    }
  }
}

// out: [n_chunks, C] float32.  Returns the first CUDA error.
inline cudaError_t launch(const float* zp, const float* w, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, int n_chunks,
                          int C, int n, int shared, int blocks, float* out,
                          cudaStream_t s) {
  if (!shared) {
    logits_quad<<<blocks, THREADS, 0, s>>>(zp, w, src, dst, ct, n_chunks, C, n,
                                           out);
    return cudaGetLastError();
  }
  const int smem = table_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      logits_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  logits_shared<<<blocks, THREADS, smem, s>>>(zp, w, src, dst, ct, n_chunks, C,
                                             n, out);
  return cudaGetLastError();
}

}  // namespace distmult_fwd
