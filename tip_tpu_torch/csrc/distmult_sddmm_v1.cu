// v1 DistMult SDDMM over chunk-aligned typed edges for Hopper (sm_90a),
// forward and backward: kernel B6.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_segment.py
// (distmult_logits_padded: _distmult_fwd_kernel, _distmult_bwd_kernel):
//   logit[c, j] = sum_k (z[src, k] * z[dst, k]) * w[ct[c], k]
//   dz[src] += bf16?((z[dst] * w[t]) * g);  dz[dst] += bf16?((z[src] * w[t]) * g)
//   dwc[c, k] = sum_j (z[src, k] * z[dst, k]) * g[c, j]
//   dw[t] = sum over t's chunks of dwc, in chunk order
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing, C taken at run time.  The wrapper hands in zp
// = z (rounded to the compute dtype) with a zero row n appended, so a pad
// slot reads zeros at its dst, as the TPU kernel's all-zero one-hot column
// does: its logit is exactly 0 and it adds nothing to dz or dw.  With
// round_bf16 each scattered dz contribution is rounded to bf16 before it is
// added, at the TPU kernel's rounding points (its `(zd * w * g).astype`);
// everything else is float32.  This rounds at other points than v2
// (distmult_sddmm.cu, which scales g by the endpoint first), so the two
// agree exactly in float32 on valid slots and differ by design in bf16.
// The feature width is 16 (the wrapper refuses others).
//
// The TPU kernel gathers the endpoints with one-hot matmuls over the whole
// node axis held in VMEM.  On this card a gather is a load, so each thread
// reads its slot's two rows directly.
//
// Design.  The forward is v2's (distmult_fwd.cuh, launched here under B6's
// entry point): the two TPU kernels' logits are the same products summed in
// the same order, so B6's logits equal B8's bit for bit.  The backward is
// B6's own.  One thread per slot; persistent blocks walk the chunks (the
// TPU grid's axis) with a stride of the grid.  The backward reads rows
// from global memory (64 bytes a node, L2-resident); dz is added with
// atomics into a per-block shared-memory table where it fits (n <= 3,402),
// whose partials a second pass sums in block order, else straight into a
// zeroed global table.  dwc
// is a fixed-order block sum per chunk (chunk_sums.cuh), and dw a
// per-relation sum over its chunk range, so dw and the logits are
// deterministic; dz's atomics add in no fixed order, so dz is not bit-for-
// bit deterministic.  A relation that owns no chunk gets dw = 0 (the TPU
// kernel never writes its block).
//
// Bound on an H100 at Decagon shape (~9.0 M slots, d = 16): the forward must
// read src and dst and write the logit, 12 bytes a slot (~108 MB), ~0.032
// ms at 3.35 TB/s; its 3 d float operations a slot (~0.43 G) take ~0.006 ms
// at 67 TFLOP/s, so bytes bound it.  The backward reads src, dst and g (12
// bytes a slot) and does ~9 d operations a slot: bytes bound it too.
// chip_smoke.py reckons the bounds from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_sums.cuh"
#include "distmult_fwd.cuh"

namespace {

constexpr int D = 16;
constexpr int BWD_THREADS = 512;
constexpr int AUX_THREADS = 256;
constexpr int S = D + 1;  // row stride of a shared-memory table

__device__ __forceinline__ float maybe_bf16(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// SHARED: adds into a shared [n + 1][S] table and writes it to
// dz_out[blockIdx.x] ([n + 1][D]); else adds into dz_out ([n + 1][D],
// zeroed by the caller).  dwc[c] gets chunk c's dw partial.
template <bool SHARED>
__global__ void __launch_bounds__(BWD_THREADS)
dm1_bwd(const float* __restrict__ zp, const float* __restrict__ w,
        const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
        const int32_t* __restrict__ ct, const float* __restrict__ g,
        int n_chunks, int C, int n, int round_bf16, float* __restrict__ dz_out,
        float* __restrict__ dwc) {
  extern __shared__ float acc_tab[];  // SHARED: [n + 1][S]
  __shared__ float red[(BWD_THREADS / 32) * D];
  constexpr int AS = SHARED ? S : D;
  float* acc = SHARED ? acc_tab : dz_out;
  if (SHARED) {
    for (int i = threadIdx.x; i < (n + 1) * S; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();
  }
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    float wr[D], dwl[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      wr[k] = w[(size_t)ct[c] * D + k];
      dwl[k] = 0.f;
    }
    const size_t base = (size_t)c * C;
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const int s = src[base + j], d = dst[base + j];
      const float gv = g[base + j];
      const float* a = zp + (size_t)s * D;
      const float* b = zp + (size_t)d * D;
      const bool real = d < n;  // a pad slot's contributions are all 0
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float ak = a[k], bk = b[k];
        if (real) {
          atomicAdd(&acc[(size_t)s * AS + k],
                    maybe_bf16(__fmul_rn(__fmul_rn(bk, wr[k]), gv), round_bf16));
          atomicAdd(&acc[(size_t)d * AS + k],
                    maybe_bf16(__fmul_rn(__fmul_rn(ak, wr[k]), gv), round_bf16));
        }
        dwl[k] = __fadd_rn(dwl[k], __fmul_rn(__fmul_rn(ak, bk), gv));
      }
    }
    chunk_sums::block_sum<D>(dwl, red, dwc + (size_t)c * D);
  }
  if (SHARED) {
    __syncthreads();
    float* out = dz_out + (size_t)blockIdx.x * (n + 1) * D;
    for (int i = threadIdx.x; i < (n + 1) * D; i += blockDim.x)
      out[i] = acc[(i / D) * S + i % D];
  }
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/typed_segment.py).  zp is
// z [n, 16] with a zero row appended; `shared` picks the table mode, and the
// wrapper checks that a shared table fits.  Each returns the first CUDA
// error.

// out: [n_chunks, C] float32.
extern "C" int tip_dm1_fwd(const float* zp, const float* w, const int32_t* src,
                           const int32_t* dst, const int32_t* ct, int n_chunks,
                           int C, int n, int shared, int blocks, float* out,
                           void* stream) {
  return distmult_fwd::launch(zp, w, src, dst, ct, n_chunks, C, n, shared,
                              blocks, out, (cudaStream_t)stream);
}

// g: [n_chunks, C]; scratch dz_part [blocks, n + 1, 16] (shared mode only)
// and dwc [n_chunks, 16]; outputs dz [n + 1, 16] (row n stays 0), dw
// [n_et, 16].
extern "C" int tip_dm1_bwd(const float* zp, const float* w, const int32_t* src,
                           const int32_t* dst, const int32_t* ct,
                           const float* g, int n_chunks, int C, int n,
                           int n_et, int round_bf16, int shared, int blocks,
                           float* dz_part, float* dwc, float* dz, float* dw,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (shared) {
    const int smem = distmult_fwd::table_bytes(n);
    err = cudaFuncSetAttribute(dm1_bwd<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dm1_bwd<true><<<blocks, BWD_THREADS, smem, s>>>(
        zp, w, src, dst, ct, g, n_chunks, C, n, round_bf16, dz_part, dwc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int count = (n + 1) * D;
    chunk_sums::sum_parts<<<(count + AUX_THREADS - 1) / AUX_THREADS,
                            AUX_THREADS, 0, s>>>(dz_part, blocks, count, dz);
  } else {
    err = cudaMemsetAsync(dz, 0, (size_t)(n + 1) * D * sizeof(float), s);
    if (err != cudaSuccess) return err;
    dm1_bwd<false><<<blocks, BWD_THREADS, 0, s>>>(
        zp, w, src, dst, ct, g, n_chunks, C, n, round_bf16, dz, dwc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_sums::by_relation<<<(n_et * D + AUX_THREADS - 1) / AUX_THREADS,
                            AUX_THREADS, 0, s>>>(dwc, ct, n_chunks, n_et, D, dw);
  return cudaGetLastError();
}
