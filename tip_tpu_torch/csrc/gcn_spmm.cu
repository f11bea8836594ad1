// Windowed P-P SpMM of the GCN for Hopper (sm_90a): out = A_hat @ x.
//
// Replaces the Pallas TPU kernel of tip_tpu/ops/pallas_segment.py
// (gcn_spmm_padded: _wscatter_kernel, with the x[src] * w gather that the
// JAX package runs outside it fused in):
//   out[win * W + dl, k] = sum_{e in window win, dst_local_e = dl} x[src_e, k] * w_e
// over the buffers of data/packing.py:pad_windowed_edges: src/dst_local/w
// [n_chunks, C], chunk_window [n_chunks] non-decreasing, pad slots with
// dst_local = W and w = 0, every window owning >= 1 chunk.  The last window
// runs past n; its rows >= n are not written.  Each product is rounded to
// float32 (and to bf16 with round_bf16, the JAX package's msgs cast) before
// it is summed, as the plain version does.  The backward of the GCN layer
// is this same kernel on dout, which holds because A_hat is symmetric.
//
// Design.  Inside a window the buffer is sorted by destination (then
// source), so each output row's edges are one contiguous run of slots.
// Block c owns chunk c: it stages the chunk's slots in shared memory,
// lists the slots where a run starts (compact.cuh), and one thread per
// (run, feature) sums the run in slot order, reading on into the window's
// next chunks while the run lasts, and writes the row's feature once.
// Neighbouring threads take neighbouring features of a run, so the x[src]
// reads and the out writes coalesce.  No atomics: the result is
// deterministic.  out is zero-filled first.
//
// Bound on an H100 at Decagon shape (n = 19,081 proteins, d = 32 or 16,
// ~1.31 M slots at window 1024 / chunk 512): it must read src, dst_local and
// w (12 bytes a slot, ~16 MB), x, and write out: ~0.006 ms at 3.35 TB/s;
// its 2 float operations per edge and feature are ~1 % of that at
// 67 TFLOP/s, so bytes bound it.  chip_smoke.py reckons the bound from its
// run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
spmm(const float* __restrict__ x, const int32_t* __restrict__ src,
     const int32_t* __restrict__ dstl, const float* __restrict__ w,
     const int32_t* __restrict__ cw, int n_chunks, int C, int window, int n,
     int d, int round_bf16, float* __restrict__ out) {
  extern __shared__ int smem[];
  int* starts = smem;          // [C] run starts, in slot order
  int* s_src = smem + C;       // [C] this chunk's src
  int* s_dstl = smem + 2 * C;  // [C] this chunk's dst_local
  float* s_w = (float*)(smem + 3 * C);  // [C] this chunk's weights
  __shared__ int warp_tot[THREADS / 32];
  const int c = blockIdx.x;
  const int win = cw[c];
  const size_t base = (size_t)c * C;

  int nr = 0;
  for (int e0 = 0; e0 < C; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    bool f = false;
    if (e < C) {
      const int dl = dstl[base + e];
      s_src[e] = src[base + e];
      s_dstl[e] = dl;
      s_w[e] = w[base + e];
      if (dl < window) {
        if (e > 0)
          f = dstl[base + e - 1] != dl;
        else
          f = c == 0 || cw[c - 1] != win || dstl[base - 1] != dl;
      }
    }
    nr += compact_step(f, e, starts, nr, warp_tot);
  }

  for (int i = threadIdx.x; i < nr * d; i += blockDim.x) {
    const int r = i / d, k = i % d;
    int e = starts[r];
    const int dl = s_dstl[e];
    float s = 0.f;
    for (; e < C && s_dstl[e] == dl; ++e) {
      float m = __fmul_rn(x[(size_t)s_src[e] * d + k], s_w[e]);
      if (round_bf16) m = __bfloat162float(__float2bfloat16_rn(m));
      s = __fadd_rn(s, m);
    }
    if (e == C) {  // the run goes on into the window's next chunks
      for (int cc = c + 1; cc < n_chunks && cw[cc] == win; ++cc) {
        const size_t b = (size_t)cc * C;
        int j = 0;
        for (; j < C && dstl[b + j] == dl; ++j) {
          float m = __fmul_rn(x[(size_t)src[b + j] * d + k], w[b + j]);
          if (round_bf16) m = __bfloat162float(__float2bfloat16_rn(m));
          s = __fadd_rn(s, m);
        }
        if (j < C) break;
      }
    }
    const int row = win * window + dl;
    if (row < n) out[(size_t)row * d + k] = s;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/typed_segment.py).  out:
// [n, d] float32, zero-filled here.  Returns the first CUDA error.
extern "C" int tip_gcn_spmm(const float* x, const int32_t* src,
                            const int32_t* dstl, const float* w,
                            const int32_t* cw, int n_chunks, int C, int window,
                            int n, int d, int round_bf16, float* out,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n * d * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const int smem = 4 * C * (int)sizeof(int);
  err = cudaFuncSetAttribute(spmm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  spmm<<<n_chunks, THREADS, smem, s>>>(x, src, dstl, w, cw, n_chunks, C, window,
                                       n, d, round_bf16, out);
  return cudaGetLastError();
}
