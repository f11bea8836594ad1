// NN-decoder SDDMM over chunk-aligned typed edges for Hopper (sm_90a):
// one logit per edge slot, forward and backward.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_sddmm2.py
// (nn_logits_padded2: _nn2_fwd_kernel, _nn2_bwd_kernel):
//   logit[c, j] = h1[src] . w1[t] + h2[dst] . w2[t],   t = ct[c]
//   dh1[src] += g w1[t];  dh2[dst] += g w2[t]
//   dw1[t] += g h1[src];  dw2[t] += g h2[dst]
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing.  The wrapper hands in h1p, h2p = h1, h2 with a
// zero row n appended, so a pad slot's dst term is exactly 0; its src term
// is whatever the pad src reads (the caller masks it, as in the JAX
// package).  With round_bf16 (h1, h2 come in bf16-rounded from the
// wrapper) each scattered dh contribution g * w[t][k] is rounded to bf16,
// as the TPU kernel's casts do; accumulation is float32.  The width is 16
// (DR-NN's nn_decoder_l1_dim; the wrapper refuses others).
//
// Design.  w1[t] and w2[t] are constant over a relation's chunks, so both
// directions factor through per-(relation, node) scalars:
//   forward:  nn_scores writes the scores s1_t[v] = h1p[v] . w1[t] and
//             s2_t[v] = h2p[v] . w2[t] of every relation and node into an
//             [n_et][2][n + 1] table (each thread keeps its node's two rows
//             in registers over a group of relations); nn_gather then reads
//             logit = s1_t[src] + s2_t[dst] per slot from that table, which
//             L2 holds (9.8 MB at 1,536 nodes x 800 relations) -- two
//             scalar reads a slot instead of two 16-float rows;
//   backward: one block per relation t (its chunks are a contiguous range
//             of the sorted chunk_type) sums g by endpoint, G1[t][v] over
//             the slots with src = v and G2[t][v] over dst = v (one scalar
//             add a slot and side; a warp whose slots share a dst, as the
//             dst-sorted positives do, sums its run with a segmented
//             shuffle scan first); then dw1[t] = G1[t] . h1, dh1 = sum_t
//             G1[t] (x) w1[t] and the same for side 2 are fixed-order
//             contractions (contract.cuh).  With round_bf16 the per-slot
//             rounding does not factor: dh takes 16 float atomics a slot
//             and side into device memory instead.
// The backward's two sum vectors, 2 (n + 1) floats, sit in shared memory up
// to 29,055 nodes (the "shared" mode) and are added straight into the
// device-memory table beyond (the "global" mode).  No gathered endpoint
// rows are saved for the backward (the TPU kernel keeps two [n_chunks, 16,
// C] residuals).  The forward is deterministic; G adds atomically, so the
// backward is not bit-for-bit deterministic.
//
// Bound on an H100 at the chunked path's shape (6.94 M slots, 1,536 drugs
// x 800 relations): the forward must read src and dst and write the logit,
// 12 bytes a slot (83 MB, ~0.025 ms at 3.35 TB/s); the backward reads src,
// dst and g, 12 bytes a slot.  The 4 x 16 float operations a slot of the
// per-slot formula take ~0.007 ms at 67 TFLOP/s, so bytes bound both ways.
// chip_smoke.py reckons the bounds from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "contract.cuh"

namespace {

constexpr int D = 16;
constexpr int THREADS = 512;
constexpr int SCATTER_THREADS = 256;
constexpr int SCORE_THREADS = 128;
constexpr int SCORE_RELS = 16;  // relations per nn_scores block
constexpr unsigned FULL = 0xffffffffu;

// first chunk c with ct[c] >= t (ct sorted)
__device__ __forceinline__ int first_chunk(const int32_t* __restrict__ ct,
                                           int n_chunks, int t) {
  int lo = 0, hi = n_chunks;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (ct[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float dot16(const float* __restrict__ a,
                                       const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) s = fmaf(a[k], b[k], s);
  return s;
}

// acc[key] += v for every active lane.  Where the warp's active keys are
// non-decreasing across lanes, each run of equal keys is summed with a
// segmented shuffle scan and added once by its last lane; otherwise each
// lane adds its own.  All lanes of the warp must call it.
__device__ __forceinline__ void add_runs(float* acc, int key, float v,
                                         bool act) {
  const int lane = threadIdx.x & 31;
  const int k = act ? key : INT_MAX;
  const int prev = __shfl_up_sync(FULL, k, 1);
  if (__all_sync(FULL, lane == 0 || prev <= k)) {
    const unsigned seg = __match_any_sync(FULL, k);
    const int head = __ffs(seg) - 1, tail = 31 - __clz(seg);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, v, off);
      if (lane - off >= head) v = __fadd_rn(v, o);
    }
    if (act && lane == tail) atomicAdd(&acc[key], v);
  } else if (act) {
    atomicAdd(&acc[key], v);
  }
}

// grid (ceil((n + 1) / SCORE_THREADS), ceil(n_et / SCORE_RELS)): thread v
// writes scores[t][0][v] = h1p[v] . w1[t] and scores[t][1][v] = h2p[v] .
// w2[t] for the block's relations t.
__global__ void __launch_bounds__(SCORE_THREADS)
nn_scores(const float* __restrict__ h1p, const float* __restrict__ h2p,
          const float* __restrict__ w1, const float* __restrict__ w2, int n,
          int n_et, float* __restrict__ scores) {
  const int v = blockIdx.x * SCORE_THREADS + threadIdx.x;
  if (v > n) return;
  float a[D], b[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    a[k] = h1p[(size_t)v * D + k];
    b[k] = h2p[(size_t)v * D + k];
  }
  const int t1 = min(n_et, (blockIdx.y + 1) * SCORE_RELS);
  for (int t = blockIdx.y * SCORE_RELS; t < t1; ++t) {
    float* row = scores + (size_t)t * 2 * (n + 1);
    row[v] = dot16(w1 + (size_t)t * D, a);
    row[n + 1 + v] = dot16(w2 + (size_t)t * D, b);
  }
}

// Persistent blocks walk the chunks: logit = s1_t[src] + s2_t[dst].
__global__ void __launch_bounds__(THREADS)
nn_gather(const float* __restrict__ scores, const int32_t* __restrict__ src,
          const int32_t* __restrict__ dst, const int32_t* __restrict__ ct,
          int n_chunks, int C, int n, float* __restrict__ out) {
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const float* s1 = scores + (size_t)ct[c] * 2 * (n + 1);
    const float* s2 = s1 + (n + 1);
    const size_t base = (size_t)c * C;
    for (int j = threadIdx.x; j < C; j += THREADS)
      out[base + j] = __fadd_rn(s1[src[base + j]], s2[dst[base + j]]);
  }
}

// grid: n_et blocks.  Writes G1 = gs[t][0][:] and G2 = gs[t][1][:] (n + 1
// entries each; entry n of G2 collects the pad slots).  Global mode adds
// into gs, zeroed by the caller.
template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
nn_gsum(const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
        const int32_t* __restrict__ ct, const float* __restrict__ g,
        int n_chunks, int C, int n, float* __restrict__ gs) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int c0 = first_chunk(ct, n_chunks, t);
  const int c1 = first_chunk(ct, n_chunks, t + 1);
  const int len = 2 * (n + 1);
  float* out = gs + (size_t)t * len;
  float* a1 = SHARED ? smem : out;
  float* a2 = a1 + (n + 1);
  if (SHARED) {
    for (int v = threadIdx.x; v < len; v += THREADS) a1[v] = 0.f;
    __syncthreads();
  }
  const size_t end = (size_t)c1 * C;
  for (size_t base = (size_t)c0 * C; base < end; base += THREADS) {  // whole warps
    const size_t e = base + threadIdx.x;
    const bool act = e < end;
    const int s = act ? src[e] : 0;
    const int d = act ? dst[e] : n;
    const float gv = act ? g[e] : 0.f;
    if (act) atomicAdd(&a1[s], gv);
    add_runs(a2, d, gv, act);
  }
  if (SHARED) {
    __syncthreads();
    for (int v = threadIdx.x; v < len; v += THREADS) out[v] = a1[v];
  }
}

// round_bf16 mode: dh1[src] += bf16(g * w1[t]), dh2[dst] += bf16(g * w2[t])
// into zeroed [n + 1][16] accumulators (row n collects the pad slots).
// Persistent blocks walk the chunks.
__global__ void __launch_bounds__(SCATTER_THREADS)
nn_scatter_bf16(const float* __restrict__ w1, const float* __restrict__ w2,
                const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
                const int32_t* __restrict__ ct, const float* __restrict__ g,
                int n_chunks, int C, int n, float* __restrict__ dh1,
                float* __restrict__ dh2) {
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int t = ct[c];
    const size_t base = (size_t)c * C;
    for (int j0 = 0; j0 < C; j0 += SCATTER_THREADS) {  // uniform: whole warps
      const int j = j0 + threadIdx.x;
      const bool act = j < C;
      const int s = act ? src[base + j] : 0;
      const int d = act ? dst[base + j] : n;
      const float gv = act ? g[base + j] : 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float c1 = __bfloat162float(__float2bfloat16_rn(
            __fmul_rn(gv, w1[(size_t)t * D + k])));
        const float c2 = __bfloat162float(__float2bfloat16_rn(
            __fmul_rn(gv, w2[(size_t)t * D + k])));
        if (act) atomicAdd(&dh1[(size_t)s * D + k], c1);
        add_runs(dh2 + k, d * D, c2, act);
      }
    }
  }
}

int vec_bytes(int n) { return 2 * (n + 1) * (int)sizeof(float); }

}  // namespace

// Plain C entry points (bound with ctypes by ops/sddmm2.py).  h1p, h2p
// [n + 1][16] (h1, h2 with a zero row appended), w1, w2 [n_et][16] float32;
// src, dst [n_chunks][C], ct [n_chunks] int32.  Each returns the first CUDA
// error.

// scores: scratch [n_et][2][n + 1]; out [n_chunks][C] float32; blocks: the
// gather grid.
extern "C" int tip_nn_fwd(const float* h1p, const float* h2p, const float* w1,
                          const float* w2, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, int n_chunks,
                          int C, int n, int n_et, int blocks, float* scores,
                          float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + SCORE_THREADS) / SCORE_THREADS,
                  (n_et + SCORE_RELS - 1) / SCORE_RELS);
  nn_scores<<<grid, SCORE_THREADS, 0, s>>>(h1p, h2p, w1, w2, n, n_et, scores);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_gather<<<blocks, THREADS, 0, s>>>(scores, src, dst, ct, n_chunks, C, n,
                                       out);
  return cudaGetLastError();
}

// `shared` picks where the backward's per-relation sum vectors live (the
// wrapper checks that they fit).
// g [n_chunks][C]; scratch gs [n_et][2][n + 1]; outputs dw1, dw2 [n_et][16]
// and dh1, dh2 [n + 1][16] (row n is scratch).  blocks: the scatter grid
// of the round_bf16 mode.
extern "C" int tip_nn_bwd(const float* h1p, const float* h2p, const float* w1,
                          const float* w2, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, const float* g,
                          int n_chunks, int C, int n, int n_et, int round_bf16,
                          int shared, int blocks, float* gs, float* dw1,
                          float* dw2, float* dh1, float* dh2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const int len = 2 * (n + 1);
  if (shared) {
    const int smem = vec_bytes(n);
    err = cudaFuncSetAttribute(nn_gsum<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    nn_gsum<true><<<n_et, THREADS, smem, s>>>(src, dst, ct, g, n_chunks, C, n,
                                              gs);
  } else {
    err = cudaMemsetAsync(gs, 0, (size_t)n_et * len * sizeof(float), s);
    if (err != cudaSuccess) return err;
    nn_gsum<false><<<n_et, THREADS, 0, s>>>(src, dst, ct, g, n_chunks, C, n,
                                            gs);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const float* g1 = gs;
  const float* g2 = gs + (n + 1);
  if (!round_bf16) {
    err = contract::both(g1, len, h1p, w1, n_et, n, dw1, dh1, s);
    if (err != cudaSuccess) return err;
    return contract::both(g2, len, h2p, w2, n_et, n, dw2, dh2, s);
  }
  if ((err = contract::rows(g1, len, h1p, n_et, n, dw1, s)) != cudaSuccess)
    return err;
  if ((err = contract::rows(g2, len, h2p, n_et, n, dw2, s)) != cudaSuccess)
    return err;
  err = cudaMemsetAsync(dh1, 0, (size_t)(n + 1) * D * sizeof(float), s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dh2, 0, (size_t)(n + 1) * D * sizeof(float), s);
  if (err != cudaSuccess) return err;
  nn_scatter_bf16<<<blocks, SCATTER_THREADS, 0, s>>>(w1, w2, src, dst, ct, g,
                                                     n_chunks, C, n, dh1, dh2);
  return cudaGetLastError();
}
