// Typed neighbour sum of the chunked R-GCN for Hopper (sm_90a), forward and
// backward.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_segment.py
// (typed_neighbor_sum_padded_t: _tns_fwd_kernel, _tns_bwd_kernel):
//   forward   P^T[t, k, d] = sum_{e in relation t, dst_e = d} x[src_e, k]
//   backward  dx[s, k]     = sum_t sum_{e in t, src_e = s} dP^T[t, k, dst_e]
// over the chunk-aligned buffers of data/packing.py:pad_typed_edges:
// src/dst [n_chunks, C] int32, chunk_type [n_chunks] non-decreasing, pad
// slots with dst = n (and src = 0), every relation owning >= 1 chunk.  The
// output keeps the JAX package's transposed [n_et, d, n] layout.
//
// The TPU kernels gather and scatter with one-hot matmuls, since the TPU
// has no fast scatter; a GPU gathers and scatters natively, so nothing of
// that is carried over.
//
// Forward design.  Inside a relation the buffer is sorted by dst, so the
// edges into (t, d) are one contiguous run of slots.  Block c owns chunk c:
// it stages the chunk's src and dst in shared memory, lists, in slot order,
// the slots where a run starts (compact.cuh), and one thread per (run,
// feature) sums the run in slot order, reading on into the relation's next
// chunks while the run lasts.  A run that begins in an earlier chunk
// belongs to that chunk's block.  No atomics: the result is deterministic.
// The sums go through shared memory in batches of runs: neighbouring
// threads sum neighbouring features of one run (each x row is read whole)
// and store neighbouring runs of one feature (the strided [t, k, :] writes
// fall on neighbouring destinations).  P^T is zero-filled first
// (destinations without edges).
//
// Backward design.  src is not sorted, so the scatter needs atomics.  A
// block owns a contiguous range of chunks and one slice of the features,
// and accumulates dx[:, slice] in shared memory ([n][slice + 1] floats: the
// odd row stride spreads the random rows over the banks).  A thread takes
// one slot and adds its dP^T column into the slot's src row, feature by
// feature; neighbouring threads hold neighbouring slots, so the dP^T reads
// at the dst-sorted destinations coalesce.  Each block writes its partial
// dx, and a second pass sums the partials in block order.  Where not even
// an 8-feature slice fits (n > 6,456), the blocks add straight into a
// zeroed global dx instead (the wrapper picks).  Atomics add in no fixed
// order, so the backward is not bit-for-bit deterministic.
//
// Bound on an H100 at Decagon shape, layer 1 (d = 64, ~9.0 M slots in
// ~8.8 k chunks, n = 645, 1,097 relations): the forward must read the
// indices (72 MB) and write P^T (181 MB), ~0.076 ms at 3.35 TB/s; its
// 0.54 G float adds take 0.008 ms at 67 TFLOP/s, so bytes bound it; the
// backward reads the same bytes the other way.  chip_smoke.py reckons the
// bound from its run.  This first version still stores P^T a run at a time
// (one 4-byte store per run and feature) and zero-fills it in a separate
// pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"

namespace {

constexpr int FWD_THREADS = 256;
constexpr int RUNS = 64;  // runs whose sums the forward stages at a time
constexpr int BWD_THREADS = 1024;
constexpr int SUM_THREADS = 256;

__global__ void __launch_bounds__(FWD_THREADS)
tns_fwd(const float* __restrict__ x, const int32_t* __restrict__ src,
        const int32_t* __restrict__ dst, const int32_t* __restrict__ ct,
        int n_chunks, int C, int n, int d, float* __restrict__ out) {
  extern __shared__ int smem[];
  int* starts = smem;         // [C] run starts, in slot order
  int* s_src = smem + C;      // [C] this chunk's src
  int* s_dst = smem + 2 * C;  // [C] this chunk's dst
  float* sums = (float*)(smem + 3 * C);  // [RUNS][d + 1] a batch of run sums
  __shared__ int warp_tot[FWD_THREADS / 32];
  const int c = blockIdx.x;
  const int t = ct[c];
  const size_t base = (size_t)c * C;

  int nr = 0;
  for (int e0 = 0; e0 < C; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    bool f = false;
    if (e < C) {
      const int dv = dst[base + e];
      s_src[e] = src[base + e];
      s_dst[e] = dv;
      if (dv < n) {
        if (e > 0)
          f = dst[base + e - 1] != dv;
        else
          f = c == 0 || ct[c - 1] != t || dst[base - 1] != dv;
      }
    }
    nr += compact_step(f, e, starts, nr, warp_tot);
  }

  for (int r0 = 0; r0 < nr; r0 += RUNS) {
    const int rb = min(RUNS, nr - r0);
    // sums: neighbouring threads take neighbouring features of one run, so
    // each x row is read whole
    for (int i = threadIdx.x; i < rb * d; i += blockDim.x) {
      const int rr = i / d, k = i % d;
      int e = starts[r0 + rr];
      const int dv = s_dst[e];
      int end = e + 1;
      while (end < C && s_dst[end] == dv) ++end;
      float s = 0.f;
#pragma unroll 4
      for (; e < end; ++e) s = __fadd_rn(s, x[(size_t)s_src[e] * d + k]);
      if (end == C) {  // the run goes on into the relation's next chunks
        for (int cc = c + 1; cc < n_chunks && ct[cc] == t; ++cc) {
          const size_t b = (size_t)cc * C;
          int j = 0;
          for (; j < C && dst[b + j] == dv; ++j)
            s = __fadd_rn(s, x[(size_t)src[b + j] * d + k]);
          if (j < C) break;
        }
      }
      sums[rr * (d + 1) + k] = s;
    }
    __syncthreads();
    // writes: neighbouring threads take neighbouring runs of one feature,
    // so the stores fall on neighbouring destinations of P^T[t, k, :]
    for (int i = threadIdx.x; i < rb * d; i += blockDim.x) {
      const int k = i / rb, rr = i % rb;
      out[((size_t)t * d + k) * n + s_dst[starts[r0 + rr]]] = sums[rr * (d + 1) + k];
    }
    __syncthreads();
  }
}

// shared: accumulates dx[:, k0 : k0 + kslice] in shared memory and writes
// it to this block's partial part[blockIdx.x] ([n][d]); global (kslice = d,
// one slice): adds into part itself, the zeroed dx [n][d].
template <bool SHARED>
__global__ void __launch_bounds__(BWD_THREADS)
tns_bwd(const float* __restrict__ dpt, const int32_t* __restrict__ src,
        const int32_t* __restrict__ dst, const int32_t* __restrict__ ct,
        int n_chunks, int C, int n, int d, int kslice,
        float* __restrict__ part) {
  extern __shared__ float acc_smem[];  // shared: [n][kslice + 1]
  const int ks1 = SHARED ? kslice + 1 : d;  // row stride of the accumulator
  const int k0 = blockIdx.y * kslice;
  float* acc = part;
  if (SHARED) {
    acc = acc_smem;
    for (int i = threadIdx.x; i < n * ks1; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();
  }

  const int per = (n_chunks + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per;
  const int c1 = min(n_chunks, c0 + per);
  for (int c = c0; c < c1; ++c) {
    const float* dp = dpt + ((size_t)ct[c] * d + k0) * n;
    const size_t base = (size_t)c * C;
    for (int e = threadIdx.x; e < C; e += blockDim.x) {
      const int dv = dst[base + e];
      if (dv >= n) continue;
      float* row = acc + (size_t)src[base + e] * ks1;
      for (int k8 = 0; k8 < kslice; k8 += 8) {  // 8 loads in flight
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = k8 + u < kslice ? dp[(size_t)(k8 + u) * n + dv] : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (k8 + u < kslice) atomicAdd(&row[k8 + u], v[u]);
      }
    }
  }
  if (!SHARED) return;
  __syncthreads();

  float* out = part + (size_t)blockIdx.x * n * d;
  for (int i = threadIdx.x; i < n * kslice; i += blockDim.x) {
    const int s = i / kslice, kk = i % kslice;
    out[(size_t)s * d + k0 + kk] = acc[s * ks1 + kk];
  }
}

// out[i] = sum over g of part[g][i], in g order.
__global__ void sum_parts(const float* __restrict__ part, int groups,
                          int count, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += part[(size_t)g * count + i];
  out[i] = s;
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/typed_segment.py).  Each
// returns the first CUDA error.

// out: [n_et, d, n] float32, zero-filled here.
extern "C" int tip_tns_fwd(const float* x, const int32_t* src,
                           const int32_t* dst, const int32_t* ct, int n_chunks,
                           int C, int n, int d, int n_et, float* out,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)n_et * d * n * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const int smem = (3 * C + RUNS * (d + 1)) * (int)sizeof(int);
  err = cudaFuncSetAttribute(tns_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  tns_fwd<<<n_chunks, FWD_THREADS, smem, s>>>(x, src, dst, ct, n_chunks, C, n,
                                               d, out);
  return cudaGetLastError();
}

// part: [groups, n, d] float32 scratch; dx: [n, d].  kslice > 0: it
// divides d and n * (kslice + 1) floats fit a block's shared memory;
// kslice = 0: no shared accumulator, the blocks add into dx (part unused).
extern "C" int tip_tns_bwd(const float* dpt, const int32_t* src,
                           const int32_t* dst, const int32_t* ct, int n_chunks,
                           int C, int n, int d, int kslice, int groups,
                           float* part, float* dx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (kslice == 0) {
    err = cudaMemsetAsync(dx, 0, (size_t)n * d * sizeof(float), s);
    if (err != cudaSuccess) return err;
    tns_bwd<false><<<groups, BWD_THREADS, 0, s>>>(dpt, src, dst, ct, n_chunks,
                                                   C, n, d, d, dx);
    return cudaGetLastError();
  }
  const int smem = n * (kslice + 1) * (int)sizeof(float);
  err = cudaFuncSetAttribute(tns_bwd<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tns_bwd<true><<<dim3(groups, d / kslice), BWD_THREADS, smem, s>>>(
      dpt, src, dst, ct, n_chunks, C, n, d, kslice, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int count = n * d;
  sum_parts<<<(count + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, s>>>(
      part, groups, count, dx);
  return cudaGetLastError();
}
