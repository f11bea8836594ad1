// The NN-decoder SDDMM forward over chunk-aligned typed edges, shared by
// the v2 kernel B9 (nn_sddmm.cu) and the v1 kernel B7 (nn_sddmm_v1.cu): the
// two TPU kernels' forwards compute the same logits, pads included (they
// differ only in where their backwards round to bf16), so one CUDA forward
// serves both, and B7's logits are B9's bit for bit.
//   logit[c, j] = h1[src] . w1[t] + h2[dst] . w2[t],   t = ct[c]
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing, C a multiple of 4.  Node id n scores 0, so a
// pad slot's dst term is exactly 0; its src term is whatever the pad src
// reads (the caller masks it).  Each score is dot16's chain of fmaf in k
// order, and a logit is the sum of its two scores.
//
// The work is cut into items: runs of at most ITEM_CHUNKS chunks of one
// relation, a relation of m chunks into ceil(m / ITEM_CHUNKS) near-equal
// runs.  nn_plan (one block) lists them from chunk_type on every call:
// items[i] = (t, first chunk, end chunk), rel_items[t] = t's first item
// (nn_sddmm.cu's backward walks the same items).  Two modes, picked by the
// caller:
//   shared (n <= 29,055: 2 (n + 1) floats): a block takes an item, builds
//     the relation's two score rows s1[v] = h1[v] . w1[t] and s2[v] =
//     h2[v] . w2[t] (v <= n) in shared memory, and writes logit = s1[src]
//     + s2[dst] for the item's slots, 16 bytes of src, dst and logits a
//     thread;
//   global (any n): nn_scores writes an [n_et][2][n + 1] table of every
//     score, and persistent blocks gather two scalars a slot from it.
// The two modes give the same logits bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nn_fwd {

constexpr int D = 16;
constexpr int ITEM_CHUNKS = 16;  // ops/sddmm2.py: ITEM_CHUNKS
constexpr int PLAN_THREADS = 1024;
constexpr int FWD_THREADS = 256;
constexpr int SCORE_THREADS = 128;  // global mode
constexpr int SCORE_RELS = 16;      // relations per nn_scores block
constexpr int GATHER_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dot16(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) s = fmaf(a[k], b[k], s);
  return s;
}

// w . h[v] for v < n, 0 for the pad id n (what a zero row gives)
__device__ __forceinline__ float score(const float* w,
                                       const float* __restrict__ h, int v,
                                       int n) {
  if (v >= n) return 0.f;
  float a[D];
  const float4* r = reinterpret_cast<const float4*>(h + (size_t)v * D);
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const float4 x = __ldg(r + q);
    a[4 * q] = x.x, a[4 * q + 1] = x.y, a[4 * q + 2] = x.z, a[4 * q + 3] = x.w;
  }
  return dot16(w, a);
}

// One block of PLAN_THREADS.  start (shared, n_et + 1 ints): relation t's
// first chunk; relation t gets p_t = ceil(m_t / ITEM_CHUNKS) items, item j
// the chunks [start + j m_t / p_t, start + (j + 1) m_t / p_t).
__global__ void __launch_bounds__(PLAN_THREADS)
nn_plan(const int32_t* __restrict__ ct, int n_chunks, int n_et, int max_items,
        int4* __restrict__ items, int32_t* __restrict__ rel_items) {
  extern __shared__ int start[];
  __shared__ int warp_tot[PLAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int last = n_chunks > 0 ? ct[n_chunks - 1] : -1;
  for (int t = tid; t <= n_et; t += PLAN_THREADS)
    if (t > last || t == n_et) start[t] = n_chunks;
  for (int c0 = tid; c0 < n_chunks; c0 += 8 * PLAN_THREADS) {
    int cur[8], prv[8];  // eight chunks' loads in flight a thread
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u * PLAN_THREADS;
      cur[u] = c < n_chunks ? ct[c] : -1;
      prv[u] = c > 0 && c < n_chunks ? ct[c - 1] : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u * PLAN_THREADS;
      for (int t = max(prv[u] + 1, 0); t <= min(cur[u], n_et - 1); ++t)
        start[t] = c;
    }
  }
  __syncthreads();
  // each thread a contiguous range of relations; exclusive scan of p_t
  const int per = (n_et + PLAN_THREADS - 1) / PLAN_THREADS;
  const int t0 = min(n_et, tid * per), t1 = min(n_et, t0 + per);
  int mine = 0;
  for (int t = t0; t < t1; ++t)
    mine += (start[t + 1] - start[t] + ITEM_CHUNKS - 1) / ITEM_CHUNKS;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int off = incl - mine;
  for (int w = 0; w < warp; ++w) off += warp_tot[w];
  for (int t = t0; t < t1; ++t) {
    const int s = start[t], m = start[t + 1] - s;
    const int p = (m + ITEM_CHUNKS - 1) / ITEM_CHUNKS;
    rel_items[t] = min(off, max_items);
    for (int j = 0; j < p && off + j < max_items; ++j)
      items[off + j] = make_int4(t, s + (int)((long long)j * m / p),
                                 s + (int)((long long)(j + 1) * m / p), 0);
    off += p;
  }
  if (tid == PLAN_THREADS - 1) rel_items[n_et] = min(off, max_items);
}

// Shared mode: block b takes item b (if there is one); out [n_chunks * C].
__global__ void __launch_bounds__(FWD_THREADS)
nn_fwd_items(const int4* __restrict__ items,
             const int32_t* __restrict__ rel_items, int n_et,
             const float* __restrict__ h1, const float* __restrict__ h2,
             const float* __restrict__ w1, const float* __restrict__ w2,
             const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             int C, int n, float* __restrict__ out) {
  extern __shared__ float s1[];  // [n + 1], then s2 [n + 1]
  float* s2 = s1 + (n + 1);
  if ((int)blockIdx.x >= rel_items[n_et]) return;
  const int4 it = items[blockIdx.x];
  float wa[D], wb[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    wa[k] = __ldg(w1 + (size_t)it.x * D + k);
    wb[k] = __ldg(w2 + (size_t)it.x * D + k);
  }
  for (int v = threadIdx.x; v <= n; v += FWD_THREADS) {
    s1[v] = score(wa, h1, v, n);
    s2[v] = score(wb, h2, v, n);
  }
  __syncthreads();
  const int4* s4 = reinterpret_cast<const int4*>(src);
  const int4* d4 = reinterpret_cast<const int4*>(dst);
  float4* o4 = reinterpret_cast<float4*>(out);
  const size_t e1 = (size_t)it.z * C / 4;
  for (size_t e = (size_t)it.y * C / 4 + threadIdx.x; e < e1;
       e += FWD_THREADS) {
    const int4 a = s4[e], b = d4[e];
    o4[e] = make_float4(
        __fadd_rn(s1[a.x], s2[b.x]), __fadd_rn(s1[a.y], s2[b.y]),
        __fadd_rn(s1[a.z], s2[b.z]), __fadd_rn(s1[a.w], s2[b.w]));
  }
}

// Global mode, grid (ceil((n + 1) / SCORE_THREADS), ceil(n_et /
// SCORE_RELS)): scores[t][0][v] = s1_t[v], scores[t][1][v] = s2_t[v].
__global__ void __launch_bounds__(SCORE_THREADS)
nn_scores(const float* __restrict__ h1, const float* __restrict__ h2,
          const float* __restrict__ w1, const float* __restrict__ w2, int n,
          int n_et, float* __restrict__ scores) {
  const int v = blockIdx.x * SCORE_THREADS + threadIdx.x;
  if (v > n) return;
  const int t1 = min(n_et, (blockIdx.y + 1) * SCORE_RELS);
  for (int t = blockIdx.y * SCORE_RELS; t < t1; ++t) {
    float* row = scores + (size_t)t * 2 * (n + 1);
    row[v] = score(w1 + (size_t)t * D, h1, v, n);
    row[n + 1 + v] = score(w2 + (size_t)t * D, h2, v, n);
  }
}

// Global mode: persistent blocks walk the chunks, logit = s1_t[src] +
// s2_t[dst] from the score table.
__global__ void __launch_bounds__(GATHER_THREADS)
nn_gather(const float* __restrict__ scores, const int32_t* __restrict__ src,
          const int32_t* __restrict__ dst, const int32_t* __restrict__ ct,
          int n_chunks, int C, int n, float* __restrict__ out) {
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const float* s1 = scores + (size_t)ct[c] * 2 * (n + 1);
    const float* s2 = s1 + (n + 1);
    const size_t base = (size_t)c * C;
    for (int j = threadIdx.x; j < C; j += GATHER_THREADS)
      out[base + j] = __fadd_rn(s1[src[base + j]], s2[dst[base + j]]);
  }
}

inline cudaError_t plan(const int32_t* ct, int n_chunks, int n_et, int max_items,
                 int4* items, int32_t* rel_items, cudaStream_t s) {
  nn_plan<<<1, PLAN_THREADS, (n_et + 1) * sizeof(int), s>>>(
      ct, n_chunks, n_et, max_items, items, rel_items);
  return cudaGetLastError();
}

// The forward: `shared` picks the mode (the caller checks that the score
// rows fit); items [max_items] int4 and rel_items [n_et + 1] the shared
// mode's plan (max_items >= the items' count), scores [n_et][2][n + 1] the
// global mode's table (null in the other mode); blocks: the global mode's
// gather grid; out [n_chunks][C].  h1, h2 16-byte aligned; src, dst too in
// the shared mode.
inline cudaError_t launch(const float* h1, const float* h2, const float* w1,
                          const float* w2, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, int n_chunks,
                          int C, int n, int n_et, int shared, int max_items,
                          int blocks, int4* it, int32_t* rel_items,
                          float* scores, float* out, cudaStream_t s) {
  cudaError_t err;
  if (!shared) {
    const dim3 grid((n + SCORE_THREADS) / SCORE_THREADS,
                    (n_et + SCORE_RELS - 1) / SCORE_RELS);
    nn_scores<<<grid, SCORE_THREADS, 0, s>>>(h1, h2, w1, w2, n, n_et, scores);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    nn_gather<<<blocks, GATHER_THREADS, 0, s>>>(scores, src, dst, ct, n_chunks,
                                                C, n, out);
    return cudaGetLastError();
  }
  if ((err = plan(ct, n_chunks, n_et, max_items, it, rel_items, s)) !=
      cudaSuccess)
    return err;
  const int smem = 2 * (n + 1) * (int)sizeof(float);
  err = cudaFuncSetAttribute(nn_fwd_items,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (max_items > 0)
    nn_fwd_items<<<max_items, FWD_THREADS, smem, s>>>(
        it, rel_items, n_et, h1, h2, w1, w2, src, dst, C, n, out);
  return cudaGetLastError();
}

}  // namespace nn_fwd
