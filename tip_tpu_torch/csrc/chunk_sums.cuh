// Fixed-order sums shared by the v1 SDDMM kernels (distmult_sddmm_v1.cu,
// nn_sddmm_v1.cu): a block's per-thread partials summed per chunk, the
// per-chunk sums summed per relation over its chunks, and per-block partial
// tables summed over the blocks.  Every sum runs in an order fixed by the
// data, not by the schedule, so these parts of a result are deterministic.

#pragma once

#include <stdint.h>

namespace chunk_sums {

constexpr unsigned FULL = 0xffffffffu;

// out[k] = sum over the block's threads of v[k] (k < W) in a fixed order: a
// shuffle tree inside each warp, then the warps in order.  red holds
// [blockDim.x / 32][W] floats.  Every thread of the block calls it, with a
// blockDim.x that is a multiple of 32.
template <int W>
__device__ void block_sum(const float (&v)[W], float* red,
                          float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(FULL, x, off));
    if (lane == 0) red[warp * W + k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < nwarps; ++q) s = __fadd_rn(s, red[q * W + k]);
    out[k] = s;
  }
  __syncthreads();
}

// dw[t][k] = sum of part[c][k] over the chunks c of relation t, in chunk
// order; rows are W wide.  ct is sorted, so t's chunks are one range, found
// by binary search; a relation that owns no chunk gets 0.
__global__ void by_relation(const float* __restrict__ part,
                            const int32_t* __restrict__ ct, int n_chunks,
                            int n_et, int W, float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_et * W) return;
  const int t = i / W, k = i % W;
  int lo = 0, hi = n_chunks;  // first chunk with ct >= t
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (ct[mid] < t) lo = mid + 1; else hi = mid;
  }
  float s = 0.f;
  for (int c = lo; c < n_chunks && ct[c] == t; ++c)
    s = __fadd_rn(s, part[(size_t)c * W + k]);
  dw[i] = s;
}

// out[i] = sum over b < blocks of part[b * count + i], in b order.
__global__ void sum_parts(const float* __restrict__ part, int blocks,
                          int count, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s = __fadd_rn(s, part[(size_t)b * count + i]);
  out[i] = s;
}

}  // namespace chunk_sums
