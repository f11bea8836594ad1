// Fixed-order sums shared by the SDDMM backwards that walk lane quads
// (distmult_bwd.cuh for B6 and B8, nn_sddmm_v1.cu for B7): a block's
// per-lane-quad partials summed per chunk, and the per-chunk sums summed
// per relation over its chunks.  Every sum runs in an order fixed by the
// data, not by the schedule, so these parts of a result are deterministic.

#pragma once

#include <stdint.h>

namespace chunk_sums {

constexpr unsigned FULL = 0xffffffffu;

// Partials held by lane quads (quad_walk.cuh's layout): lane q of each
// quad holds features 4q .. 4q + 3 of R rows of 16, v[r] = row r's.
// out[16 r + 4 q + i] = the sum over the block's quads, by a shuffle
// tree over a warp's 8 quads (offsets of 16, 8 and 4 lanes), then the
// warps in order.  red holds [blockDim.x / 32][16 R] floats.  Every thread
// of the block calls it.
template <int R>
__device__ void quad_block_sum(const float4 (&v)[R], float* red,
                               float* __restrict__ out) {
  constexpr int W = 16 * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane & 3;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 16; off >= 4; off >>= 1)
        x[i] = __fadd_rn(x[i], __shfl_down_sync(FULL, x[i], off));
      if (lane < 4) red[warp * W + 16 * r + 4 * q + i] = x[i];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float s = 0.f;
    for (int u = 0; u < nwarps; ++u) s = __fadd_rn(s, red[u * W + k]);
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

}  // namespace chunk_sums
