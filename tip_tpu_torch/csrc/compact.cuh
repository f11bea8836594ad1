// Order-preserving block-wide compaction of the run-sum kernel gcn_spmm.cu.
#pragma once

#include <cuda_runtime.h>

// One step of the compaction: every thread of the block (blockDim.x a
// multiple of 32) passes its flag for item e; flagged items are written to
// list[base + rank] in thread order.  All threads must call it; it returns
// the number of flags set in this step, the same value in every thread.
// warp_tot holds blockDim.x / 32 ints of shared memory.
__device__ __forceinline__ int compact_step(bool f, int e, int* list, int base,
                                            int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, f);
  if (lane == 0) warp_tot[warp] = __popc(m);
  __syncthreads();
  int off = base, tot = 0;
  for (int w = 0; w < nwarps; ++w) {
    if (w < warp) off += warp_tot[w];
    tot += warp_tot[w];
  }
  if (f) list[off + __popc(m & ((1u << lane) - 1u))] = e;
  __syncthreads();
  return tot;
}
