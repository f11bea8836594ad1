// The counter hash that draws a cell's 24 uniform bits in the fused dense
// BCE kernels dense_bce_sym.cu (B1), dense_bce.cu (B2) and dense_bce_nn.cu
// (B3).  ops/dense_bce_sym.py (mix32, u24_field) computes the same
// function in PyTorch, so every kernel and its plain version see the same
// negative counts.  The cell's softplus and sigmoid are tile_math.cuh's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bce_cell {

// 32-bit integer mixer (lowbias32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t relation_key(uint32_t seed, uint32_t t) {
  return mix32(seed + mix32(t + 0x9e3779b9U));
}

// 24 uniform bits for a cell of relation t's plane, cell = row * stride +
// col (stride: the padded strip extent for B1, n for B2 and B3).
__device__ __forceinline__ int cell_u24(uint32_t key, uint32_t cell) {
  return (int)(mix32(key ^ mix32(cell)) >> 8);
}

}  // namespace bce_cell
