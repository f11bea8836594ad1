// Fixed-order contractions of a per-(relation, node) table A with the
// NN decoder's 16-wide rows, shared by dense_bce_nn.cu (A = the row and
// column sums of the cotangent tile) and nn_sddmm.cu (A = the cotangent
// summed per (relation, endpoint)):
//   rows_dot: out[t][k] = sum_j A[t][j] * X[j][k]
//   cols_dot: out[j][k] = sum_t A[t][j] * W[t][k]
// A is row-major with row stride lda >= n.  Each output is split over
// LANES threads that sum strided parts of the index in order, and the
// parts are added in lane order through shared memory: deterministic.
#pragma once

#include <cuda_runtime.h>

namespace contract {

constexpr int D = 16;      // the rows' width
constexpr int LANES = 16;  // threads that split one output's sum
constexpr int COLS_J = 32; // nodes per cols_dot block

// one block per relation t; thread (k = x, lane = y) sums j = lane + 16 i
__global__ void __launch_bounds__(D * LANES)
rows_dot(const float* __restrict__ A, int lda, const float* __restrict__ X,
         int n, float* __restrict__ out) {
  __shared__ float part[LANES][D];
  const int k = threadIdx.x, lane = threadIdx.y, t = blockIdx.x;
  const float* a = A + (size_t)t * lda;
  float s = 0.f;
  for (int j = lane; j < n; j += LANES) s = fmaf(a[j], X[(size_t)j * D + k], s);
  part[lane][k] = s;
  __syncthreads();
  if (lane == 0) {
    float r = 0.f;
    for (int l = 0; l < LANES; ++l) r += part[l][k];
    out[(size_t)t * D + k] = r;
  }
}

// one block per COLS_J nodes; thread (x = node, y = lane) keeps the 16
// sums of its node over t = lane + 16 i
__global__ void __launch_bounds__(COLS_J * LANES)
cols_dot(const float* __restrict__ A, int lda, const float* __restrict__ W,
         int R, int n, float* __restrict__ out) {
  __shared__ float part[LANES][COLS_J][D + 1];
  const int jl = threadIdx.x, lane = threadIdx.y;
  const int j = blockIdx.x * COLS_J + jl;
  float s[D];
#pragma unroll
  for (int k = 0; k < D; ++k) s[k] = 0.f;
  if (j < n) {
    for (int t = lane; t < R; t += LANES) {
      const float a = A[(size_t)t * lda + j];
#pragma unroll
      for (int k = 0; k < D; ++k) s[k] = fmaf(a, W[(size_t)t * D + k], s[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) part[lane][jl][k] = s[k];
  __syncthreads();
  // COLS_J * D outputs over COLS_J * LANES threads
  for (int o = lane * COLS_J + jl; o < COLS_J * D; o += COLS_J * LANES) {
    const int oj = o / D, ok = o % D;
    if (blockIdx.x * COLS_J + oj >= n) continue;
    float r = 0.f;
    for (int l = 0; l < LANES; ++l) r += part[l][oj][ok];
    out[(size_t)(blockIdx.x * COLS_J + oj) * D + ok] = r;
  }
}

inline cudaError_t rows(const float* A, int lda, const float* X, int R, int n,
                        float* out, cudaStream_t s) {
  rows_dot<<<R, dim3(D, LANES), 0, s>>>(A, lda, X, n, out);
  return cudaGetLastError();
}

inline cudaError_t cols(const float* A, int lda, const float* W, int R, int n,
                        float* out, cudaStream_t s) {
  cols_dot<<<(n + COLS_J - 1) / COLS_J, dim3(COLS_J, LANES), 0, s>>>(
      A, lda, W, R, n, out);
  return cudaGetLastError();
}

// out = A . X (rows_dot) into outW [R][16] and A^T . W (cols_dot) into
// outH [n][16], on one stream; returns the first launch error.
inline cudaError_t both(const float* A, int lda, const float* X,
                        const float* W, int R, int n, float* outW,
                        float* outH, cudaStream_t s) {
  cudaError_t err = rows(A, lda, X, R, n, outW, s);
  if (err != cudaSuccess) return err;
  return cols(A, lda, W, R, n, outH, s);
}

}  // namespace contract
