// Fixed-order contractions of per-item tables with the NN decoder's 16-wide
// rows, shared by dense_bce_nn.cu (kernel B3: an item is a relation, A the
// row or column sums of the cotangent tile) and nn_sddmm.cu (kernel B9: an
// item is a run of at most 16 chunks of one relation, A the cotangent
// summed per endpoint over the item).  For each side (A, X, W):
//   rows: outW[t][k] = sum over t's items i, in item order, of
//                      sum_j A_i[j] X[j][k]
//   cols: outH[j][k] = sum over items i of A_i[j] W[rel(i)][k]
// A_i is row i of A (row stride lda >= n).  Both sides' rows and cols run
// in one launch (B9's bf16 backward: rows only).  A rows output is split
// over LANES threads that sum strided parts of j in order, the parts added
// in lane order.  The cols
// outputs are split over slabs of SLAB items (enough blocks to fill the
// card where the nodes are few: 41 blocks of nodes at n = 645), each
// summed over LANES strided parts added in lane order; sum_slabs then adds
// the slabs in slab order.  Deterministic.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace contract {

constexpr int D = 16;       // the rows' width
constexpr int LANES = 16;   // threads that split one output's sum
constexpr int COLS_J = 16;  // nodes per cols block
constexpr int THREADS = D * LANES;
constexpr int SLAB = 128;   // items a cols slab (ops/sddmm2.py: CONTRACT_SLAB)

struct Side {
  const float* A;  // [items][lda]
  int lda;
  const float* X;  // [n][16]
  const float* W;  // [R][16]
  float* outW;     // [R][16]
  float* outH;     // [n][16], or null: no cols for this side
};

// The items: item i of relation rel(i) = items[i].x; relation t owns items
// rel_items[t] .. rel_items[t + 1] - 1, rel_items[R] in all.  items null:
// item i is relation i (R items).
struct Items {
  const int4* items;
  const int32_t* rel_items;
};

__device__ __forceinline__ void rows_role(const Side& sd, const Items& it,
                                          int n, int t, float* part) {
  const int k = threadIdx.x % D, lane = threadIdx.x / D;
  const int i0 = it.items ? it.rel_items[t] : t;
  const int i1 = it.items ? it.rel_items[t + 1] : t + 1;
  float s = 0.f;
  for (int i = i0; i < i1; ++i) {
    const float* a = sd.A + (size_t)i * sd.lda;
    for (int j = lane; j < n; j += LANES)
      s = fmaf(a[j], sd.X[(size_t)j * D + k], s);
  }
  part[lane * D + k] = s;
  __syncthreads();
  if (lane == 0) {
    float r = 0.f;
    for (int l = 0; l < LANES; ++l) r += part[l * D + k];
    sd.outW[(size_t)t * D + k] = r;
  }
}

// nodes jb * COLS_J .., items of slab sl; thread (jl = node, lane) keeps
// the 16 sums of its node over items lo + lane + 16 m
__device__ __forceinline__ void cols_role(const Side& sd, const Items& it,
                                          int R, int n, int jb, int sl,
                                          int slabs, float* part, float* P) {
  const int jl = threadIdx.x % COLS_J, lane = threadIdx.x / COLS_J;
  const int j = jb * COLS_J + jl;
  const int n_items = it.items ? it.rel_items[R] : R;
  const int lo = sl * SLAB, hi = min(n_items, lo + SLAB);
  float s[D];
#pragma unroll
  for (int k = 0; k < D; ++k) s[k] = 0.f;
  if (j < n) {
    for (int i = lo + lane; i < hi; i += LANES) {
      const float a = sd.A[(size_t)i * sd.lda + j];
      const float* w = sd.W + (size_t)(it.items ? it.items[i].x : i) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) s[k] = fmaf(a, w[k], s[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) part[(lane * COLS_J + jl) * (D + 1) + k] = s[k];
  __syncthreads();
  // COLS_J * D = THREADS outputs, one a thread
  const int oj = threadIdx.x / D, ok = threadIdx.x % D;
  if (jb * COLS_J + oj < n) {
    float r = 0.f;
    for (int l = 0; l < LANES; ++l) r += part[(l * COLS_J + oj) * (D + 1) + ok];
    float* out = slabs == 1 ? sd.outH : P + (size_t)sl * n * D;
    out[(size_t)(jb * COLS_J + oj) * D + ok] = r;
  }
}

// side 1 ? s1 : s0, field by field (a select of the whole parameter
// struct goes through local memory)
__device__ __forceinline__ Side pick(const Side& s0, const Side& s1,
                                     bool side1) {
  return {side1 ? s1.A : s0.A,       side1 ? s1.lda : s0.lda,
          side1 ? s1.X : s0.X,       side1 ? s1.W : s0.W,
          side1 ? s1.outW : s0.outW, side1 ? s1.outH : s0.outH};
}

// Blocks [0, 2 R): rows of relation b % R on side b / R; then, with
// cols, node blocks x slabs of side 0's cols and then of side 1's.  P:
// each side's slab partials [slabs][n][16], side 0's first.
__global__ void __launch_bounds__(THREADS)
contract_kernel(Side s0, Side s1, Items it, int R, int n, int slabs,
                float* __restrict__ P) {
  __shared__ float part[LANES * COLS_J * (D + 1)];
  int b = blockIdx.x;
  if (b < 2 * R) {
    rows_role(pick(s0, s1, b >= R), it, n, b % R, part);
    return;
  }
  b -= 2 * R;
  const int nb = (n + COLS_J - 1) / COLS_J;
  const int side = b / (nb * slabs);
  b %= nb * slabs;
  cols_role(pick(s0, s1, side), it, R, n, b % nb, b / nb, slabs, part,
            P + (size_t)side * slabs * n * D);
}

// outH[i] = sum over slabs of P[slab][i], in slab order, on both sides
__global__ void sum_slabs(const float* __restrict__ P, int slabs, int count,
                          float* __restrict__ out0, float* __restrict__ out1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * count) return;
  const int side = i >= count, o = i - side * count;
  const float* p = P + (size_t)side * slabs * count + o;
  float r = 0.f;
  for (int sl = 0; sl < slabs; ++sl) r += p[(size_t)sl * count];
  (side ? out1 : out0)[o] = r;
}

// The contractions of both sides over R relations and n nodes: one launch,
// plus the slab sum.  The cols run where s0.outH and s1.outH are both set
// (both null: rows only).  slabs = ceil(the items' upper bound / SLAB); P
// holds [2][slabs][n][16] floats (unused when slabs is 1).
inline cudaError_t run(const Side& s0, const Side& s1, const Items& it, int R,
                       int n, int slabs, float* P, cudaStream_t s) {
  const bool cols = s0.outH != nullptr;
  const int nb = (n + COLS_J - 1) / COLS_J;
  const int blocks = 2 * R + (cols ? 2 * nb * slabs : 0);
  contract_kernel<<<blocks, THREADS, 0, s>>>(s0, s1, it, R, n, slabs, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !cols || slabs == 1) return err;
  const int count = n * D;
  sum_slabs<<<(2 * count + 255) / 256, 256, 0, s>>>(P, slabs, count, s0.outH,
                                                    s1.outH);
  return cudaGetLastError();
}

}  // namespace contract
