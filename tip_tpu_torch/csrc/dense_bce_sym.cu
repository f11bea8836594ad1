// Fused symmetric dense BCE for Hopper (sm_90a): positives + Poissonized
// negatives over the upper-triangle strip-packed adjacency, with the
// gradients (dw, dz) from the same pass.
//
// Replaces the Pallas TPU kernel tip_tpu/ops/pallas_dense_bce_sym.py
// (dense_bce_sym_sum; bodies _page_math, _manual_kernel, _auto_kernel).
// The arithmetic is _page_math's, cell for cell:
//   L    = (z_I * w_t) . z_J                       (DistMult logit)
//   cnt  = #{k : u24 < q8[t, k]}  (k in 0..3 on the diagonal block, 4..7
//          on the tail), zeroed where da > 0 or the cell lies past n
//   daw  = da * (1 on the diagonal block, 2 on the tail)
//   loss = sum softplus(-L) * daw + (softplus(-L) + L) * cnt
//   G    = cnt - (1 - exp(-softplus(-L))) * (daw + cnt)
//   dw_t += sum_r z_I[r] * (G z_J)[r];  dz[I] += w_t * (G z_J);
//   dz[J] += w_t * (G^T z_I)
// The TPU kernel draws u24 from the on-chip PRNG in strip order.  Here u24
// is a counter-based hash of (seed, t, row, col) -- cell_u24 of
// bce_cell.cuh, shared with B2 and B3 -- and
// ops/dense_bce_sym.py computes the same field in PyTorch, so the kernel
// and its plain version see identical counts.
//
// Design.  The TPU kernel runs on a grid of (1,), streams relation pages
// through a VMEM ring and adds dz up serially.  Here one block owns one
// 128 x 128 tile (I, J) of the strip layout for a chunk of RC relations:
// z_I and z_J stay in shared memory across the chunk (only w_t changes),
// the G tile goes through shared memory for the two gradient contractions,
// and dz for the tile accumulates in registers across the chunk.  Every
// block writes its loss, dw and dz partials to scratch, and small second
// passes sum them in a fixed order: the result is deterministic, and the
// value-only and fused launches give the same loss bit for bit (the loss
// arithmetic uses explicit round-to-nearest intrinsics, so the compiler
// contracts nothing differently between the two instantiations).
//
// Bound on an H100 at Decagon shape (R = 1097, n = 645, d = 16): the
// 377 MB page read takes 0.11 ms at 3.35 TB/s; the fused form does three
// d-long dots (6 d flops) and ~20 elementwise float operations per cell
// (softplus, counts, G; 3 of them transcendental) besides the hash's
// integer operations.  The float operations alone, ~3.2e10 over the 273 M
// cells inside n x n, bound it: ~0.47 ms at 67 TFLOP/s (chip_smoke.py
// reckons this bound from its run).  This first version spends its time in shared-memory
// traffic and scalar FMAs; wgmma for the three contractions and TMA for the
// page stream are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bce_cell.cuh"

namespace {

using bce_cell::cell_u24;  // cell = row * npad + col of the padded plane
using bce_cell::relation_key;
using bce_cell::softplus;

constexpr int B = 128;          // block edge of the strip layout
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int GSTRIDE = B + 1;  // padded row stride of the G tile

__host__ __device__ __forceinline__ int smem_floats(int d, bool grads) {
  // zi [B][d], ziw [B][d], zjT [d][B]; with grads also red [B][d] and G
  return 3 * B * d + (grads ? B * d + B * GSTRIDE : 0);
}

template <int D, bool GRADS>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const float* __restrict__ w, const float* __restrict__ z,
            const int8_t* __restrict__ pages, const int32_t* __restrict__ q8,
            uint32_t seed, int n_et, int n, int nb, int totcols, int rc,
            float* __restrict__ loss_part, float* __restrict__ dw_part,
            float* __restrict__ dz_part) {
  extern __shared__ float smem[];
  __shared__ float warp_loss[WARPS];
  float* zi = smem;           // [B][D]
  float* ziw = zi + B * D;    // [B][D]
  float* zjT = ziw + B * D;   // [D][B]
  float* red = zjT + D * B;   // [B][D]      (GRADS)
  float* G = red + B * D;     // [B][GSTRIDE] (GRADS)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // blockIdx.x is the tile's column-block index in the packed layout,
  // which enumerates the upper block triangle row by row
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  int i = 0, rem = tile;
  while (rem >= nb - i) {
    rem -= nb - i;
    ++i;
  }
  const int j = i + rem;
  const int row0 = i * B, col0 = j * B;
  const uint32_t npad = (uint32_t)nb * B;
  const bool diag = i == j;
  const int qoff = diag ? 0 : 4;
  const float posw = diag ? 1.f : 2.f;

  for (int idx = tid; idx < B * D; idx += THREADS) {
    const int r = idx / D, k = idx % D;
    zi[idx] = row0 + r < n ? z[(size_t)(row0 + r) * D + k] : 0.f;
    zjT[k * B + r] = col0 + r < n ? z[(size_t)(col0 + r) * D + k] : 0.f;
  }

  const int t0 = blockIdx.y * rc;
  const int t1 = min(t0 + rc, n_et);
  float loss_acc = 0.f;
  float acc[D];  // this thread's dz row (tid < B) or column, over the chunk
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const uint32_t key = relation_key(seed, (uint32_t)t);
    const int q0 = q8[t * 8 + qoff], q1 = q8[t * 8 + qoff + 1];
    const int q2 = q8[t * 8 + qoff + 2], q3 = q8[t * 8 + qoff + 3];
    for (int idx = tid; idx < B * D; idx += THREADS)
      ziw[idx] = __fmul_rn(zi[idx], w[(size_t)t * D + idx % D]);
    __syncthreads();

    const int8_t* page = pages + (size_t)t * B * totcols + (size_t)tile * B;
    for (int m = 0; m < B / WARPS; ++m) {
      const int r = warp + WARPS * m;
      const int gr = row0 + r;
      float a[D];
#pragma unroll
      for (int k = 0; k < D; ++k) a[k] = ziw[r * D + k];
#pragma unroll
      for (int q = 0; q < B / 32; ++q) {
        const int c = lane + 32 * q;
        const int gc = col0 + c;
        float L = __fmul_rn(a[0], zjT[c]);
#pragma unroll
        for (int k = 1; k < D; ++k) L = __fmaf_rn(a[k], zjT[k * B + c], L);
        const float da = (float)page[(size_t)r * totcols + c];
        const int u = cell_u24(key, (uint32_t)gr * npad + (uint32_t)gc);
        float cnt = (float)((u < q0) + (u < q1) + (u < q2) + (u < q3));
        if (da > 0.f || gr >= n || gc >= n) cnt = 0.f;
        const float daw = __fmul_rn(posw, da);
        const float sp = softplus(-L);
        loss_acc = __fadd_rn(
            loss_acc, __fadd_rn(__fmul_rn(sp, daw),
                                __fmul_rn(__fadd_rn(sp, L), cnt)));
        if constexpr (GRADS) {
          const float sg = 1.f - expf(-sp);
          G[r * GSTRIDE + c] = cnt - sg * (daw + cnt);
        }
      }
    }
    __syncthreads();
    if constexpr (GRADS) {
      // tid < B: row r of G z_J (dz rows I, and dw_t); else column c of
      // G^T z_I (dz rows J)
      float h[D];
#pragma unroll
      for (int k = 0; k < D; ++k) h[k] = 0.f;
      if (tid < B) {
        const int r = tid;
        for (int c = 0; c < B; ++c) {
          const float g = G[r * GSTRIDE + c];
#pragma unroll
          for (int k = 0; k < D; ++k) h[k] = fmaf(g, zjT[k * B + c], h[k]);
        }
#pragma unroll
        for (int k = 0; k < D; ++k) red[r * D + k] = zi[r * D + k] * h[k];
      } else {
        const int c = tid - B;
        for (int r = 0; r < B; ++r) {
          const float g = G[r * GSTRIDE + c];
#pragma unroll
          for (int k = 0; k < D; ++k) h[k] = fmaf(g, zi[r * D + k], h[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = fmaf(w[(size_t)t * D + k], h[k], acc[k]);
      __syncthreads();
      if (tid < D) {
        float s = 0.f;
        for (int r = 0; r < B; ++r) s += red[r * D + tid];
        dw_part[((size_t)tile * n_et + t) * D + tid] = s;
      }
    }
  }

  const size_t blk = (size_t)blockIdx.y * n_tiles + tile;
  if constexpr (GRADS) {
    float* out = dz_part + ((blk * 2 + (tid < B ? 0 : 1)) * B + (tid % B)) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) out[k] = acc[k];
  }
  // fixed-order block reduction of the loss
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    loss_acc = __fadd_rn(loss_acc, __shfl_down_sync(0xffffffffu, loss_acc, off));
  if (lane == 0) warp_loss[warp] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < WARPS; ++k) s = __fadd_rn(s, warp_loss[k]);
    loss_part[blk] = s;
  }
}

// Sum of the per-block loss partials in a fixed order.
__global__ void __launch_bounds__(THREADS)
reduce_loss(const float* __restrict__ part, int count, float* __restrict__ out) {
  __shared__ float s[THREADS];
  float acc = 0.f;
  for (int k = threadIdx.x; k < count; k += THREADS) acc = __fadd_rn(acc, part[k]);
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s[0];
}

// dw[t, k] = sum over tiles of the per-tile partials.
__global__ void reduce_dw(const float* __restrict__ part, int n_tiles, int n_et,
                          int d, float* __restrict__ dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_et * d) return;
  float s = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) s += part[(size_t)tile * n_et * d + idx];
  dw[idx] = s;
}

// dz[row, k]: rows of block b collect the row part of tiles (b, j >= b) and
// the column part of tiles (i <= b, b), over every relation chunk.
__global__ void reduce_dz(const float* __restrict__ part, int n_chunks, int nb,
                          int n, int d, float* __restrict__ dz) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * d) return;
  const int row = idx / d, k = idx % d;
  const int b = row / B, rr = row % B;
  const int n_tiles = nb * (nb + 1) / 2;
  float s = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    for (int jj = b; jj < nb; ++jj) {
      const int tile = b * nb - b * (b - 1) / 2 + (jj - b);
      s += part[((((size_t)ch * n_tiles + tile) * 2 + 0) * B + rr) * d + k];
    }
    for (int ii = 0; ii <= b; ++ii) {
      const int tile = ii * nb - ii * (ii - 1) / 2 + (b - ii);
      s += part[((((size_t)ch * n_tiles + tile) * 2 + 1) * B + rr) * d + k];
    }
  }
  dz[idx] = s;
}

template <int D, bool GRADS>
cudaError_t launch(const float* w, const float* z, const int8_t* pages,
                   const int32_t* q8, uint32_t seed, int n_et, int n, int nb,
                   int totcols, int rc, float* loss_part, float* dw_part,
                   float* dz_part, float* loss, float* dw, float* dz,
                   cudaStream_t stream) {
  const int n_tiles = nb * (nb + 1) / 2;
  const int n_chunks = (n_et + rc - 1) / rc;
  const int smem = smem_floats(D, GRADS) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<D, GRADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tile_kernel<D, GRADS><<<dim3(n_tiles, n_chunks), THREADS, smem, stream>>>(
      w, z, pages, q8, seed, n_et, n, nb, totcols, rc, loss_part, dw_part,
      dz_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_loss<<<1, THREADS, 0, stream>>>(loss_part, n_tiles * n_chunks, loss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (GRADS) {
    reduce_dw<<<(n_et * D + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        dw_part, n_tiles, n_et, D, dw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    reduce_dz<<<(n * D + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        dz_part, n_chunks, nb, n, D, dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t dispatch(int grads, const float* w, const float* z,
                     const int8_t* pages, const int32_t* q8, uint32_t seed,
                     int n_et, int n, int nb, int totcols, int rc,
                     float* loss_part, float* dw_part, float* dz_part,
                     float* loss, float* dw, float* dz, cudaStream_t stream) {
  if (grads)
    return launch<D, true>(w, z, pages, q8, seed, n_et, n, nb, totcols, rc,
                           loss_part, dw_part, dz_part, loss, dw, dz, stream);
  return launch<D, false>(w, z, pages, q8, seed, n_et, n, nb, totcols, rc,
                          loss_part, dw_part, dz_part, loss, dw, dz, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/dense_bce_sym.py).
// Scratch sizes, in floats: loss_part n_tiles * n_chunks; dw_part
// n_tiles * n_et * d; dz_part n_chunks * n_tiles * 2 * 128 * d, where
// n_tiles = nb (nb + 1) / 2 and n_chunks = ceil(n_et / rc).  With grads 0
// the dw/dz pointers are not touched.  Returns the first CUDA error.
extern "C" int tip_dense_bce_sym(const float* w, const float* z,
                                 const int8_t* pages, const int32_t* q8,
                                 unsigned int seed, int n_et, int n, int d,
                                 int nb, int totcols, int rc, int grads,
                                 float* loss_part, float* dw_part,
                                 float* dz_part, float* loss, float* dw,
                                 float* dz, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 8:
      return dispatch<8>(grads, w, z, pages, q8, seed, n_et, n, nb, totcols,
                         rc, loss_part, dw_part, dz_part, loss, dw, dz, s);
    case 16:
      return dispatch<16>(grads, w, z, pages, q8, seed, n_et, n, nb, totcols,
                          rc, loss_part, dw_part, dz_part, loss, dw, dz, s);
    case 32:
      return dispatch<32>(grads, w, z, pages, q8, seed, n_et, n, nb, totcols,
                          rc, loss_part, dw_part, dz_part, loss, dw, dz, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
