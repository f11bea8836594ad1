// The DistMult SDDMM backward over chunk-aligned typed edges, shared by the
// v2 kernel B8 (distmult_sddmm.cu) and the v1 kernel B6
// (distmult_sddmm_v1.cu): the two TPU backwards compute the same gradients
// and differ only in where each scattered dz contribution is rounded to
// bf16, which the template's ORDER picks:
//   V2 (B8): (g * z[other]) * w[t], as _dm2_bwd_kernel scales g first;
//   V1 (B6): (z[other] * w[t]) * g, as _distmult_bwd_kernel's
//            `(zd * w * g).astype`.
//   dz[src] += bf16?(contribution of z[dst]);  dz[dst] += bf16?(... z[src])
//   dwc[c, k] = sum_j (z[src, k] * z[dst, k]) * g[c, j]
//   dw[t] = sum over t's chunks of dwc, in chunk order
// over src/dst [n_chunks, C] int32 (C a multiple of 16) with pad slots at
// dst = n, chunk_type [n_chunks] non-decreasing.  zp is z [n, 16] with a
// zero row n appended, so a pad slot adds zeros to its src row and dw; its
// dst contributions land in row n, which is scratch.  With round_bf16 each
// contribution is rounded to bf16 before it enters a run sum; the sums are
// float32.
//
// Design: quad_walk.cuh's lane-quad walk.  Persistent blocks of 8 warps
// walk the chunks with a stride of the grid, a lane quad a 16-slot segment
// at a time, lane q holding features 4q .. 4q + 3 and reading float4 q of
// the slot's two z rows from device memory through L1 (64 bytes a node,
// L2-resident).  dz is one zeroed device table [n + 1, 16] that takes the
// quads' float4 reductions, run by run (the positives are dst-sorted in a
// chunk and the pad tail is one run); no per-block partials.  dwc[c] is a
// fixed-order sum (each quad's slots in order, the quads by a shuffle
// tree, the warps in order: chunk_sums::quad_block_sum) and dw a
// per-relation sum over its chunk range in chunk order
// (chunk_sums::by_relation), so dw does not depend on the blocks' order of
// execution; dz takes its reductions in no fixed order and is not bit for
// bit deterministic.  A relation that owns no chunk gets dw = 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_sums.cuh"
#include "quad_walk.cuh"

namespace distmult_bwd {

constexpr int D = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = quad_walk::SEG;  // slots a quad walks in order
constexpr int AUX_THREADS = 256;

enum Order { V1, V2 };  // where a contribution is rounded (see the top)

__device__ __forceinline__ float maybe_bf16(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// One component's contribution in ORDER's product order.
template <Order ORDER>
__device__ __forceinline__ float term(float gv, float x, float w,
                                      int round_bf16) {
  return maybe_bf16(ORDER == V2 ? __fmul_rn(__fmul_rn(gv, x), w)
                                : __fmul_rn(__fmul_rn(x, w), gv),
                    round_bf16);
}

template <Order ORDER>
__device__ __forceinline__ float4 contrib(float gv, float4 x, float4 w,
                                          int round_bf16) {
  return make_float4(term<ORDER>(gv, x.x, w.x, round_bf16),
                     term<ORDER>(gv, x.y, w.y, round_bf16),
                     term<ORDER>(gv, x.z, w.z, round_bf16),
                     term<ORDER>(gv, x.w, w.w, round_bf16));
}

// dz: [n + 1][D], zeroed by the caller; dwc: [n_chunks][D].
template <Order ORDER>
__global__ void __launch_bounds__(THREADS)
walk(const float* __restrict__ zp, const float* __restrict__ w,
     const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
     const int32_t* __restrict__ ct, const float* __restrict__ g, int n_chunks,
     int C, int n, int round_bf16, float* __restrict__ dz,
     float* __restrict__ dwc) {
  __shared__ float red[WARPS * D];
  const float4* tab = reinterpret_cast<const float4*>(zp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, quad = lane >> 2;
  const int nseg = C / SEG;

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const float4 wv =
        reinterpret_cast<const float4*>(w + (size_t)ct[c] * D)[q];
    float4 dwl[1] = {make_float4(0.f, 0.f, 0.f, 0.f)};
    // warp-uniform: a warp takes 8 consecutive segments, a quad one
    for (int s0 = warp * 8; s0 < nseg; s0 += WARPS * 8) {
      const int seg = s0 + quad;
      quad_walk::segment(
          src, dst, g, (size_t)c * C + (size_t)seg * SEG + 4 * q, seg < nseg,
          n, dz, dz, [&](int s, int dd, float gv, float4& cs, float4& cd) {
            const float4 a = __ldg(tab + (size_t)s * (D / 4) + q);
            const float4 b = __ldg(tab + (size_t)dd * (D / 4) + q);
            cs = contrib<ORDER>(gv, b, wv, round_bf16);
            cd = contrib<ORDER>(gv, a, wv, round_bf16);
            float4& v = dwl[0];
            v.x = __fadd_rn(v.x, __fmul_rn(__fmul_rn(a.x, b.x), gv));
            v.y = __fadd_rn(v.y, __fmul_rn(__fmul_rn(a.y, b.y), gv));
            v.z = __fadd_rn(v.z, __fmul_rn(__fmul_rn(a.z, b.z), gv));
            v.w = __fadd_rn(v.w, __fmul_rn(__fmul_rn(a.w, b.w), gv));
          });
    }
    chunk_sums::quad_block_sum<1>(dwl, red, dwc + (size_t)c * D);
  }
}

// zp [n + 1][16]; w, src, dst and g 16-byte aligned; scratch dwc
// [n_chunks][16]; outputs dz [n + 1][16] (row n is scratch), dw [n_et][16].
// `sms`: the card's SM count (the grid is as many blocks as fit them at
// once).  Returns the first CUDA error.
template <Order ORDER>
inline cudaError_t launch(const float* zp, const float* w, const int32_t* src,
                          const int32_t* dst, const int32_t* ct,
                          const float* g, int n_chunks, int C, int n, int n_et,
                          int round_bf16, int sms, float* dwc, float* dz,
                          float* dw, cudaStream_t s) {
  cudaError_t err =
      cudaMemsetAsync(dz, 0, (size_t)(n + 1) * D * sizeof(float), s);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk<ORDER>,
                                                      THREADS, 0);
  if (err != cudaSuccess) return err;
  walk<ORDER><<<(per_sm > 1 ? per_sm : 1) * sms, THREADS, 0, s>>>(
      zp, w, src, dst, ct, g, n_chunks, C, n, round_bf16, dz, dwc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_sums::by_relation<<<(n_et * D + AUX_THREADS - 1) / AUX_THREADS,
                            AUX_THREADS, 0, s>>>(dwc, ct, n_chunks, n_et, D,
                                                 dw);
  return cudaGetLastError();
}

}  // namespace distmult_bwd
