// DistMult SDDMM over chunk-aligned typed edges for Hopper (sm_90a),
// forward and backward.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_sddmm2.py
// (distmult_logits_padded2: _dm2_fwd_kernel, _dm2_bwd_kernel):
//   logit[c, j] = sum_k (z[src, k] * z[dst, k]) * w[ct[c], k]
//   dz[src] += (g * z[dst]) * w[t];  dz[dst] += (g * z[src]) * w[t]
//   dwc[c, k] = sum_j (z[src, k] * z[dst, k]) * g[c, j];
//   dw[t] = sum over t's chunks of dwc, in chunk order
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing.  The wrapper hands in zp = z with a zero row n
// appended, so pad logits are exactly 0.0.  With round_bf16 each scattered
// dz contribution is rounded to bf16 (z comes in bf16-rounded from the
// wrapper), as the TPU kernel's casts do; accumulation is float32.  The
// feature width is 16 (n_hid2 of every configuration; the wrapper refuses
// others).
//
// The TPU kernel gathers with a two-level one-hot matmul and keeps the
// gathered endpoints as residuals; here each thread reads its slot's two
// rows of z directly, and the backward gathers again rather than reading
// saved endpoints (2 x 0.58 GB a call at Decagon shape).
//
// Design.  The forward is distmult_fwd.cuh's (one thread a slot over a
// shared-memory z table up to n = 3,417, one lane quad a slot reading z
// through L1 past it), which the v1 kernel B6 launches too.  The backward
// is quad_walk.cuh's lane-quad walk (the first version gave a slot one
// thread, which added 16 floats to random rows of a shared-memory table by
// compare-and-swap loops: 2.7 times slower, and 27 times in global
// memory), its two z rows four 16-byte reads a slot:
//   * dz lives in a zeroed device table [n + 1, 16] (98 KB at n = 1,536:
//     it stays in L2) and takes the quad's float4 reductions, run by run
//     (the positives are dst-sorted inside a chunk, runs of ~5 at 1,536 x
//     800); no per-block partials, so no pass sums them;
//   * z is read as float4 rows from device memory through L1 (any n: 64
//     bytes a node); a copy in shared memory measured no faster;
//   * dwc[c] is a fixed-order reduction (each quad's slots in order, the
//     quads by a shuffle tree, the warps in order), and dw a per-relation
//     sum over its chunk range in chunk order, so dw does not depend on
//     the blocks' order of execution.  dz takes its reductions in no fixed
//     order: it is not bit-for-bit deterministic.
// With round_bf16 each contribution is rounded to bf16 before it enters a
// run sum.  The chunk length must be a multiple of 16 (the wrapper
// checks).
//
// Bound on an H100 at Decagon shape (~9.0 M slots, d = 16): the forward
// must read src and dst and write the logit, 12 bytes a slot (~108 MB),
// ~0.03 ms at 3.35 TB/s; its 3 d float operations a slot (~0.43 G) take
// ~0.006 ms at 67 TFLOP/s, so bytes bound it.  The backward reads src, dst
// and g (12 bytes a slot) and does ~9 d operations a slot: bytes bound it
// too.  chip_smoke.py reckons the bounds from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "distmult_fwd.cuh"
#include "quad_walk.cuh"

namespace {

constexpr int D = 16;
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int SEG = quad_walk::SEG;  // slots a quad walks in order
constexpr int AUX_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float maybe_bf16(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// (g * x) * w per component, each rounded to bf16 with round_bf16
__device__ __forceinline__ float4 contrib(float gv, float4 x, float4 w,
                                          int round_bf16) {
  return make_float4(
      maybe_bf16(__fmul_rn(__fmul_rn(gv, x.x), w.x), round_bf16),
      maybe_bf16(__fmul_rn(__fmul_rn(gv, x.y), w.y), round_bf16),
      maybe_bf16(__fmul_rn(__fmul_rn(gv, x.z), w.z), round_bf16),
      maybe_bf16(__fmul_rn(__fmul_rn(gv, x.w), w.w), round_bf16));
}

// dz: [n + 1][D], zeroed by the caller; dwc: [n_chunks][D].
__global__ void __launch_bounds__(BWD_THREADS)
dm_bwd(const float* __restrict__ zp, const float* __restrict__ w,
       const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
       const int32_t* __restrict__ ct, const float* __restrict__ g, int n_chunks,
       int C, int n, int round_bf16, float* __restrict__ dz,
       float* __restrict__ dwc) {
  __shared__ float red[BWD_WARPS][D];
  const float4* tab = reinterpret_cast<const float4*>(zp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, quad = lane >> 2;
  const int nseg = C / SEG;

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const float4 wv = reinterpret_cast<const float4*>(w + (size_t)ct[c] * D)[q];
    float4 dwl = make_float4(0.f, 0.f, 0.f, 0.f);
    // warp-uniform: a warp takes 8 consecutive segments, a quad one
    for (int s0 = warp * 8; s0 < nseg; s0 += BWD_WARPS * 8) {
      const int seg = s0 + quad;
      quad_walk::segment(
          src, dst, g, (size_t)c * C + (size_t)seg * SEG + 4 * q, seg < nseg,
          n, dz, dz, [&](int s, int dd, float gv, float4& cs, float4& cd) {
            const float4 a = __ldg(tab + (size_t)s * (D / 4) + q);
            const float4 b = __ldg(tab + (size_t)dd * (D / 4) + q);
            cs = contrib(gv, b, wv, round_bf16);
            cd = contrib(gv, a, wv, round_bf16);
            dwl.x = __fadd_rn(dwl.x, __fmul_rn(__fmul_rn(a.x, b.x), gv));
            dwl.y = __fadd_rn(dwl.y, __fmul_rn(__fmul_rn(a.y, b.y), gv));
            dwl.z = __fadd_rn(dwl.z, __fmul_rn(__fmul_rn(a.z, b.z), gv));
            dwl.w = __fadd_rn(dwl.w, __fmul_rn(__fmul_rn(a.w, b.w), gv));
          });
    }
    // fixed-order reduction of dwl: the 8 quads of a warp by a shuffle
    // tree, then the warps in order
    float v[4] = {dwl.x, dwl.y, dwl.z, dwl.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int o = 16; o >= 4; o >>= 1)
        v[k] = __fadd_rn(v[k], __shfl_down_sync(FULL, v[k], o));
      if (lane < 4) red[warp][4 * q + k] = v[k];
    }
    __syncthreads();
    if (threadIdx.x < D) {
      float t = 0.f;
      for (int u = 0; u < BWD_WARPS; ++u) t = __fadd_rn(t, red[u][threadIdx.x]);
      dwc[(size_t)c * D + threadIdx.x] = t;
    }
    __syncthreads();
  }
}

// dw[t, k] = sum of dwc[c, k] over the chunks c of relation t, in chunk
// order (chunk_type is sorted; a relation without chunks gets 0).
__global__ void dw_by_relation(const float* __restrict__ dwc,
                               const int32_t* __restrict__ ct, int n_chunks,
                               int n_et, float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_et * D) return;
  const int t = i / D, k = i % D;
  int lo = 0, hi = n_chunks;  // first chunk with ct >= t
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (ct[mid] < t) lo = mid + 1; else hi = mid;
  }
  float s = 0.f;
  for (int c = lo; c < n_chunks && ct[c] == t; ++c) s += dwc[(size_t)c * D + k];
  dw[i] = s;
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/sddmm2.py).  zp is z
// [n, 16] with a zero row appended.  Each returns the first CUDA error.

// out: [n_chunks, C] float32; `shared` picks the forward's table mode, and
// the wrapper checks that a shared table fits.
extern "C" int tip_dm_fwd(const float* zp, const float* w, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, int n_chunks,
                          int C, int n, int shared, int blocks, float* out,
                          void* stream) {
  return distmult_fwd::launch(zp, w, src, dst, ct, n_chunks, C, n, shared,
                              blocks, out, (cudaStream_t)stream);
}

// g: [n_chunks, C]; scratch dwc [n_chunks, 16]; outputs dz [n + 1, 16]
// (row n is scratch), dw [n_et, 16].  C a multiple of 16; `sms` the card's
// SM count (the grid is as many blocks as fit them at once).
extern "C" int tip_dm_bwd(const float* zp, const float* w, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, const float* g,
                          int n_chunks, int C, int n, int n_et, int round_bf16,
                          int sms, float* dwc, float* dz, float* dw,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(dz, 0, (size_t)(n + 1) * D * sizeof(float), s);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dm_bwd,
                                                      BWD_THREADS, 0);
  if (err != cudaSuccess) return err;
  dm_bwd<<<(per_sm > 1 ? per_sm : 1) * sms, BWD_THREADS, 0, s>>>(
      zp, w, src, dst, ct, g, n_chunks, C, n, round_bf16, dz, dwc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dw_by_relation<<<(n_et * D + AUX_THREADS - 1) / AUX_THREADS, AUX_THREADS, 0,
                   s>>>(dwc, ct, n_chunks, n_et, dw);
  return cudaGetLastError();
}
