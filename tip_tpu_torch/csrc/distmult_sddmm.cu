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
// is distmult_bwd.cuh's lane-quad walk (quad_walk.cuh; the first version
// gave a slot one thread, which added 16 floats to random rows of a
// shared-memory table by compare-and-swap loops: 2.7 times slower, and 27
// times in global memory), which B6 launches too with its own rounding
// points: a quad of lanes reads a slot's two z rows as four 16-byte reads
// and adds its run sums into one zeroed, L2-resident dz table [n + 1, 16]
// by float4 reductions (98 KB at n = 1,536; the positives are dst-sorted
// inside a chunk, runs of ~5 at 1,536 x 800), with no per-block partials;
// z is read through L1 (a copy in shared memory measured no faster); dwc
// and dw are fixed-order sums, so dw does not depend on the blocks' order
// of execution, and dz, whose reductions land in no fixed order, is not
// bit-for-bit deterministic.  With round_bf16 each contribution (g * x) *
// w is rounded to bf16 before it enters a run sum.  The chunk length must
// be a multiple of 16 (the wrapper checks).
//
// Bound on an H100 at Decagon shape (~9.0 M slots, d = 16): the forward
// must read src and dst and write the logit, 12 bytes a slot (~108 MB),
// ~0.03 ms at 3.35 TB/s; its 3 d float operations a slot (~0.43 G) take
// ~0.006 ms at 67 TFLOP/s, so bytes bound it.  The backward reads src, dst
// and g (12 bytes a slot) and does ~9 d operations a slot: bytes bound it
// too.  chip_smoke.py reckons the bounds from its run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "distmult_bwd.cuh"
#include "distmult_fwd.cuh"

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
  return distmult_bwd::launch<distmult_bwd::V2>(
      zp, w, src, dst, ct, g, n_chunks, C, n, n_et, round_bf16, sms, dwc, dz,
      dw, (cudaStream_t)stream);
}
