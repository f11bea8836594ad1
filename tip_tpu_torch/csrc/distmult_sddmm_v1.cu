// v1 DistMult SDDMM over chunk-aligned typed edges for Hopper (sm_90a),
// forward and backward: kernel B6.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_segment.py
// (distmult_logits_padded: _distmult_fwd_kernel, _distmult_bwd_kernel):
//   logit[c, j] = sum_k (z[src, k] * z[dst, k]) * w[ct[c], k]
//   dz[src] += bf16?((z[dst] * w[t]) * g);  dz[dst] += bf16?((z[src] * w[t]) * g)
//   dwc[c, k] = sum_j (z[src, k] * z[dst, k]) * g[c, j]
//   dw[t] = sum over t's chunks of dwc, in chunk order
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing, C a multiple of 16.  The wrapper hands in zp
// = z (rounded to the compute dtype) with a zero row n appended, so a pad
// slot reads zeros at its dst, as the TPU kernel's all-zero one-hot column
// does: its logit is exactly 0 and it adds nothing to its src row or dw.
// With round_bf16 each scattered dz contribution is rounded to bf16 before
// it is added, at the TPU kernel's rounding points (its `(zd * w *
// g).astype`); everything else is float32.  This rounds at other points
// than v2 (distmult_sddmm.cu, which scales g by the endpoint first), so the
// two agree exactly in float32 on valid slots and differ by design in
// bf16.  The feature width is 16 (the wrapper refuses others).
//
// The TPU kernel gathers the endpoints with one-hot matmuls over the whole
// node axis held in VMEM and scatters dz by one-hot matmuls too.  On this
// card a gather is a load and a scatter a reduction into L2.
//
// Design.  Both passes are v2's (B8's) under B6's entry points:
//   forward:  distmult_fwd.cuh: the two TPU kernels' logits are the same
//             products summed in the same order, so B6's logits equal
//             B8's bit for bit;
//   backward: distmult_bwd.cuh, B8's lane-quad walk with B6's product
//             order: lane quads walk 16-slot segments, each slot's
//             contributions (z[other] * w) * g are rounded (round_bf16)
//             before they enter a run sum a side, and a run of equal rows
//             is added to one zeroed, L2-resident dz table by a float4
//             reduction a lane; dwc and dw are fixed-order sums
//             (chunk_sums.cuh).  One mode at any n.  The first version
//             gave a slot one thread, which added 32 floats a slot with
//             float atomics into a per-block shared-memory table (n <=
//             3,402; compare-and-swap loops on this card) whose partials a
//             second pass summed, or into device memory past that: 2.36 ms
//             and 6.36 ms at Decagon shape.
// dw and the logits are deterministic; dz, whose reductions land in no
// fixed order, is not bit for bit.  A relation that owns no chunk gets dw
// = 0 (the TPU kernel never writes its block).
//
// Bound on an H100 at Decagon shape (~9.0 M slots, d = 16): the forward must
// read src and dst and write the logit, 12 bytes a slot (~108 MB), ~0.032
// ms at 3.35 TB/s; its 3 d float operations a slot (~0.43 G) take ~0.006 ms
// at 67 TFLOP/s, so bytes bound it.  The backward reads src, dst and g (12
// bytes a slot) and does ~9 d operations a slot: bytes bound it too.
// chip_smoke.py reckons the bounds from its run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "distmult_bwd.cuh"
#include "distmult_fwd.cuh"

// Plain C entry points (bound with ctypes by ops/typed_segment.py).  zp is
// z [n, 16] with a zero row appended.  Each returns the first CUDA error.

// out: [n_chunks, C] float32; `shared` picks the forward's table mode, and
// the wrapper checks that a shared table fits.
extern "C" int tip_dm1_fwd(const float* zp, const float* w, const int32_t* src,
                           const int32_t* dst, const int32_t* ct, int n_chunks,
                           int C, int n, int shared, int blocks, float* out,
                           void* stream) {
  return distmult_fwd::launch(zp, w, src, dst, ct, n_chunks, C, n, shared,
                              blocks, out, (cudaStream_t)stream);
}

// w, src, dst and g [n_chunks, C] 16-byte aligned, C a multiple of 16;
// scratch dwc [n_chunks, 16]; outputs dz [n + 1, 16] (row n is scratch),
// dw [n_et, 16].  `sms`: the card's SM count (the grid is as many blocks as
// fit them at once).
extern "C" int tip_dm1_bwd(const float* zp, const float* w, const int32_t* src,
                           const int32_t* dst, const int32_t* ct,
                           const float* g, int n_chunks, int C, int n,
                           int n_et, int round_bf16, int sms, float* dwc,
                           float* dz, float* dw, void* stream) {
  return distmult_bwd::launch<distmult_bwd::V1>(
      zp, w, src, dst, ct, g, n_chunks, C, n, n_et, round_bf16, sms, dwc, dz,
      dw, (cudaStream_t)stream);
}
