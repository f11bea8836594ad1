// v1 NN-decoder SDDMM over chunk-aligned typed edges for Hopper (sm_90a),
// forward and backward: kernel B7.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_segment.py
// (nn_logits_padded: _nn_fwd_kernel, _nn_bwd_kernel):
//   logit[c, j] = sum_l h1[src, l] * w1[t, l] + h2[dst, l] * w2[t, l],
//                 t = ct[c]
//   dh1[src] += bf16?(w1[t] * g);  dh2[dst] += bf16?(w2[t] * g)
//   dwc1[c] = sum_j h1[src] * g;   dwc2[c] = sum_j h2[dst] * g
//   dw1[t], dw2[t] = sums over t's chunks of dwc1, dwc2, in chunk order
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing, C a multiple of 16.  A pad slot's dst term is
// exactly 0 (the TPU kernel's all-zero one-hot column), but its src term
// is real: the TPU kernel scores, and differentiates, the pad src too and
// leaves the masking to the caller (pallas_segment.py:nn_logits_padded),
// and so does this kernel.  With round_bf16 each scattered dh contribution
// w[t] * g is rounded to bf16 before it is added (the TPU kernel's
// `(w * g).astype`), with float32 everywhere else; v2 (nn_sddmm.cu) rounds
// per (relation, endpoint) sum instead, so the two agree to float32 order
// on valid slots and differ by design in bf16.  The hidden width l1 is 16
// (the wrapper refuses others).
//
// Design.
//   forward:  v2's (nn_fwd.cuh, launched here under B7's entry point): the
//             two TPU kernels' forwards compute the same logits, so B7's
//             logits equal B9's bit for bit.  Per-relation score rows in
//             shared memory up to 29,055 nodes ("shared"), a score table in
//             device memory past that or when asked ("global").  The first
//             version ran one thread a slot summing 32 products from node
//             tables in shared memory (n <= 1,708) or in device memory,
//             one 4-byte read each.
//   backward: persistent blocks of 8 warps walk the chunks, a lane quad a
//             16-slot segment at a time (quad_walk.cuh, B8's walk): lane q
//             of the quad holds features 4q .. 4q + 3, each slot's
//             contributions w1[t] g and w2[t] g are rounded (round_bf16)
//             and then enter a run sum a side, and a run of equal src (dst)
//             rows is added to the device-memory tables dh1 (dh2), which L2
//             holds, by one float4 reduction a lane, where the run ends.
//             The positives are dst-sorted in a chunk and the pad tail is
//             one run, so the dst side takes far fewer reductions than
//             slots.  The same lanes read float4 q of the slot's h1[src]
//             and h2[dst] rows and add h1 g, h2 g into dwc partials, which
//             the block sums in a fixed order per chunk (chunk_sums.cuh),
//             and dw is the per-relation sum of those in chunk order.  The
//             first version added every contribution, 16 a slot and side,
//             with float atomics into per-block shared-memory tables (n <=
//             1,693) or into device memory: compare-and-swap loops on this
//             card, 4.5 ms and 12.6 ms at Decagon shape.
// The logits, dw1 and dw2 are deterministic; dh1 and dh2 (reductions in
// no fixed order) are not bit for bit.  A relation that owns no chunk gets
// dw = 0.
//
// Bound on an H100 at Decagon shape (~9.0 M slots, l1 = 16): the forward
// reads src and dst and writes the logit, 12 bytes a slot (~108 MB, ~0.032
// ms at 3.35 TB/s) against 4 l1 float operations a slot (~0.009 ms at 67
// TFLOP/s): bytes bound it.  The backward reads src, dst and g (12 bytes a
// slot) and does ~6 l1 operations a slot: bytes bound it too.
// chip_smoke.py reckons the bounds from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_sums.cuh"
#include "nn_fwd.cuh"
#include "quad_walk.cuh"

namespace {

constexpr int D = 16;
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int SEG = quad_walk::SEG;  // slots a quad walks in order
constexpr int AUX_THREADS = 256;

__device__ __forceinline__ float maybe_bf16(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// w * g per component, each rounded to bf16 with round_bf16
__device__ __forceinline__ float4 contrib(float4 w, float gv, int round_bf16) {
  return make_float4(maybe_bf16(__fmul_rn(w.x, gv), round_bf16),
                     maybe_bf16(__fmul_rn(w.y, gv), round_bf16),
                     maybe_bf16(__fmul_rn(w.z, gv), round_bf16),
                     maybe_bf16(__fmul_rn(w.w, gv), round_bf16));
}

// acc += x * gv per component
__device__ __forceinline__ void add_scaled(float4& acc, float4 x, float gv) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, gv));
  acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, gv));
  acc.z = __fadd_rn(acc.z, __fmul_rn(x.z, gv));
  acc.w = __fadd_rn(acc.w, __fmul_rn(x.w, gv));
}

// h1p, h2p: h1, h2 [n + 1][D] with a zero row n; dh1, dh2: [n + 1][D],
// zeroed by the caller (row n of dh2 collects the pad slots, row n of dh1
// nothing); dwc[c] gets chunk c's partials dw1 | dw2 (2 D floats).
__global__ void __launch_bounds__(BWD_THREADS)
nn1_bwd(const float* __restrict__ h1p, const float* __restrict__ h2p,
        const float* __restrict__ w1, const float* __restrict__ w2,
        const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
        const int32_t* __restrict__ ct, const float* __restrict__ g,
        int n_chunks, int C, int n, int round_bf16, float* __restrict__ dh1,
        float* __restrict__ dh2, float* __restrict__ dwc) {
  __shared__ float red[BWD_WARPS * 2 * D];
  const float4* t1 = reinterpret_cast<const float4*>(h1p);
  const float4* t2 = reinterpret_cast<const float4*>(h2p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, quad = lane >> 2;
  const int nseg = C / SEG;

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int t = ct[c];
    const float4 wa = reinterpret_cast<const float4*>(w1 + (size_t)t * D)[q];
    const float4 wb = reinterpret_cast<const float4*>(w2 + (size_t)t * D)[q];
    float4 dw[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                    make_float4(0.f, 0.f, 0.f, 0.f)};
    // warp-uniform: a warp takes 8 consecutive segments, a quad one
    for (int s0 = warp * 8; s0 < nseg; s0 += BWD_WARPS * 8) {
      const int seg = s0 + quad;
      const bool act = seg < nseg;
      quad_walk::segment(
          src, dst, g, (size_t)c * C + (size_t)seg * SEG + 4 * q, act, n, dh1,
          dh2, [&](int s, int dd, float gv, float4& cs, float4& cd) {
            cs = contrib(wa, gv, round_bf16);
            cd = contrib(wb, gv, round_bf16);
            if (act) {
              add_scaled(dw[0], __ldg(t1 + (size_t)s * (D / 4) + q), gv);
              add_scaled(dw[1], __ldg(t2 + (size_t)dd * (D / 4) + q), gv);
            }
          });
    }
    chunk_sums::quad_block_sum<2>(dw, red, dwc + (size_t)c * 2 * D);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/typed_segment.py).  Each
// returns the first CUDA error.

// The forward, nn_fwd.cuh's (B9's) under B7's entry point: h1, h2 [n][16],
// w1, w2 [n_et][16], src, dst 16-byte aligned; `shared` picks the mode
// (the wrapper checks that the score rows fit); items [max_items] int4 and
// rel_items [n_et + 1] the shared mode's plan, scores [n_et][2][n + 1] the
// global mode's table; out [n_chunks, C] float32.
extern "C" int tip_nn1_fwd(const float* h1, const float* h2, const float* w1,
                           const float* w2, const int32_t* src,
                           const int32_t* dst, const int32_t* ct, int n_chunks,
                           int C, int n, int n_et, int shared, int max_items,
                           int blocks, void* items, int32_t* rel_items,
                           float* scores, float* out, void* stream) {
  return nn_fwd::launch(h1, h2, w1, w2, src, dst, ct, n_chunks, C, n, n_et,
                        shared, max_items, blocks, (int4*)items, rel_items,
                        scores, out, (cudaStream_t)stream);
}

// h1p, h2p: h1, h2 [n, 16] with a zero row appended; w1, w2, src, dst and
// g [n_chunks][C] 16-byte aligned, C a multiple of 16; scratch dwc
// [n_chunks, 2, 16]; outputs dh [2, n + 1, 16] (dh1, dh2; row n is
// scratch) and dw [n_et, 2, 16] (dw1, dw2).  `sms`: the card's SM count
// (the grid is as many blocks as fit them at once).
extern "C" int tip_nn1_bwd(const float* h1p, const float* h2p, const float* w1,
                           const float* w2, const int32_t* src,
                           const int32_t* dst, const int32_t* ct,
                           const float* g, int n_chunks, int C, int n,
                           int n_et, int round_bf16, int sms, float* dwc,
                           float* dh, float* dw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t table = (size_t)(n + 1) * D;
  cudaError_t err = cudaMemsetAsync(dh, 0, 2 * table * sizeof(float), s);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn1_bwd,
                                                      BWD_THREADS, 0);
  if (err != cudaSuccess) return err;
  nn1_bwd<<<(per_sm > 1 ? per_sm : 1) * sms, BWD_THREADS, 0, s>>>(
      h1p, h2p, w1, w2, src, dst, ct, g, n_chunks, C, n, round_bf16, dh,
      dh + table, dwc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_sums::by_relation<<<(n_et * 2 * D + AUX_THREADS - 1) / AUX_THREADS,
                            AUX_THREADS, 0, s>>>(dwc, ct, n_chunks, n_et,
                                                 2 * D, dw);
  return cudaGetLastError();
}
