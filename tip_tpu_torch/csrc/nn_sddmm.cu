// NN-decoder SDDMM over chunk-aligned typed edges for Hopper (sm_90a):
// one logit per edge slot, forward and backward.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_sddmm2.py
// (nn_logits_padded2: _nn2_fwd_kernel, _nn2_bwd_kernel):
//   logit[c, j] = h1[src] . w1[t] + h2[dst] . w2[t],   t = ct[c]
//   dh1[src] += g w1[t];  dh2[dst] += g w2[t]
//   dw1[t] += g h1[src];  dw2[t] += g h2[dst]
// over src/dst [n_chunks, C] int32 with pad slots at dst = n, chunk_type
// [n_chunks] non-decreasing.  Node id n reads a zero row, so a pad slot's
// dst term is exactly 0; its src term is whatever the pad src reads (the
// caller masks it, as in the JAX package).  With round_bf16 (h1, h2 come
// in bf16-rounded from the wrapper) each scattered dh contribution
// g * w[t][k] is rounded to bf16, as the TPU kernel's casts do;
// accumulation is float32.  The width is 16 (DR-NN's nn_decoder_l1_dim;
// the wrapper refuses others).
//
// Design.  w1[t] and w2[t] are constant over a relation's chunks, so both
// directions factor through per-(relation, node) scalars.  The work is
// cut into items: runs of at most ITEM_CHUNKS chunks of one relation, a
// relation of m chunks into ceil(m / ITEM_CHUNKS) near-equal runs, so a
// relation that holds a quarter of the slots is cut up like the rest.
// nn_plan (one block) lists them from chunk_type on every call: items[i]
// = (t, first chunk, end chunk), rel_items[t] = t's first item.
//   forward:  (nn_fwd.cuh, which B7 launches too) a block takes an item,
//             builds the relation's two score rows
//             s1[v] = h1[v] . w1[t] and s2[v] = h2[v] . w2[t] (v <= n) in
//             shared memory, and writes logit = s1[src] + s2[dst] for the
//             item's slots, 16 bytes of src, dst and logits a thread.  The
//             first version wrote an [n_et][2][n + 1] table of every score
//             and gathered two scalars a slot from it: a 32-byte L2 sector
//             for 4 useful bytes each.  dot16's order of fmaf is kept, so
//             the logits are those of the first version bit for bit;
//   backward: a block takes an item and sums g by endpoint, G1[v] over the
//             item's slots with src = v and G2[v] over dst = v: half its
//             warps the src side, half the dst side, each warp into its own
//             vector in shared memory with no atomics (warp_add), 128 slots
//             at a time, the next 128 loading meanwhile; a side's vectors
//             are added in warp order into the item's row of an [items][2]
//             [n + 1] table.  Then dw1[t] = sum over t's items of G1 . h1,
//             dh1 = sum over items of G1 (x) w1[t], and the same for side
//             2, are fixed-order contractions, both sides in one launch
//             (contract.cuh).  The backward is deterministic.  Its cost is
//             warp_add's conflict test on unsorted keys (the negatives',
//             the positives' src side): __match_any_sync, which a bitmap
//             test skips where a warp's keys all differ (PERF.md).  With
//             round_bf16 the per-slot rounding does not factor: dh is
//             scattered by quad_walk.cuh's lane quads (B8's backward), four
//             float4 reductions a slot and side with run sums, instead of
//             the first version's 16 float atomics a slot and side (12.7
//             ms at Decagon shape); dw still comes from G.
// Up to 29,055 nodes (2 (n + 1) floats) the score rows and the warps'
// vectors live in shared memory, as many warps a side as fit up to 8 (the
// "shared" mode; the backward's from 28,800 nodes on take the global
// mode, as its warps' bitmaps need 2 KB beside them); beyond it the
// forward writes the score table and gathers from it, and the backward
// gives an item one warp a side that adds into the item's row of the table
// in device memory, again without atomics (the "global" mode).  No gathered endpoint rows are saved for
// the backward (the TPU kernel keeps two [n_chunks, 16, C] residuals).
//
// Bound on an H100 at Decagon shape (9.02 M slots): the forward must read
// src and dst and write the logit, 12 bytes a slot (108 MB, ~0.032 ms at
// 3.35 TB/s); the backward reads src, dst and g, 12 bytes a slot.  The
// 4 x 16 float operations a slot of the per-slot formula take ~0.009 ms at
// 67 TFLOP/s, so bytes bound both ways.  chip_smoke.py reckons the bounds
// from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "contract.cuh"
#include "nn_fwd.cuh"
#include "quad_walk.cuh"

namespace {

using nn_fwd::D;
using nn_fwd::FULL;
using nn_fwd::plan;
constexpr int GSUM_WARPS = 8;  // most warps a side of a backward block
constexpr int SMEM_BYTES = 227 * 1024;  // shared memory a block can use
constexpr int BITMAP_BYTES = 2 * GSUM_WARPS * 32 * 4;  // nn_gsum's static
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_WARPS = SCATTER_THREADS / 32;

// acc[key] += v for every active lane, where acc is this warp's own
// vector: lanes with equal keys add in lane order, so no two lanes write
// one entry at once and the sums do not depend on the schedule.  Where the
// keys rise across the lanes (the dst-sorted positives) a segmented scan,
// its runs found from their heads by ballot, leaves each run's sum to its
// last lane.  Else each lane sets bit key mod 1024 of the warp's bitmap
// (bits, 32 words, zero on entry and on return); where none finds its bit
// set, the keys differ and each lane adds its own; else one rank of equal
// keys at a time (__match_any_sync).  All lanes call it.
__device__ __forceinline__ void warp_add(float* acc, unsigned* bits, int key,
                                         float v, bool act) {
  const int lane = threadIdx.x & 31;
  const int k = act ? key : INT_MAX;
  const int prev = __shfl_up_sync(FULL, k, 1);
  if (__all_sync(FULL, lane == 0 || prev <= k)) {
    const int next = __shfl_down_sync(FULL, k, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != k);
    const int head = 31 - __clz(heads & (FULL >> (31 - lane)));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, v, off);
      if (lane - off >= head) v = __fadd_rn(v, o);
    }
    if (act && (lane == 31 || next != k)) acc[key] = __fadd_rn(acc[key], v);
  } else {
    const unsigned bit = 1u << (key & 31);
    const bool clash =
        act && (atomicOr(bits + ((key >> 5) & 31), bit) & bit);
    const bool any = __any_sync(FULL, clash);
    bits[lane] = 0u;
    if (!any) {
      if (act) acc[key] = __fadd_rn(acc[key], v);
    } else {
      const unsigned seg = __match_any_sync(FULL, k);
      const unsigned rank = __popc(seg & ((1u << lane) - 1u));
      const unsigned rounds = __reduce_max_sync(FULL, rank);
      for (unsigned r = 0; r <= rounds; ++r) {
        if (act && rank == r) acc[key] = __fadd_rn(acc[key], v);
        __syncwarp();
      }
    }
  }
  __syncwarp();
}

// Block b takes item b: gs[b][0][v] = sum of g over its slots with src = v,
// gs[b][1][v] over dst = v (entry n of side 1 collects the pad slots).
// The block's first half of warps sums the src side, the second half the
// dst side.  SHARED: each warp sums into its own vector in shared memory,
// a side's vectors added in warp order at the end; else the block is one
// warp a side, adding into gs[b], zeroed by the caller.  A side's warp w of
// W takes 128 slots at a time, w, w + W, ..., 16 bytes of keys and g a
// lane (lane l slots 4l .. 4l + 3), the next 128 loading while these are
// added, in four steps of one slot a lane (step j: slots 4l + j, still in
// slot order across the lanes).
template <bool SHARED>
__global__ void __launch_bounds__(2 * GSUM_WARPS * 32)
nn_gsum(const int4* __restrict__ items, const int32_t* __restrict__ rel_items,
        int n_et, const int32_t* __restrict__ src,
        const int32_t* __restrict__ dst, const float* __restrict__ g, int C,
        int n, float* __restrict__ gs) {
  extern __shared__ float vecs[];  // [2][warps][n + 1] (SHARED)
  __shared__ unsigned bitmaps[2 * GSUM_WARPS * 32];  // warp_add's
  const int b = blockIdx.x;
  if (b >= rel_items[n_et]) return;
  const int4 it = items[b];
  const int warps = blockDim.x >> 6;  // a side's
  const int side = (threadIdx.x >> 5) >= warps;
  const int warp = (threadIdx.x >> 5) - side * warps;
  const int lane = threadIdx.x & 31;
  const int len = n + 1;
  float* out = gs + ((size_t)b * 2 + side) * len;
  float* mine = SHARED ? vecs + ((size_t)side * warps + warp) * len : out;
  unsigned* bits = bitmaps + (threadIdx.x >> 5) * 32;
  bits[lane] = 0u;
  __syncwarp();
  const int32_t* keys = side ? dst : src;
  if (SHARED) {
    for (int v = threadIdx.x; v < 2 * warps * len; v += blockDim.x)
      vecs[v] = 0.f;
    __syncthreads();
  }
  const size_t end = (size_t)it.z * C;  // C is a multiple of 16
  const size_t stride = (size_t)warps * 128;
  size_t e = (size_t)it.y * C + warp * 128 + 4 * lane;
  int4 k4 = side ? make_int4(n, n, n, n) : make_int4(0, 0, 0, 0);
  float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < end) {
    k4 = *reinterpret_cast<const int4*>(keys + e);
    g4 = *reinterpret_cast<const float4*>(g + e);
  }
  for (size_t base = (size_t)it.y * C + warp * 128; base < end;
       base += stride) {  // whole warps
    const bool act = e < end;
    const int4 kc = k4;
    const float4 gc = g4;
    e += stride;
    if (e < end) {
      k4 = *reinterpret_cast<const int4*>(keys + e);
      g4 = *reinterpret_cast<const float4*>(g + e);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      warp_add(mine, bits, quad_walk::pick(kc, j), quad_walk::pick(gc, j),
               act);
  }
  if (SHARED) {
    __syncthreads();
    for (int v = threadIdx.x; v < 2 * len; v += blockDim.x) {
      const int sd = v >= len, u = v - sd * len;
      const float* col = vecs + (size_t)sd * warps * len + u;
      float r = col[0];
      for (int w = 1; w < warps; ++w) r = __fadd_rn(r, col[(size_t)w * len]);
      gs[(size_t)b * 2 * len + v] = r;
    }
  }
}

// round_bf16 mode: dh1[src] += bf16(g * w1[t]), dh2[dst] += bf16(g * w2[t])
// into zeroed [n + 1][16] tables (row n collects the pad slots), a lane
// quad a slot (quad_walk.cuh).  Persistent blocks walk the chunks.
__global__ void __launch_bounds__(SCATTER_THREADS)
nn_scatter_bf16(const float* __restrict__ w1, const float* __restrict__ w2,
                const int32_t* __restrict__ src,
                const int32_t* __restrict__ dst,
                const int32_t* __restrict__ ct, const float* __restrict__ g,
                int n_chunks, int C, int n, float* __restrict__ dh1,
                float* __restrict__ dh2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, quad = lane >> 2;
  const int nseg = C / quad_walk::SEG;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int t = ct[c];
    const float4 wa = reinterpret_cast<const float4*>(w1 + (size_t)t * D)[q];
    const float4 wb = reinterpret_cast<const float4*>(w2 + (size_t)t * D)[q];
    // warp-uniform: a warp takes 8 consecutive segments, a quad one
    for (int s0 = warp * 8; s0 < nseg; s0 += SCATTER_WARPS * 8) {
      const int seg = s0 + quad;
      quad_walk::segment(
          src, dst, g, (size_t)c * C + (size_t)seg * quad_walk::SEG + 4 * q,
          seg < nseg, n, dh1, dh2,
          [&](int, int, float gv, float4& cs, float4& cd) {
            cs = make_float4(
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wa.x))),
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wa.y))),
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wa.z))),
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wa.w))));
            cd = make_float4(
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wb.x))),
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wb.y))),
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wb.z))),
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wb.w))));
          });
    }
  }
}

// most warps a side (each a vector of n + 1 floats, both sides' in one
// block) that fit a block, up to GSUM_WARPS
int gsum_warps(int n) {
  const int per = 2 * (n + 1) * (int)sizeof(float);
  const int w = (SMEM_BYTES - BITMAP_BYTES) / per;
  return w < GSUM_WARPS ? w : GSUM_WARPS;
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/sddmm2.py).  h1, h2
// [n][16], w1, w2 [n_et][16] float32, 16-byte aligned; src, dst
// [n_chunks][C], ct [n_chunks] int32, src and dst 16-byte aligned, C a
// multiple of 16.  Scratch items [max_items] int4 and rel_items [n_et + 1]
// int32, max_items >= the items' count (ops/sddmm2.py: nn_max_items).  Each
// returns the first CUDA error.

// `shared` picks the forward's mode (the wrapper checks that the score
// rows fit); scores: the global mode's scratch [n_et][2][n + 1] (null in
// the shared mode); out [n_chunks][C] float32; blocks: the global mode's
// gather grid.
extern "C" int tip_nn_fwd(const float* h1, const float* h2, const float* w1,
                          const float* w2, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, int n_chunks,
                          int C, int n, int n_et, int shared, int max_items,
                          int blocks, void* items, int32_t* rel_items,
                          float* scores, float* out, void* stream) {
  return nn_fwd::launch(h1, h2, w1, w2, src, dst, ct, n_chunks, C, n, n_et,
                        shared, max_items, blocks, (int4*)items, rel_items,
                        scores, out, (cudaStream_t)stream);
}

// `shared` picks where the backward's vectors live (the wrapper checks
// that one pair fits).  g [n_chunks][C]; scratch gs [max_items][2][n + 1]
// (zeroed here in the global mode) and the contractions' slab partials
// slab_part [2][slabs][n][16] (slabs = ceil(max_items / contract::SLAB));
// outputs dw1, dw2 [n_et][16] and dh1, dh2 [n + 1][16] (row n is
// scratch).  blocks: the scatter grid of the round_bf16 mode.
extern "C" int tip_nn_bwd(const float* h1, const float* h2, const float* w1,
                          const float* w2, const int32_t* src,
                          const int32_t* dst, const int32_t* ct, const float* g,
                          int n_chunks, int C, int n, int n_et, int round_bf16,
                          int shared, int max_items, int slabs, int blocks,
                          void* items, int32_t* rel_items, float* gs,
                          float* slab_part, float* dw1, float* dw2, float* dh1,
                          float* dh2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  int4* it = (int4*)items;
  if ((err = plan(ct, n_chunks, n_et, max_items, it, rel_items, s)) !=
      cudaSuccess)
    return err;
  const int len = 2 * (n + 1);
  if (max_items > 0) {
    const int warps = gsum_warps(n);
    if (shared && warps > 0) {
      const int smem = warps * len * (int)sizeof(float);
      err = cudaFuncSetAttribute(
          nn_gsum<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      nn_gsum<true><<<max_items, 2 * warps * 32, smem, s>>>(
          it, rel_items, n_et, src, dst, g, C, n, gs);
    } else {
      err = cudaMemsetAsync(gs, 0, (size_t)max_items * len * sizeof(float), s);
      if (err != cudaSuccess) return err;
      nn_gsum<false><<<max_items, 64, 0, s>>>(it, rel_items, n_et, src, dst, g,
                                              C, n, gs);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const contract::Items its{it, rel_items};
  float* oh1 = round_bf16 ? nullptr : dh1;
  float* oh2 = round_bf16 ? nullptr : dh2;
  err = contract::run({gs, len, h1, w1, dw1, oh1},
                      {gs + (n + 1), len, h2, w2, dw2, oh2}, its, n_et, n,
                      slabs, slab_part, s);
  if (err != cudaSuccess || !round_bf16) return err;
  err = cudaMemsetAsync(dh1, 0, (size_t)(n + 1) * D * sizeof(float), s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(dh2, 0, (size_t)(n + 1) * D * sizeof(float), s);
  if (err != cudaSuccess) return err;
  nn_scatter_bf16<<<blocks, SCATTER_THREADS, 0, s>>>(w1, w2, src, dst, ct, g,
                                                     n_chunks, C, n, dh1, dh2);
  return cudaGetLastError();
}
