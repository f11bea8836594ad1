// The lane-quad scatter walk shared by the backwards of the chunked SDDMMs
// (distmult_bwd.cuh, kernels B8 and B6; nn_sddmm.cu, kernel B9 with bf16
// rounding; nn_sddmm_v1.cu, kernel B7).  A quad of lanes takes one slot at
// a time, lane q of the quad holding features 4q .. 4q + 3 of the slot's
// 16-wide contributions, so a slot's 16 scatters to a row are four 16-byte
// reductions to consecutive addresses (red.global.add.v4.f32 through
// atomicAdd(float4*), sm_90) into a device-memory table that L2 holds;
// never shared-memory float atomics, which are compare-and-swap loops on
// this card.  A quad walks SEG consecutive slots of a chunk in order and
// keeps a run sum a side: while its slots' src (dst) stays the same row it
// adds their contributions in registers and reduces the run's total once
// (the positives are dst-sorted inside a chunk, and the pad tail is one
// run a side).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace quad_walk {

constexpr int D = 16;    // the rows' width
constexpr int SEG = 16;  // slots a quad walks in order
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// v.x, v.y, v.z or v.w (i a constant once the caller's loop is unrolled)
__device__ __forceinline__ int pick(int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float pick(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The quad's four lanes (q = lane & 3) add a run's total to row r.
__device__ __forceinline__ void reduce_row(float* tab, int r, int q, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(tab + (size_t)r * D) + q, v);
}

// The quad of this lane walks the SEG slots at off (lane q of the quad
// loads slots 4q .. 4q + 3; src, dst and g 16-byte aligned there) in order.
// contrib(s, d, gv, cs, cd) gives slot (src s, dst d, cotangent gv)'s
// contributions to rows s (cs) and d (cd), this lane's four features; their
// runs go into tab_s and tab_d ([n + 1][16]; an inactive quad, act false,
// adds nothing).  Every lane of the warp calls it.
template <class F>
__device__ __forceinline__ void segment(const int32_t* __restrict__ src,
                                        const int32_t* __restrict__ dst,
                                        const float* __restrict__ g,
                                        size_t off, bool act, int n,
                                        float* tab_s, float* tab_d,
                                        F&& contrib) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  int4 s4 = make_int4(0, 0, 0, 0), d4 = make_int4(n, n, n, n);
  float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (act) {
    s4 = *reinterpret_cast<const int4*>(src + off);
    d4 = *reinterpret_cast<const int4*>(dst + off);
    g4 = *reinterpret_cast<const float4*>(g + off);
  }
  int rs = -1, rd = -1;  // the rows of the open runs
  float4 as = make_float4(0.f, 0.f, 0.f, 0.f), ad = as;
#pragma unroll
  for (int it = 0; it < SEG; ++it) {
    const int from = (lane & ~3) | (it >> 2);
    const int s = __shfl_sync(FULL, pick(s4, it & 3), from);
    const int dd = __shfl_sync(FULL, pick(d4, it & 3), from);
    const float gv = __shfl_sync(FULL, pick(g4, it & 3), from);
    float4 cs, cd;
    contrib(s, dd, gv, cs, cd);
    if (s == rs) {
      as = add4(as, cs);
    } else {
      if (act && rs >= 0) reduce_row(tab_s, rs, q, as);
      rs = s;
      as = cs;
    }
    if (dd == rd) {
      ad = add4(ad, cd);
    } else {
      if (act && rd >= 0) reduce_row(tab_d, rd, q, ad);
      rd = dd;
      ad = cd;
    }
  }
  if (act) {
    reduce_row(tab_s, rs, q, as);
    reduce_row(tab_d, rd, q, ad);
  }
}

}  // namespace quad_walk
