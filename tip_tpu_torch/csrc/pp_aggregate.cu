// Dense P-P aggregate of the GCN for Hopper (sm_90a): out = (A+I) @ x.
//
// Replaces no pl.pallas_call: the JAX package contracts the resident int8
// (A+I) with bf16(dinv * x W) as one XLA dot with bf16 inputs and a float32
// result (tip_tpu/nn/gcn.py:70), whose int8 -> bf16 convert XLA folds into
// the operand read.  torch has no such product: a float32 [N, N] copy of
// (A+I) and float32 GEMMs on it took ~4 ms of a Decagon step on an H100
// (PERF.md), which this kernel removes.  Here
//   out[i, c] = sum_k A[i, k] x[k, c]        (float32 [N, D], D = 8, 16, 32)
// with A the int8 [N, N] matrix as it lies (row stride N, any N) and x
//   * bf16 (the forward: x = bf16(dinv * h), one term), or
//   * float32 (the backward: the gradient, A symmetric so A^T g = A g),
//     split exactly into three bf16 terms, x = hi + mid + lo (split3).
// Every product a * x_term is exact in float32 and the sums are float32,
// as in the float32 GEMM the kernel replaces: the stated precision (bf16
// operands, float32 sums) is kept.  out is float32, or its bf16 rounding
// (out_bf16, the gradient of a bf16 input).  Any width d runs: the wrapper
// zero-pads x's columns up to the next D and cuts an x wider than 32 into
// column blocks of 32 (an output column reads its own x column alone, so
// the padding changes none of its bits).
//
// Design.  The kernel streams A's bytes, 364 MB at Decagon shape, once a
// product; everything else is small.
//  * stage_x, a first pass, writes x as the bf16 tiles the main pass reads:
//    [P][k tile][D][BK], P terms, each k tile of BK rows transposed to D rows
//    of BK values in the order the lanes read them (below), zero past N.
//  * aggregate: a block owns BM = 256 rows (8 warps x 2 m16 tiles, each
//    warp its own 32 rows) and one of KS contiguous ranges of k tiles; its
//    STAGES-deep cp.async ring holds a stage of BM A rows x BK bytes and the
//    x tiles of those BK k.  Row i's span starts at byte i N + k0 of the
//    flat matrix, at any alignment.  Each warp copies its rows as the nine
//    aligned 16-byte chunks that cover each span (cp.async.cg, with an L2
//    hint to fetch 256 bytes: the row's next stage reads the rest), and
//    reads the span back at its shift s_i = (i N) mod 16, the same for every
//    k tile of the row: word s_i / 4 on, byte s_i mod 4 in.  (Copies of 4
//    bytes into word-aligned rows, free of bank conflicts, streamed A alone
//    at 1.5 TB/s on an H100 against 2.0 TB/s for these, and 0.9 against 1.5
//    with the products; the 16-byte rows cost some 2-way bank conflicts on
//    the A words.)
//  * The products run on the tensor cores as mma.sync m16n8k16 bf16 with
//    float32 accumulators.  Lane (g, q) of a warp (g = lane / 4, q = lane %
//    4) feeds the k slots 2q, 2q+1, 2q+8, 2q+9 of every step; the kernel
//    maps them, in step s of a stage, to the four consecutive bytes at
//    32 q + 4 s of the row, so that a lane walks 32 consecutive bytes a
//    stage and loads each 32-bit word of its rows once.  The int8 values
//    become bf16 pairs in registers, exactly: one prmt picks two bytes at
//    the row's byte shift b_i, and (128 + low 7 bits) - (128 or 256 for
//    the sign bit) is formed as two bf16x2 bit patterns and one
//    subtraction.  The x tile holds the same k order, so each lane reads
//    its B fragment with one 8-byte load, free of bank conflicts (row
//    pitch 72 words).
//  * Each block writes its [BM, D] partial sums; sum_splits adds the KS
//    partials of every element in split order and writes out.  No atomics:
//    the result is deterministic.
//  The wrapper (ops/pp_aggregate.py) picks KS from the card's SM count so
//  that every SM gets about the same number of blocks (one resident each).
//
// split3 (truncation): hi = x with its low 16 bits cleared, mid the same of
// x - hi, lo = x - hi - mid; each subtraction is exact and lo has at most 8
// significant bits, so hi + mid + lo = x whenever x's last bit lies at or
// above 2^-133, bf16's least subnormal: |x| >= 2^-110.  Below that, lo may
// lose the bits of x under 2^-133.  A NaN or an infinity gives NaN terms
// (the float32 GEMM's 0 * inf is NaN as well).
//
// Bound on an H100 at Decagon shape (N = 19,081, D = 32 or 16): reading A
// takes 0.109 ms at 3.35 TB/s; 2 N^2 D operations (three times that in
// the backward) are 23.3 / 69.9 GFLOP at D = 32, well under the byte time
// on the bf16 tensor cores.  chip_smoke.py reckons the bound from its run.
// Measured there: 0.22 / 0.19 ms forward and 0.30 / 0.21 backward at
// D = 32 / 16; A's scattered 144-byte spans stream at ~2 TB/s, and the
// three-term backward leans on mma.sync's rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_math.cuh"

namespace pp_aggregate {

using tile_math::cp_async16;
using tile_math::cp_async_commit;
using tile_math::cp_async_wait;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 2;                  // m16 tiles a warp
constexpr int BM = WARPS * MT * 16;    // rows a block
constexpr int BK = 128;                // k a stage
constexpr int CHUNKS = BK / 16 + 1;    // 16-byte chunks a staged A row
constexpr int AWORDS = 4 * CHUNKS;     // its 32-bit words
constexpr int XPITCH = BK + 16;        // bf16 a staged x row (288 bytes)
constexpr int A_STAGE = BM * AWORDS * 4;

template <int D, int P>
struct Shape {
  static constexpr int STAGES = P == 1 ? 4 : 3;
  static constexpr int X_STAGE = P * D * XPITCH * 2;
  static constexpr int STAGE = A_STAGE + X_STAGE;
  static constexpr int SMEM = STAGES * STAGE;
};

// the k of position p of a staged x row: lane q's step s reads positions
// 16 s + 4 q .. + 3, which hold k = 32 q + 4 s .. + 3
__host__ __device__ __forceinline__ int k_of(int p) {
  return 32 * ((p >> 2) & 3) + 4 * (p >> 4) + (p & 3);
}

// Start copying the 16-byte chunk at src (16-byte aligned) into dst, the
// bytes before `end` only (the rest zero-filled): the matrix may end inside
// a chunk.  L2::256B: a miss fetches the 256 bytes around it.
__device__ __forceinline__ void cp_async_chunk(void* dst, const uint8_t* src,
                                               const uint8_t* end) {
  if (src >= end) return;
  const int bytes = end - src < 16 ? (int)(end - src) : 16;
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// bytes 0 and 2 of t (int8) as a bf16 pair, exactly
__device__ __forceinline__ uint32_t int8_pair(uint32_t t) {
  const uint32_t low = (t & 0x007f007fu) | 0x43004300u;  // 128 + (v & 127)
  const uint32_t sgn = (t & 0x00800080u) | 0x43004300u;  // 128 or 256
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&low),
              *reinterpret_cast<const __nv_bfloat162*>(&sgn));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split3(float x, uint16_t (&t)[3]) {
  const uint32_t u = __float_as_uint(x);
  const float r = __fsub_rn(x, __uint_as_float(u & 0xffff0000u));
  const uint32_t ur = __float_as_uint(r);
  const float l = __fsub_rn(r, __uint_as_float(ur & 0xffff0000u));
  t[0] = (uint16_t)(u >> 16);
  t[1] = (uint16_t)(ur >> 16);
  t[2] = (uint16_t)(__float_as_uint(l) >> 16);
}

// xt[P][ktiles][D][BK]: one thread a (k tile, position)
template <int D, int P>
__global__ void __launch_bounds__(256)
stage_x(const void* __restrict__ x, int n, int ktiles,
        uint16_t* __restrict__ xt) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ktiles * BK) return;
  const int kt = idx / BK, p = idx - kt * BK;
  const int k = kt * BK + k_of(p);
  const size_t plane = (size_t)ktiles * D * BK;
  uint16_t* dst = xt + (size_t)kt * D * BK + p;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    uint16_t t[3] = {0, 0, 0};
    if (k < n) {
      if (P == 1)
        t[0] = static_cast<const uint16_t*>(x)[(size_t)k * D + c];
      else
        split3(static_cast<const float*>(x)[(size_t)k * D + c], t);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) dst[j * plane + (size_t)c * BK] = t[j];
  }
}

// part[ks][n][D]: block (row block, split) sums its k tiles
template <int D, int P>
__global__ void __launch_bounds__(THREADS, 1)
aggregate(const uint8_t* __restrict__ a, int n, int ktiles, int ks,
          const uint16_t* __restrict__ xt, float* __restrict__ part) {
  using S = Shape<D, P>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* a_end = a + (size_t)n * n;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int kt0 = (int)((long long)split * ktiles / ks);
  const int nk = (int)((long long)(split + 1) * ktiles / ks) - kt0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)ktiles * D * BK;

  auto load = [&](int buf, int kt) {
    uint8_t* as = smem + buf * S::STAGE;
    for (int c = lane; c < MT * 16 * CHUNKS; c += 32) {  // the warp's rows
      const int rr = c / CHUNKS, w = c - rr * CHUNKS;
      const int r = (warp * MT) * 16 + rr;
      if (row0 + r >= n) continue;
      const uintptr_t span =
          (uintptr_t)(a + (size_t)(row0 + r) * n + (size_t)kt * BK);
      cp_async_chunk(as + r * AWORDS * 4 + 16 * w,
                     reinterpret_cast<const uint8_t*>(span & ~(uintptr_t)15) +
                         16 * w,
                     a_end);
    }
    uint8_t* xs = as + A_STAGE;
    for (int c = tid; c < P * D * (BK / 8); c += THREADS) {
      const int pr = c / (BK / 8), w = c - pr * (BK / 8);  // pr = j D + col
      const int j = pr / D, col = pr - j * D;
      cp_async16(xs + pr * XPITCH * 2 + 16 * w,
                 xt + j * plane + ((size_t)kt * D + col) * BK + 8 * w);
    }
  };

  // this lane's rows: m tile i, half h (row g or g + 8)
  const int g = lane >> 2, q = lane & 3;
  int woff[MT][2];
  uint32_t sel0[MT][2], sel1[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp * MT + i) * 16 + g + 8 * h;
      const uint32_t s = (uint32_t)(((size_t)(row0 + r) * n) & 15);
      woff[i][h] = r * AWORDS + (int)(s >> 2) + 8 * q;
      const uint32_t b = s & 3;
      sel0[i][h] = b | b << 4 | (b + 1) << 8 | (b + 1) << 12;
      sel1[i][h] = (b + 2) | (b + 2) << 4 | (b + 3) << 8 | (b + 3) << 12;
    }
  float acc[MT][D / 8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

#pragma unroll
  for (int st = 0; st < S::STAGES - 1; ++st) {
    if (st < nk) load(st, kt0 + st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();
    {
      const int nx = it + S::STAGES - 1;
      if (nx < nk) load(nx % S::STAGES, kt0 + nx);
      cp_async_commit();
    }
    const uint8_t* as = smem + (it % S::STAGES) * S::STAGE;
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(as);
    const uint8_t* xs = as + A_STAGE;
    uint32_t prev[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) prev[i][h] = aw[woff[i][h]];
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      uint32_t b[P][D / 8][2];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int t = 0; t < D / 8; ++t) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              xs + ((j * D + 8 * t + g) * XPITCH + 16 * s + 4 * q) * 2);
          b[j][t][0] = v.x;
          b[j][t][1] = v.y;
        }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t af[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t nxt = aw[woff[i][h] + s + 1];
          af[h] = int8_pair(prmt(prev[i][h], nxt, sel0[i][h]));
          af[2 + h] = int8_pair(prmt(prev[i][h], nxt, sel1[i][h]));
          prev[i][h] = nxt;
        }
#pragma unroll
        for (int j = P - 1; j >= 0; --j)  // the small terms first
#pragma unroll
          for (int t = 0; t < D / 8; ++t)
            mma(acc[i][t], af, b[j][t][0], b[j][t][1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (warp * MT + i) * 16 + g + 8 * h;
      if (row >= n) continue;
      float* dst = part + ((size_t)split * n + row) * D + 2 * q;
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
        *reinterpret_cast<float2*>(dst + 8 * t) =
            make_float2(acc[i][t][2 * h], acc[i][t][2 * h + 1]);
    }
}

// out[e] = part[0][e] + part[1][e] + ... in split order; four elements a
// thread (m = n D is a multiple of 8)
__global__ void __launch_bounds__(256)
sum_splits(const float* __restrict__ part, int ks, size_t m,
           float* __restrict__ out, __nv_bfloat16* __restrict__ out_bf16) {
  const size_t e = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= m) return;
  float4 s = *reinterpret_cast<const float4*>(part + e);
  for (int j = 1; j < ks; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(part + j * m + e);
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z);
    s.w = __fadd_rn(s.w, v.w);
  }
  if (out_bf16) {
    out_bf16[e] = __float2bfloat16_rn(s.x);
    out_bf16[e + 1] = __float2bfloat16_rn(s.y);
    out_bf16[e + 2] = __float2bfloat16_rn(s.z);
    out_bf16[e + 3] = __float2bfloat16_rn(s.w);
  } else {
    *reinterpret_cast<float4*>(out + e) = s;
  }
}

template <int D, int P>
cudaError_t run(const int8_t* a, int n, const void* x, int ks, uint16_t* xt,
                float* part, void* out, int out_bf16, cudaStream_t st) {
  using S = Shape<D, P>;
  const int ktiles = (n + BK - 1) / BK;
  stage_x<D, P><<<(ktiles * BK + 255) / 256, 256, 0, st>>>(x, n, ktiles, xt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(aggregate<D, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, ks);
  aggregate<D, P><<<grid, THREADS, S::SMEM, st>>>(
      reinterpret_cast<const uint8_t*>(a), n, ktiles, ks, xt, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t m = (size_t)n * D;
  sum_splits<<<(unsigned)((m / 4 + 255) / 256), 256, 0, st>>>(
      part, ks, m, out_bf16 ? nullptr : static_cast<float*>(out),
      out_bf16 ? static_cast<__nv_bfloat16*>(out) : nullptr);
  return cudaGetLastError();
}

}  // namespace pp_aggregate

// Plain C entry point (bound with ctypes by ops/pp_aggregate.py).  a: int8
// [n, n], 16-byte aligned; x: [n, d] bf16 (x_f32 = 0) or float32 (x_f32 =
// 1); d 8, 16 or 32; ks in [1, ceil(n / 128)]; scratch xt: 3 ceil(n / 128) 128
// d uint16 (x_f32) or a third of that, part: ks n d floats; out: [n, d]
// float32, or bf16 with ob (out_bf16).  Returns the first CUDA error
// (cudaErrorInvalidValue for a width it has no instance of).
extern "C" int tip_pp_aggregate(const int8_t* a, int n, const void* x, int d,
                                int x_f32, int ks, uint16_t* xt, float* part,
                                void* out, int ob, void* stream) {
  using namespace pp_aggregate;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 32 && !x_f32) return run<32, 1>(a, n, x, ks, xt, part, out, ob, s);
  if (d == 32) return run<32, 3>(a, n, x, ks, xt, part, out, ob, s);
  if (d == 16 && !x_f32) return run<16, 1>(a, n, x, ks, xt, part, out, ob, s);
  if (d == 16) return run<16, 3>(a, n, x, ks, xt, part, out, ob, s);
  if (d == 8 && !x_f32) return run<8, 1>(a, n, x, ks, xt, part, out, ob, s);
  if (d == 8) return run<8, 3>(a, n, x, ks, xt, part, out, ob, s);
  return cudaErrorInvalidValue;
}
