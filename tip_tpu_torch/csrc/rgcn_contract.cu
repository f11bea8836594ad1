// The R-GCN's M-first contraction over the int8 strips for Hopper (sm_90a):
//   forward   M[b, c]  = sum_t A[t, b] S[t, c]        (float32 [Bt, C])
//   backward  dA[t, b] = sum_c S[t, c] dM[b, c]       (float32 [R, Bt])
// with S the resident int8 strips [R, 128 totcols] as they lie (C = 128
// totcols columns, a multiple of 16,384), A = bf16(att_cat) [R, Bt] and dM
// M's float32 gradient.
//
// Replaces no pl.pallas_call: the JAX package contracts bf16(att_cat) with
// the strips as one XLA dot with bf16 inputs and a float32 result
// (tip_tpu/nn/rgcn.py:203), whose int8 -> bf16 convert XLA folds into the
// operand read.  torch has no such product: a float32 copy of the strips
// (1.5 GB at Decagon shape, kept for the backward) and two float32 SIMT
// GEMMs on it took ~3.7 ms of a Decagon step on an H100 (PERF.md), which
// this kernel removes.  The stated precision is kept: bf16 operands and
// float32 sums.
//  * Forward: every int8 x bf16 product is exact.  Each mma.sync m16n8k16
//    (16 relations) multiplies into a fresh zero accumulator, and its
//    partial is added into the running float32 sum with a round-to-nearest
//    add, relation groups in order: the tensor cores' truncating
//    accumulation never runs across groups.  A sum of exact products that
//    float32 holds comes out exact, as in the float32 GEMM it replaces.
//  * Backward: dM is split exactly into three bf16 terms (split3, as
//    B12's), so every product stays exact; the tensor cores sum a block's
//    column slab, the slabs' partials are added in slab order by sum_slabs
//    (no atomics: reruns are bit-equal).  The gradient of the bf16 att is
//    the bf16 rounding of this float32 dA (autograd's cast).
//
// Design.  The bytes of S (377 MB at Decagon shape) bound both passes.
//  * fwd: a block owns 256 columns (8 warps x 32) and walks every relation
//    in stages of 32 through a 4-deep cp.async ring (strip rows padded to
//    272 bytes: free of bank conflicts).  MMA rows are columns, MMA columns
//    bases, k relations.  Lane (g, q) reads the 32-bit word of columns 4g ..
//    4g + 3 of its warp's 32 in rows 2q, 2q + 1, 2q + 8, 2q + 9 of a k16
//    step; m16 tile i's row g + 8h is column 4g + 2i + h, so one prmt of two
//    rows' words gives the byte pairs of a tile's rows g and g + 8, which
//    int8_pair turns into bf16 pairs exactly.  The att fragments are staged
//    once by stage_att in the order the lanes read them (one 16-byte load a
//    pair of n8 tiles).  The layout puts a lane's four columns of one base
//    side by side: each warp stores float4 rows of M, 128 bytes a base.
//  * bwd: wgmma (the three-term products are 145 GFLOP at Decagon shape: on
//    mma.sync they took 0.63 ms, held by the instruction count).  MMA rows
//    are relations, MMA columns bases, k columns.  A block is two warpgroups,
//    each 128 / Bt groups of 64 relations by all Bt bases (64 accumulators a
//    thread), for one slab of columns, in stages of 64 columns through a
//    4-deep cp.async ring holding the strip bytes and dM's float32 rows.
//    Each stage's dM values are split once for the block, a stage ahead, into
//    double-buffered K-major B tiles in shared memory (wgmma_tf32.cuh's
//    layout, a 32-bit word holding two k slots).  A comes from registers,
//    converted from the strip bytes a k16 step at a time, each step's
//    conversion while the steps before it multiply.  In a k16 step lane q's k
//    slots 2q, 2q+1, 2q+8, 2q+9 are the columns 4q, 4q+2, 4q+1, 4q+3: one
//    32-bit word of a strip row gives a row's two A registers (bytes 0, 2 and
//    1, 3).  Rows past R are zero in the ring, and every group multiplies (a
//    branch around a wgmma serializes them). blockIdx.x is the relation tile,
//    so the tiles of one slab run together and read dM from L2.  The wrapper
//    (ops/rgcn_contract.py) picks the slab count from the card's SM count.
//
// split3 (truncation): hi = x with its low 16 bits cleared, mid the same of
// x - hi, lo = x - hi - mid; each subtraction is exact and lo has at most 8
// significant bits, so hi + mid + lo = x for |x| >= 2^-110 (ops/
// pp_aggregate.py:split3_plain).  A NaN or an infinity gives NaN terms.
//
// Bound on an H100 at Decagon shape (R = 1,097, C = 344,064): S read once
// each way, 0.113 ms at 3.35 TB/s, plus M written (forward) or dM read
// (backward), 88 MB at Bt = 64; the products are 2 R C Bt operations (three
// times that backward), 48 / 145 GFLOP, 0.05 / 0.15 ms on bf16 tensor cores
// at 989 TFLOP/s.  chip_smoke.py reckons the bound from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_math.cuh"
#include "wgmma_tf32.cuh"

namespace rgcn_contract {

using tile_math::cp_async_commit;
using tile_math::cp_async_wait;
namespace wg = wgmma_tf32;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// forward
constexpr int F_COLS = 32 * WARPS;    // columns a block
constexpr int F_KS = 32;              // relations a stage (two k16 steps)
constexpr int F_PITCH = F_COLS + 16;  // bytes a staged strip row
constexpr int F_STAGES = 4;

template <int BT>
struct Fwd {
  static constexpr int S_BYTES = F_KS * F_PITCH;
  static constexpr int A_BYTES = F_KS * BT * 2;  // a stage's att fragments
  static constexpr int STAGE = S_BYTES + A_BYTES;
  static constexpr int SMEM = F_STAGES * STAGE;
};

// backward
constexpr int B_KC = 64;             // columns a stage (four k16 steps)
constexpr int B_SPITCH = B_KC + 16;  // bytes a staged strip row
constexpr int B_DPITCH = B_KC + 16;  // floats a staged dM row
constexpr int B_STAGES = 4;

template <int BT>
struct Bwd {
  static constexpr int G = 128 / BT;          // 64-relation groups a warpgroup
  static constexpr int RT = 2 * 64 * G;       // relations a block
  static constexpr int S_BYTES = RT * B_SPITCH;
  static constexpr int D_BYTES = BT * B_DPITCH * 4;
  static constexpr int STAGE = S_BYTES + D_BYTES;
  // a stage's dM terms: [3 terms][4 k16 steps] K-major B tiles of BT x 16
  // bf16 (wgmma_tf32::kmajor's layout in 32-bit words of two k slots)
  static constexpr int TILE_WORDS = BT * 8;
  static constexpr int T_BYTES = 3 * (B_KC / 16) * TILE_WORDS * 4;
  static constexpr int SMEM = B_STAGES * STAGE + 2 * T_BYTES;
};

// Start copying 16 bytes from src into dst, or, with bytes = 0, zero-fill
// dst (src is not read).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// bytes 0 and 2 of t (int8) as a bf16 pair, exactly: (128 + low 7 bits)
// less 128 or 256 for the sign bit
__device__ __forceinline__ uint32_t int8_pair(uint32_t t) {
  const uint32_t low = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t sgn = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&low),
              *reinterpret_cast<const __nv_bfloat162*>(&sgn));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// d = A B into a fresh (zero) accumulator
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c += A B
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B, one 64 x N x 16 wgmma step: A bf16 in registers (each warp of
// the warpgroup its 16 rows as mma.sync m16n8k16's A fragment), B bf16
// K-major in shared memory (descriptor b), float32 accumulator d
// (wgmma_tf32.cuh's layout)
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// x = hi + mid + lo (split3): each term a bf16 value, in the upper half of
// the returned word
__device__ __forceinline__ void split3(float x, uint32_t (&t)[3]) {
  const uint32_t u = __float_as_uint(x);
  const float r = __fsub_rn(x, __uint_as_float(u & 0xffff0000u));
  const uint32_t ur = __float_as_uint(r);
  t[0] = u;
  t[1] = ur;
  t[2] = __float_as_uint(__fsub_rn(r, __uint_as_float(ur & 0xffff0000u)));
}

// af[step][BT / 16][32 lanes][4]: the B fragments of n8 tiles 2jj, 2jj + 1
// for k16 step `step` (relations 16 step ..), zero past r and cols.  att
// [r, ld] bf16, its first `cols` columns read.
template <int BT>
__global__ void __launch_bounds__(256)
stage_att(const uint16_t* __restrict__ att, int r, int ld, int cols,
          int ksteps, uint32_t* __restrict__ af) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ksteps * BT * 8) return;
  const int e = idx & 3, lane = (idx >> 2) & 31;
  const int jj = (idx >> 7) % (BT / 16), step = (idx >> 7) / (BT / 16);
  const int b = 8 * (2 * jj + (e >> 1)) + (lane >> 2);
  const int k = 16 * step + 2 * (lane & 3) + 8 * (e & 1);
  const bool col = b < cols;
  const uint32_t lo = col && k < r ? att[(size_t)k * ld + b] : 0;
  const uint32_t hi = col && k + 1 < r ? att[(size_t)(k + 1) * ld + b] : 0;
  af[idx] = lo | hi << 16;
}

// m[b, c] for the block's 256 columns, b < rows
template <int BT>
__global__ void __launch_bounds__(THREADS, 2)
fwd(const int8_t* __restrict__ s, int r, long long c,
    const uint4* __restrict__ af, float* __restrict__ m, int rows) {
  using F = Fwd<BT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const long long col0 = (long long)blockIdx.x * F_COLS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int nst = (r + F_KS - 1) / F_KS;

  auto load = [&](int buf, int st) {
    uint8_t* ss = smem + buf * F::STAGE;
#pragma unroll
    for (int k = 0; k < F_KS * F_COLS / 16 / THREADS; ++k) {
      const int ch = tid + k * THREADS;
      const int row = ch / (F_COLS / 16), w = ch - row * (F_COLS / 16);
      const int t = st * F_KS + row;
      cp_async16z(ss + row * F_PITCH + 16 * w,
                  t < r ? s + (size_t)t * c + col0 + 16 * w : s,
                  t < r ? 16 : 0);
    }
    uint8_t* as = ss + F::S_BYTES;
    const uint4* src = af + (size_t)st * (F::A_BYTES / 16);
    for (int ch = tid; ch < F::A_BYTES / 16; ch += THREADS)
      cp_async16z(as + 16 * ch, src + ch, 16);
  };

  float acc[2][BT / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < F_STAGES - 1; ++st) {
    if (st < nst) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    {
      const int nx = it + F_STAGES - 1;
      if (nx < nst) load(nx % F_STAGES, nx);
      cp_async_commit();
    }
    const uint8_t* ss = smem + (it % F_STAGES) * F::STAGE;
    const uint4* as = reinterpret_cast<const uint4*>(ss + F::S_BYTES);
#pragma unroll
    for (int ks = 0; ks < F_KS / 16; ++ks) {
      // rows 2q, 2q + 1, 2q + 8, 2q + 9 of the step, columns 4g .. 4g + 3
      const uint32_t* w = reinterpret_cast<const uint32_t*>(
                              ss + (16 * ks + 2 * q) * F_PITCH) +
                          8 * warp + g;
      const uint32_t w0 = w[0], w1 = w[F_PITCH / 4];
      const uint32_t w8 = w[8 * F_PITCH / 4], w9 = w[9 * F_PITCH / 4];
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // bytes 2i, 2i + 1 of the first row's word, then of the second's
        const uint32_t sel = (2 * i) | (2 * i + 1) << 4 | (2 * i + 4) << 8 |
                             (2 * i + 5) << 12;
        const uint32_t lo = prmt(w0, w1, sel), hi = prmt(w8, w9, sel);
        a[i][0] = int8_pair(lo);       // row g (column 4g + 2i), k 2q, 2q+1
        a[i][1] = int8_pair(lo >> 8);  // row g + 8 (column 4g + 2i + 1)
        a[i][2] = int8_pair(hi);       // row g, k 2q + 8, 2q + 9
        a[i][3] = int8_pair(hi >> 8);
      }
#pragma unroll
      for (int jj = 0; jj < BT / 16; ++jj) {
        const uint4 b = as[(ks * (BT / 16) + jj) * 32 + lane];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float p[4], p2[4];
          mma0(p, a[i], b.x, b.y);
          mma0(p2, a[i], b.z, b.w);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][2 * jj][e] = __fadd_rn(acc[i][2 * jj][e], p[e]);
            acc[i][2 * jj + 1][e] = __fadd_rn(acc[i][2 * jj + 1][e], p2[e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // base 8j + 2q + e1, columns 4g .. 4g + 3 of the warp's 32
  const long long colw = col0 + 32 * warp + 4 * g;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int b = 8 * j + 2 * q + e1;
      if (b < rows)
        *reinterpret_cast<float4*>(m + (size_t)b * c + colw) =
            make_float4(acc[0][j][e1], acc[0][j][2 + e1], acc[1][j][e1],
                        acc[1][j][2 + e1]);
    }
}

// part[slab][r][BT]: block (relation tile, slab) sums its stages
template <int BT>
__global__ void __launch_bounds__(THREADS, 1)
bwd(const int8_t* __restrict__ s, int r, long long c,
    const float* __restrict__ dm, int rows, int ks,
    float* __restrict__ part) {
  using B = Bwd<BT>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* const terms =
      reinterpret_cast<uint32_t*>(smem + B_STAGES * B::STAGE);
  const int t0 = blockIdx.x * B::RT;
  const int slab = blockIdx.y;
  const int nall = (int)(c / B_KC);
  const int st0 = (int)((long long)slab * nall / ks);
  const int nst = (int)((long long)(slab + 1) * nall / ks) - st0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;

  auto load = [&](int buf, int st) {
    uint8_t* ss = smem + buf * B::STAGE;
    const long long cc = (long long)(st0 + st) * B_KC;
    for (int ch = tid; ch < B::RT * (B_KC / 16); ch += THREADS) {
      const int row = ch / (B_KC / 16), w = ch - row * (B_KC / 16);
      const int t = t0 + row;
      cp_async16z(ss + row * B_SPITCH + 16 * w,
                  t < r ? s + (size_t)t * c + cc + 16 * w : s,
                  t < r ? 16 : 0);
    }
    float* ds = reinterpret_cast<float*>(ss + B::S_BYTES);
    for (int ch = tid; ch < BT * (B_KC / 4); ch += THREADS) {
      const int row = ch / (B_KC / 4), w = ch - row * (B_KC / 4);
      cp_async16z(ds + row * B_DPITCH + 4 * w,
                  row < rows ? dm + (size_t)row * c + cc + 4 * w : dm,
                  row < rows ? 16 : 0);
    }
  };

  // Each dM value of a stage split once for the block: base b, k16 step
  // k4, columns 16 k4 + 4 qq .. + 3 -> word qq (k slots 2qq, 2qq + 1:
  // columns 0, 2) and word 4 + qq (slots 2qq + 8, 2qq + 9: columns 1, 3)
  // of base b's row in each term's B tile
  auto split_stage = [&](int buf, uint32_t* tw) {
    const float* ds =
        reinterpret_cast<const float*>(smem + buf * B::STAGE + B::S_BYTES);
    for (int e = tid; e < BT * (B_KC / 4); e += THREADS) {
      // a warp: one k16 step, 8 bases x 4 quads (free of bank conflicts)
      const int qq = e & 3, b = (e >> 2) % BT, k4 = e / (4 * BT);
      const float4 x = *reinterpret_cast<const float4*>(
          ds + b * B_DPITCH + 16 * k4 + 4 * qq);
      uint32_t x0[3], x1[3], x2[3], x3[3];
      split3(x.x, x0);
      split3(x.y, x1);
      split3(x.z, x2);
      split3(x.w, x3);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint32_t* tile = tw + (p * (B_KC / 16) + k4) * B::TILE_WORDS;
        tile[wg::kmajor(b, qq, 8)] = prmt(x0[p], x2[p], 0x7632);
        tile[wg::kmajor(b, 4 + qq, 8)] = prmt(x1[p], x3[p], 0x7632);
      }
    }
    wg::fence_smem();
  };

  float acc[B::G][BT / 2];
#pragma unroll
  for (int i = 0; i < B::G; ++i)
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) acc[i][e] = 0.f;
  // the warpgroup's relations (rows past r are zero in the ring: every
  // group multiplies, with no branch around a wgmma)
  const int wgr = (warp >> 2) * 64 * B::G, wq = warp & 3;

#pragma unroll
  for (int st = 0; st < B_STAGES - 1; ++st) {
    if (st < nst) load(st, st);
    cp_async_commit();
  }
  cp_async_wait<B_STAGES - 2>();
  __syncthreads();
  split_stage(0, terms);
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<B_STAGES - 3>();  // stage it + 1 has landed
    __syncthreads();  // stage it's terms are split; it - 1's products done
    {
      const int nx = it + B_STAGES - 1;
      if (nx < nst) load(nx % B_STAGES, nx);
      cp_async_commit();
    }
    const uint8_t* ss = smem + (it % B_STAGES) * B::STAGE;
    const uint32_t* tw = terms + (it & 1) * (B::T_BYTES / 4);
    // A: relation rows g, g + 8 of the warp's 16 in each group, columns
    // 16 k4 + 4q .. + 3 (bytes 0, 2: k slots 2q, 2q+1; 1, 3: 2q+8, 2q+9)
    // a k16 step at a time: each step's conversion runs while the
    // products of the steps before it do, and the next stage's split
    // while the last steps' do
    uint32_t a[B_KC / 16][B::G][4];
#pragma unroll
    for (int k4 = 0; k4 < B_KC / 16; ++k4) {
#pragma unroll
      for (int i = 0; i < B::G; ++i) {
        const uint8_t* row = ss + (wgr + 64 * i + 16 * wq + g) * B_SPITCH +
                             16 * k4 + 4 * q;
        const uint32_t v0 = *reinterpret_cast<const uint32_t*>(row);
        const uint32_t v1 =
            *reinterpret_cast<const uint32_t*>(row + 8 * B_SPITCH);
        a[k4][i][0] = int8_pair(v0);
        a[k4][i][1] = int8_pair(v1);
        a[k4][i][2] = int8_pair(v0 >> 8);
        a[k4][i][3] = int8_pair(v1 >> 8);
      }
      wg::fence();
#pragma unroll
      for (int p = 2; p >= 0; --p) {  // the small terms first
        const uint64_t desc = wg::desc(
            tw + (p * (B_KC / 16) + k4) * B::TILE_WORDS, 0, 0, 8);
#pragma unroll
        for (int i = 0; i < B::G; ++i) wgmma_bf16<BT>(acc[i], a[k4][i], desc);
      }
      wg::commit();
    }
    if (it + 1 < nst)
      split_stage((it + 1) % B_STAGES,
                  terms + ((it + 1) & 1) * (B::T_BYTES / 4));
    wg::wait<0>();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < B::G; ++i) wg::fence_acc(acc[i]);

  // acc[i][4j + 2h + e]: relation 16 wq + g + 8h of group i, base 8j + 2q + e
#pragma unroll
  for (int i = 0; i < B::G; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wgr + 64 * i + 16 * wq + g + 8 * h;
      if (t >= r) continue;
      float* dst = part + ((size_t)slab * r + t) * BT + 2 * q;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
    }
}

// out[t, b] = part[0][t][b] + part[1][t][b] + ... in slab order, b < cols
__global__ void __launch_bounds__(256)
sum_slabs(const float* __restrict__ part, int ks, int r, int bt, int cols,
          float* __restrict__ out, int ldo) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= r * cols) return;
  const int t = idx / cols, b = idx - t * cols;
  const size_t plane = (size_t)r * bt;
  const float* p = part + (size_t)t * bt + b;
  float v = p[0];
  for (int j = 1; j < ks; ++j) v = __fadd_rn(v, p[j * plane]);
  out[(size_t)t * ldo + b] = v;
}

template <int BT>
cudaError_t run_fwd(const int8_t* s, int r, long long c, const uint16_t* att,
                    int ld, int cols, uint32_t* af, float* m,
                    cudaStream_t st) {
  using F = Fwd<BT>;
  const int nst = (r + F_KS - 1) / F_KS;
  const int ksteps = nst * (F_KS / 16);
  const int words = ksteps * BT * 8;
  stage_att<BT><<<(words + 255) / 256, 256, 0, st>>>(att, r, ld, cols, ksteps,
                                                     af);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fwd<BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::SMEM);
  if (err != cudaSuccess) return err;
  fwd<BT><<<(unsigned)(c / F_COLS), THREADS, F::SMEM, st>>>(
      s, r, c, reinterpret_cast<const uint4*>(af), m, cols);
  return cudaGetLastError();
}

template <int BT>
cudaError_t run_bwd(const int8_t* s, int r, long long c, const float* dm,
                    int cols, int ks, float* part, float* out, int ldo,
                    cudaStream_t st) {
  using B = Bwd<BT>;
  cudaError_t err = cudaFuncSetAttribute(
      bwd<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, B::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((r + B::RT - 1) / B::RT, ks);
  bwd<BT><<<grid, THREADS, B::SMEM, st>>>(s, r, c, dm, cols, ks, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_slabs<<<(r * cols + 255) / 256, 256, 0, st>>>(part, ks, r, BT, cols,
                                                    out, ldo);
  return cudaGetLastError();
}

}  // namespace rgcn_contract

// Plain C entry points (bound with ctypes by ops/rgcn_contract.py).  s:
// int8 [r, c], 16-byte aligned, c a multiple of 256; bt: the instantiated
// width (32 or 64) of the column block [b0, b0 + cols) of att's or dM's
// bases, cols <= bt.  Each returns the first CUDA error
// (cudaErrorInvalidValue for a width it has no instance of).
//
// fwd: att bf16 [r, ld]; af scratch: 2 ceil(r / 32) 8 bt uint32; writes rows
// [b0, b0 + cols) of m, float32 [*, c].
extern "C" int tip_rgcn_contract_fwd(const int8_t* s, int r, long long c,
                                     const uint16_t* att, int ld, int b0,
                                     int cols, int bt, uint32_t* af,
                                     float* m, void* stream) {
  using namespace rgcn_contract;
  cudaStream_t st = (cudaStream_t)stream;
  if (c % F_COLS || cols < 1 || cols > bt) return cudaErrorInvalidValue;
  const uint16_t* a = att + b0;
  float* mb = m + (size_t)b0 * c;
  if (bt == 64) return run_fwd<64>(s, r, c, a, ld, cols, af, mb, st);
  if (bt == 32) return run_fwd<32>(s, r, c, a, ld, cols, af, mb, st);
  return cudaErrorInvalidValue;
}

// bwd: dm float32 [*, c] (rows [b0, b0 + cols) read); ks column slabs in
// [1, c / 64]; part scratch: ks r bt floats; writes columns [b0, b0 + cols)
// of out, float32 [r, ldo].
extern "C" int tip_rgcn_contract_bwd(const int8_t* s, int r, long long c,
                                     const float* dm, int b0, int cols,
                                     int bt, int ks, float* part, float* out,
                                     int ldo, void* stream) {
  using namespace rgcn_contract;
  cudaStream_t st = (cudaStream_t)stream;
  if (c % B_KC || cols < 1 || cols > bt || ks < 1 || ks > c / B_KC)
    return cudaErrorInvalidValue;
  const float* d = dm + (size_t)b0 * c;
  float* o = out + b0;
  if (bt == 64) return run_bwd<64>(s, r, c, d, cols, ks, part, o, ldo, st);
  if (bt == 32) return run_bwd<32>(s, r, c, d, cols, ks, part, o, ldo, st);
  return cudaErrorInvalidValue;
}
