// Multi-relation graph convolution of Decagon's D-D side for Hopper
// (sm_90a), kernel B14:
//   forward   out[i] = sum_t s_t[i] ((A_t + I) u_t)[i],  u_t = bf16(s_t * Y_t)
//   backward  dY_t[j] = s_t[j] ((A_t + I)^T v_t)[j],     v_t = s_t * g
// with A_t relation t's count page, read where it lies: the uint8 pages
// [R, n, n] (row stride n, any n, unpadded), and s_t = (deg_t + 1)^-1/2
// [R, n] float32, so that s_t (A_t + I) s_t is Decagon's normalised
// adjacency D^-1/2 (A_t + I) D^-1/2.  Y_t [R, n, D] float32 is the
// relation's operand (layer 1: its one-hot weight table; layer 2: H W_t),
// g [n, D] the gradient of out.  The D-D pages are symmetric (both
// directions of every train pair), so the backward reads A_t's rows:
// (A_t + I)^T v = (A_t + I) v.
//
// Replaces no pl.pallas_call: the JAX package has no Decagon model.  Its
// route would be an XLA dot per relation over an upcast copy of the pages;
// this kernel reads the 1-byte pages once a pass and makes no float copy.
//
// Stated precision: bf16 operands, float32 sums, in a fixed order.
//  * Forward: u_t = bf16(s_t * Y_t) (the operand rounding the plain
//    reference states), every page value exact in bf16, every product
//    exact in float32, the k sums float32 on the tensor cores, then
//    + u_t[i] (the self loop), times s_t[i], and the relations summed in
//    order (within a block, then the blocks' partials in chunk order).
//    Where float32 matmuls are pinned (exact), u_t = s_t * Y_t stays
//    float32, split exactly into three bf16 terms as the backward's v_t:
//    a count of at most 255 times a bf16 term is exact in float32, so the
//    forward is the float32 product's, from the same uint8 pages.
//  * Backward: v_t = s_t * g in float32, split exactly into three bf16
//    terms (split3, as kernel B12's backward), so the products stay exact
//    and the sums float32: the gradient of Y_t as the float32 product
//    gives it.
//
// Design: that of pp_aggregate.cu (B12), one page a relation.
//  * stage_u, a first pass, writes the operand as the bf16 tiles the main
//    pass reads: [R][P][k tile][D][BK], P terms, each k tile of BK rows
//    transposed to D rows of BK values in the lanes' order, zero past n.
//  * aggregate: a block owns BM = 256 rows and a chunk of RC relations; its
//    cp.async ring of STAGES stages runs over (relation, k tile) in order,
//    each stage BM page rows x BK bytes and the operand tile of those k.
//    A page row's span starts at byte (t n + i) n + k0 of the flat pages at
//    any alignment; it is copied as the nine aligned 16-byte chunks that
//    cover it and read back at its shift, which changes with the relation.
//    mma.sync m16n8k16 bf16 with float32 accumulators; the bytes become
//    bf16 pairs in registers exactly (u8_pair).  After a relation's last k
//    tile each lane adds the self loop and scales its rows by s_t: the
//    forward adds them into running sums (one partial a chunk, summed by
//    sum_chunks in chunk order), the backward writes dY_t's rows.
//
// Bound on an H100 at Decagon shape (R = 1,097, n = 645): the pages are
// 456 MB, 0.136 ms at 3.35 TB/s, each pass; 2 R n^2 D operations, 58.4
// GFLOP at D = 64 (three times that in the backward), run on the bf16
// tensor cores.  chip_smoke.py reckons the bound from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_math.cuh"

namespace rel_aggregate {

using tile_math::cp_async16;
using tile_math::cp_async_commit;
using tile_math::cp_async_wait;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 2;                  // m16 tiles a warp
constexpr int BM = WARPS * MT * 16;    // rows a block
constexpr int BK = 128;                // k a stage
constexpr int CHUNKS = BK / 16 + 1;    // 16-byte chunks a staged page row
constexpr int AWORDS = 4 * CHUNKS;     // its 32-bit words
constexpr int XPITCH = BK + 16;        // bf16 a staged operand row
constexpr int A_STAGE = BM * AWORDS * 4;
constexpr int SMEM_MAX = 227 * 1024;

template <int D, int P>
struct Shape {
  static constexpr int X_STAGE = P * D * XPITCH * 2;
  static constexpr int STAGE = A_STAGE + X_STAGE;
  static constexpr int FIT = SMEM_MAX / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(STAGES >= 2, "two stages must fit");
};

// the k of position p of a staged operand row: lane q's step s reads
// positions 16 s + 4 q .. + 3, which hold k = 32 q + 4 s .. + 3
__host__ __device__ __forceinline__ int k_of(int p) {
  return 32 * ((p >> 2) & 3) + 4 * (p >> 4) + (p & 3);
}

// Start copying the 16-byte chunk at src (16-byte aligned) into dst, the
// bytes before `end` only (the rest zero-filled).
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

// bytes 0 and 2 of t (uint8) as a bf16 pair, exactly: (128 + low 7 bits)
// less 128 where the top bit is clear
__device__ __forceinline__ uint32_t u8_pair(uint32_t t) {
  const uint32_t low = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t sub = ((~t & 0x00800080u) >> 7) * 0x4300u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&low),
              *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + mid + lo exactly (pp_aggregate.cu: split3)
__device__ __forceinline__ void split3(float x, uint16_t (&t)[3]) {
  const uint32_t u = __float_as_uint(x);
  const float r = __fsub_rn(x, __uint_as_float(u & 0xffff0000u));
  const uint32_t ur = __float_as_uint(r);
  const float l = __fsub_rn(r, __uint_as_float(ur & 0xffff0000u));
  t[0] = (uint16_t)(u >> 16);
  t[1] = (uint16_t)(ur >> 16);
  t[2] = (uint16_t)(__float_as_uint(l) >> 16);
}

// u[t][P][kt][D][BK]: one thread a (relation, k tile, position).  The
// operand of relation t at row k, column c is s_t[k] y[t y_rel + k D + c]:
// the forward's Y_t (y_rel = n D), rounded to bf16; the backward's g
// (y_rel = 0), split into three bf16 terms.
template <int D, int P>
__global__ void __launch_bounds__(256)
stage_u(const float* __restrict__ y, long long y_rel,
        const float* __restrict__ s, int n, int n_et, int ktiles,
        uint16_t* __restrict__ u) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_et * ktiles * BK) return;
  const int t = (int)(idx / ((long long)ktiles * BK));
  const int rem = (int)(idx - (long long)t * ktiles * BK);
  const int kt = rem / BK, p = rem - kt * BK;
  const int k = kt * BK + k_of(p);
  const size_t plane = (size_t)ktiles * D * BK;
  uint16_t* dst = u + (size_t)t * P * plane + (size_t)kt * D * BK + p;
  const float sk = k < n ? s[(size_t)t * n + k] : 0.f;
  const float* yk = y + t * y_rel + (size_t)k * D;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    uint16_t v[3] = {0, 0, 0};
    if (k < n) {
      const float x = __fmul_rn(sk, yk[c]);
      if (P == 1) {
        const __nv_bfloat16 b = __float2bfloat16_rn(x);
        v[0] = *reinterpret_cast<const uint16_t*>(&b);
      } else {
        split3(x, v);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) dst[j * plane + (size_t)c * BK] = v[j];
  }
}

// SUM (forward): part[chunk][n][D], each block's relations summed.
// Otherwise (backward): out[t][n][D] for each relation of the block.
template <int D, int P, bool SUM>
__global__ void __launch_bounds__(THREADS, 1)
aggregate(const uint8_t* __restrict__ pages, int n, int n_et, int ktiles,
          int rc, const uint16_t* __restrict__ u, const float* __restrict__ y,
          long long y_rel, const float* __restrict__ s,
          float* __restrict__ out) {
  using S = Shape<D, P>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* a_end = pages + (size_t)n_et * n * n;
  const int row0 = blockIdx.x * BM;
  const int t0 = blockIdx.y * rc;
  const int nrel = min(rc, n_et - t0);
  const int nst = nrel * ktiles;  // stages: (relation, k tile) in order
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)ktiles * D * BK;

  auto load = [&](int buf, int st) {
    const int t = t0 + st / ktiles, kt = st % ktiles;
    uint8_t* as = smem + buf * S::STAGE;
    for (int c = lane; c < MT * 16 * CHUNKS; c += 32) {  // the warp's rows
      const int rr = c / CHUNKS, w = c - rr * CHUNKS;
      const int r = (warp * MT) * 16 + rr;
      if (row0 + r >= n) continue;
      const uintptr_t span = (uintptr_t)(
          pages + ((size_t)t * n + row0 + r) * n + (size_t)kt * BK);
      cp_async_chunk(as + r * AWORDS * 4 + 16 * w,
                     reinterpret_cast<const uint8_t*>(span & ~(uintptr_t)15) +
                         16 * w,
                     a_end);
    }
    uint8_t* xs = as + A_STAGE;
    const uint16_t* ut = u + (size_t)t * P * plane;
    for (int c = tid; c < P * D * (BK / 8); c += THREADS) {
      const int pr = c / (BK / 8), w = c - pr * (BK / 8);  // pr = j D + col
      const int j = pr / D, col = pr - j * D;
      cp_async16(xs + pr * XPITCH * 2 + 16 * w,
                 ut + j * plane + ((size_t)kt * D + col) * BK + 8 * w);
    }
  };

  const int g = lane >> 2, q = lane & 3;
  int woff[MT][2];
  uint32_t sel0[MT][2], sel1[MT][2];
  // this lane's rows: m tile i, half h (row g or g + 8); the byte shift of
  // a page row changes with the relation
  auto rows_of = [&](int t) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp * MT + i) * 16 + g + 8 * h;
        const uint32_t sh =
            (uint32_t)((((size_t)t * n + row0 + r) * n) & 15);
        woff[i][h] = r * AWORDS + (int)(sh >> 2) + 8 * q;
        const uint32_t b = sh & 3;
        sel0[i][h] = b | b << 4 | (b + 1) << 8 | (b + 1) << 12;
        sel1[i][h] = (b + 2) | (b + 2) << 4 | (b + 3) << 8 | (b + 3) << 12;
      }
  };
  float acc[MT][D / 8][4];
  float tot[MT][D / 8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int f = 0; f < D / 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = tot[i][f][e] = 0.f;

#pragma unroll
  for (int st = 0; st < S::STAGES - 1; ++st) {
    if (st < nst) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    const int t = t0 + it / ktiles, kt = it % ktiles;
    if (kt == 0) rows_of(t);
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();
    {
      const int nx = it + S::STAGES - 1;
      if (nx < nst) load(nx % S::STAGES, nx);
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
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t b[P][D / 8][2];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int f = 0; f < D / 8; ++f) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              xs + ((j * D + 8 * f + g) * XPITCH + 16 * ks + 4 * q) * 2);
          b[j][f][0] = v.x;
          b[j][f][1] = v.y;
        }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t af[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t nxt = aw[woff[i][h] + ks + 1];
          af[h] = u8_pair(prmt(prev[i][h], nxt, sel0[i][h]));
          af[2 + h] = u8_pair(prmt(prev[i][h], nxt, sel1[i][h]));
          prev[i][h] = nxt;
        }
#pragma unroll
        for (int j = P - 1; j >= 0; --j)  // the small terms first
#pragma unroll
          for (int f = 0; f < D / 8; ++f)
            mma(acc[i][f], af, b[j][f][0], b[j][f][1]);
      }
    }
    if (kt == ktiles - 1) {  // relation t done: self loop, scale, sum
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + (warp * MT + i) * 16 + g + 8 * h;
          const bool live = row < n;
          const float st = live ? s[(size_t)t * n + row] : 0.f;
          const float* yr = y + t * y_rel + (size_t)(live ? row : 0) * D;
#pragma unroll
          for (int f = 0; f < D / 8; ++f)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * f + 2 * q + e;
              // the self loop's term, as the operand tile holds it
              const float x = live ? __fmul_rn(st, yr[c]) : 0.f;
              const float self =
                  P == 1 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
              const float v =
                  __fmul_rn(__fadd_rn(acc[i][f][2 * h + e], self), st);
              acc[i][f][2 * h + e] = 0.f;
              if (SUM) {
                tot[i][f][2 * h + e] = __fadd_rn(tot[i][f][2 * h + e], v);
              } else if (live) {
                out[((size_t)t * n + row) * D + c] = v;
              }
            }
        }
    }
  }
  cp_async_wait<0>();

  if (SUM) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + (warp * MT + i) * 16 + g + 8 * h;
        if (row >= n) continue;
        float* dst = out + ((size_t)blockIdx.y * n + row) * D + 2 * q;
#pragma unroll
        for (int f = 0; f < D / 8; ++f)
          *reinterpret_cast<float2*>(dst + 8 * f) =
              make_float2(tot[i][f][2 * h], tot[i][f][2 * h + 1]);
      }
  }
}

// out[e] = part[0][e] + part[1][e] + ... in chunk order
__global__ void __launch_bounds__(256)
sum_chunks(const float* __restrict__ part, int chunks, size_t m,
           float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float acc = part[e];
  for (int j = 1; j < chunks; ++j) acc = __fadd_rn(acc, part[j * m + e]);
  out[e] = acc;
}

template <int D, int P, bool SUM>
cudaError_t run(const uint8_t* pages, int n, int n_et, const float* y,
                long long y_rel, const float* s, int rc, uint16_t* u,
                float* part, float* out, cudaStream_t st) {
  using S = Shape<D, P>;
  const int ktiles = (n + BK - 1) / BK;
  const long long items = (long long)n_et * ktiles * BK;
  stage_u<D, P><<<(unsigned)((items + 255) / 256), 256, 0, st>>>(
      y, y_rel, s, n, n_et, ktiles, u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(aggregate<D, P, SUM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (err != cudaSuccess) return err;
  const int chunks = (n_et + rc - 1) / rc;
  const dim3 grid((n + BM - 1) / BM, chunks);
  aggregate<D, P, SUM><<<grid, THREADS, S::SMEM, st>>>(
      pages, n, n_et, ktiles, rc, u, y, y_rel, s, SUM ? part : out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (SUM) {
    const size_t m = (size_t)n * D;
    sum_chunks<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(part, chunks, m,
                                                           out);
    err = cudaGetLastError();
  }
  return err;
}

template <int D>
cudaError_t dispatch(int backward, int exact, const uint8_t* pages, int n,
                     int n_et, const float* y, const float* s, int rc,
                     uint16_t* u, float* part, float* out, cudaStream_t st) {
  if (backward)
    return run<D, 3, false>(pages, n, n_et, y, 0, s, rc, u, part, out, st);
  if (exact)
    return run<D, 3, true>(pages, n, n_et, y, (long long)n * D, s, rc, u,
                           part, out, st);
  return run<D, 1, true>(pages, n, n_et, y, (long long)n * D, s, rc, u, part,
                         out, st);
}

}  // namespace rel_aggregate

// Plain C entry point (bound with ctypes by ops/rel_aggregate.py).  pages:
// uint8 [n_et, n, n], symmetric, 16-byte aligned; s: [n_et, n] float32;
// d: 8, 16, 32 or 64.  Forward (backward 0): y [n_et, n, d] float32, out
// [n, d] float32; exact 1 keeps the operand float32 (three bf16 terms).
// Backward (backward 1, exact ignored): y the gradient [n, d] float32, out
// [n_et, n, d] float32.  rc relations a block; scratch u: n_et P
// ceil(n / 128) 128 d uint16 (P = 3 backward or exact, else 1), part
// (forward only): ceil(n_et / rc) n d floats.  Returns the first CUDA
// error (cudaErrorInvalidValue for a width it has no instance of).
extern "C" int tip_rel_aggregate(const uint8_t* pages, int n, int n_et,
                                 const float* y, const float* s, int d,
                                 int backward, int exact, int rc, uint16_t* u,
                                 float* part, float* out, void* stream) {
  using namespace rel_aggregate;
  cudaStream_t st = (cudaStream_t)stream;
  if ((uintptr_t)pages % 16 != 0) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 8:
      return dispatch<8>(backward, exact, pages, n, n_et, y, s, rc, u, part,
                            out, st);
    case 16:
      return dispatch<16>(backward, exact, pages, n, n_et, y, s, rc, u, part,
                             out, st);
    case 32:
      return dispatch<32>(backward, exact, pages, n, n_et, y, s, rc, u, part,
                             out, st);
    case 64:
      return dispatch<64>(backward, exact, pages, n, n_et, y, s, rc, u, part,
                             out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
