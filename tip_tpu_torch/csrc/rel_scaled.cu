// Relation-scaled aggregation over the int8 strips for Hopper (sm_90a),
// kernel B16: out = sum_r (A_r X) * z_r and, in the backward, dz.
//
// Replaces no pl.pallas_call: the JAX package has no CompGCN model.  In
// CompGCN (models/compgcn.py) every D-D relation r scales its messages by
// its own vector z_r after the product with the one operand shared by all
// relations, so
//   forward:  out[i, c] = sum_r z_r[c] sum_k A_r[i, k] U[k, c]
//   backward: P_r = A_r G (A_r symmetric, so A_r^T G = A_r G);
//             dU = sum_r P_r * z_r,  dz_r[c] = sum_i bf16(U)[i, c] P_r[i, c]
// with A_r the symmetric count matrix of relation r as the strips hold it
// (data/packing.py:sym_strip_pack: strip I is block row I from the diagonal
// block on, [R, 128, totcols] int8; a block (I, J) with I > J is the
// transpose of the stored block (J, I)).  X is bf16(U) in the forward (one
// term) and G's three exact bf16 terms in the backward (split3 of
// pp_aggregate.cu, here done by the wrapper): every int8 x bf16 product is
// exact in float32 and the sums are float32.  No [R, n, d] operand or
// product is formed in device memory, and the strips are read where they
// lie, with no float copy.
//
// Design.  A block owns one 128-row block I, one 128-column block J of
// A_r (the k range of the product), one chunk of DC = 40 output columns and
// one contiguous chunk of relations; its 8 warps own 16 rows each.
//  * The operand's rows J, its DC columns and its terms are staged once in
//    shared memory, transposed ([term][column][k]) so that a lane reads
//    its B fragment as two 32-bit words, free of bank conflicts (row pitch
//    68 words).
//  * The relations' 128 x 128 int8 tiles stream through a double buffer of
//    cp.async copies.  Each relation's product runs on the tensor cores,
//    mma.sync m16n8k16 bf16, into a fresh float32 accumulator (the k steps
//    past n skipped); the int8 values become bf16 pairs in registers,
//    exactly (|A| <= 127).  The transposed blocks read the tile column-wise.
//  * The accumulator is scaled by z_r's columns (read through L2) and added
//    to the block's running float32 sum (fmaf); the backward also sums
//    bf16(U) * P_r over the block's rows (a shuffle over the 8 row groups
//    of a warp, then the 8 warps in order) into dz's partial for (I, J, r).
//  * sum_out adds a row's partials over the relation chunks and column
//    blocks J in a fixed order; sum_dz adds dz's over (I, J).  No atomics:
//    the result is deterministic.
//  The 5 column chunks of one (I, J, relation chunk) are neighbouring
//  blocks, so they read each relation's tile at about the same time and
//  four of the five reads hit L2.
//
// Bound on an H100 at Decagon shape (R = 1,097, n = 645, d = 200): the
// strips, 377 MB, take 0.11 ms at 3.35 TB/s; the products are 2 R n^2 d =
// 0.18 TFLOP forward and 0.55 backward, 0.18 / 0.55 ms at 989 TFLOP/s, so
// the tensor cores bound both passes (mma.sync reaches about half that
// rate, and the 768-row padding of the strips adds 42 % to the products a
// block runs).  chip_smoke.py reckons the bound from its run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_math.cuh"

namespace rel_scaled {

// tile_math.cuh's cp.async helpers; the bf16 mma.sync and the int8 -> bf16
// pairs are this file's own, as B12, B14 and B15 each keep theirs
using tile_math::cp_async16;
using tile_math::cp_async_commit;
using tile_math::cp_async_wait;

constexpr int B = 128;         // block edge of the strips
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int DC = 40;         // output columns a block
constexpr int NT = DC / 8;     // n8 tiles a warp
constexpr int PS = B + 16;     // bytes a staged tile row
constexpr int XS = B + 8;      // bf16 a staged operand row (68 words)

__host__ __device__ constexpr int smem_bytes(int terms) {
  return 2 * B * PS + terms * DC * XS * 2 +
         (terms == 3 ? B * DC * 2 + WARPS * DC * 4 : 0);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 values as a bf16 pair (lo in the low half), exactly
__device__ __forceinline__ uint32_t pair(int8_t lo, int8_t hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int P>
__global__ void __launch_bounds__(THREADS)
conv(const int8_t* __restrict__ strips, int r, int n, int nb, int totcols,
     int dw, const uint16_t* __restrict__ xt, const float* __restrict__ zz,
     const uint16_t* __restrict__ ubp, int rch, float* __restrict__ part,
     float* __restrict__ dz_part) {
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* pg = reinterpret_cast<int8_t*>(smem);                    // [2][B][PS]
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + 2 * B * PS);   // [P][DC][XS]
  uint16_t* ubs = xs + P * DC * XS;                                // [B][DC] (P == 3)
  float* red = reinterpret_cast<float*>(ubs + B * DC);             // [WARPS][DC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int fc = blockIdx.x;
  const int I = blockIdx.y / nb, J = blockIdx.y % nb;
  const int rc = blockIdx.z;
  const int t0 = (int)((long long)rc * r / rch);
  const int t1 = (int)((long long)(rc + 1) * r / rch);
  const int npad = nb * B;
  const int col0 = fc * DC;
  const bool direct = I <= J;
  const int ti = direct ? I : J, tj = direct ? J : I;
  const size_t tile_off = (size_t)(ti * nb - ti * (ti - 1) / 2 + (tj - ti)) * B;
  const int m0 = warp * 16;
  const bool live = I * B + m0 < n;  // the warp's rows hold a node
  const int ksteps = (min(B, n - J * B) + 15) / 16;

  auto fetch = [&](int t, int buf) {
    const int8_t* src = strips + (size_t)t * B * totcols + tile_off;
    int8_t* dst = pg + buf * B * PS;
    for (int i = tid; i < B * (B / 16); i += THREADS) {
      const int row = i / (B / 16), c = (i % (B / 16)) * 16;
      cp_async16(dst + row * PS + c, src + (size_t)row * totcols + c);
    }
    cp_async_commit();
  };

  if (t0 < t1) fetch(t0, 0);
  for (int i = tid; i < P * B * DC; i += THREADS) {
    const int c = i % DC, k = (i / DC) % B, p = i / (DC * B);
    xs[(p * DC + c) * XS + k] =
        xt[((size_t)p * npad + J * B + k) * dw + col0 + c];
  }
  if constexpr (P == 3) {
    for (int i = tid; i < B * DC; i += THREADS) {
      const int c = i % DC, k = i / DC;
      ubs[k * DC + c] = ubp[(size_t)(I * B + k) * dw + col0 + c];
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    float zv[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* zr = zz + (size_t)t * dw + col0 + nt * 8 + 2 * t4;
      zv[nt][0] = __ldg(zr);
      zv[nt][1] = __ldg(zr + 1);
    }
    cp_async_wait<0>();
    __syncthreads();  // tile t, the staged operand, red's last readers
    if (t + 1 < t1) fetch(t + 1, buf ^ 1);
    const int8_t* page = pg + buf * B * PS;

    float p[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[nt][q] = 0.f;
    if (live) {
      const int r0 = m0 + g, r1 = r0 + 8;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k0 = ks * 16 + 2 * t4, k1 = k0 + 8;
        uint32_t a[4];
        if (direct) {
          const char2 v0 = *reinterpret_cast<const char2*>(page + r0 * PS + k0);
          const char2 v1 = *reinterpret_cast<const char2*>(page + r1 * PS + k0);
          const char2 v2 = *reinterpret_cast<const char2*>(page + r0 * PS + k1);
          const char2 v3 = *reinterpret_cast<const char2*>(page + r1 * PS + k1);
          a[0] = pair(v0.x, v0.y);
          a[1] = pair(v1.x, v1.y);
          a[2] = pair(v2.x, v2.y);
          a[3] = pair(v3.x, v3.y);
        } else {  // A[m][k] = S[k][m]
          a[0] = pair(page[k0 * PS + r0], page[(k0 + 1) * PS + r0]);
          a[1] = pair(page[k0 * PS + r1], page[(k0 + 1) * PS + r1]);
          a[2] = pair(page[k1 * PS + r0], page[(k1 + 1) * PS + r0]);
          a[3] = pair(page[k1 * PS + r1], page[(k1 + 1) * PS + r1]);
        }
#pragma unroll
        for (int q = 0; q < P; ++q)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint16_t* xr = xs + (q * DC + nt * 8 + g) * XS + k0;
            mma(p[nt], a, *reinterpret_cast<const uint32_t*>(xr),
                *reinterpret_cast<const uint32_t*>(xr + 8));
          }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] = fmaf(p[nt][0], zv[nt][0], acc[nt][0]);
      acc[nt][1] = fmaf(p[nt][1], zv[nt][1], acc[nt][1]);
      acc[nt][2] = fmaf(p[nt][2], zv[nt][0], acc[nt][2]);
      acc[nt][3] = fmaf(p[nt][3], zv[nt][1], acc[nt][3]);
    }
    if constexpr (P == 3) {
      // dz_r over this block's rows: rows m0+g, m0+g+8 of each column pair
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + 2 * t4;
        const __nv_bfloat162 u0 =
            *reinterpret_cast<const __nv_bfloat162*>(ubs + (m0 + g) * DC + c);
        const __nv_bfloat162 u1 =
            *reinterpret_cast<const __nv_bfloat162*>(ubs + (m0 + g + 8) * DC + c);
        float s0 = fmaf(__low2float(u0), p[nt][0], __low2float(u1) * p[nt][2]);
        float s1 = fmaf(__high2float(u0), p[nt][1], __high2float(u1) * p[nt][3]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (g == 0) {
          red[warp * DC + c] = s0;
          red[warp * DC + c + 1] = s1;
        }
      }
      __syncthreads();
      if (tid < DC) {
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += red[w * DC + tid];
        dz_part[((size_t)(I * nb + J) * r + t) * dw + col0 + tid] = s;
      }
    }
  }

  float* out = part + ((((size_t)rc * nb + I) * nb + J) * B) * dw + col0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * t4;
    *reinterpret_cast<float2*>(out + (size_t)(m0 + g) * dw + c) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (size_t)(m0 + g + 8) * dw + c) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// out[i, c]: the partials of row i's block over the relation chunks, then
// the column blocks, in that order
__global__ void sum_out(const float* __restrict__ part, int rch, int nb,
                        int n, int d, int dw, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * d) return;
  const int row = idx / d, c = idx % d;
  const int I = row / B, rr = row % B;
  float s = 0.f;
  for (int rc = 0; rc < rch; ++rc)
    for (int J = 0; J < nb; ++J)
      s += part[((((size_t)rc * nb + I) * nb + J) * B + rr) * dw + c];
  out[idx] = s;
}

// dz[t, c]: the partials of the (I, J) blocks in order
__global__ void sum_dz(const float* __restrict__ dz_part, int nb, int r,
                       int d, int dw, float* __restrict__ dz) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= r * d) return;
  const int t = idx / d, c = idx % d;
  float s = 0.f;
  for (int ij = 0; ij < nb * nb; ++ij)
    s += dz_part[((size_t)ij * r + t) * dw + c];
  dz[idx] = s;
}

template <int P>
cudaError_t launch(const int8_t* strips, int r, int n, int nb, int totcols,
                   int d, int dw, const uint16_t* xt, const float* zz,
                   const uint16_t* ubp, float* part, int rch, float* out,
                   float* dz_part, float* dz, cudaStream_t stream) {
  constexpr int smem = smem_bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      conv<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv<P><<<dim3(dw / DC, nb * nb, rch), THREADS, smem, stream>>>(
      strips, r, n, nb, totcols, dw, xt, zz, ubp, rch, part, dz_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_out<<<(n * d + 255) / 256, 256, 0, stream>>>(part, rch, nb, n, d, dw,
                                                   out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (P == 3) {
    sum_dz<<<(r * d + 255) / 256, 256, 0, stream>>>(dz_part, nb, r, d, dw, dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace rel_scaled

// Plain C entry point (bound with ctypes by ops/rel_scaled.py).  strips
// [r][128][totcols] int8, 16-byte aligned; xt [terms][nb * 128][dw] bf16
// (terms 1: the forward's bf16(U); 3: G's exact terms), zero past n and d;
// zz [r][dw] float32, zero past d; ubp [nb * 128][dw] bf16 (terms 3: the
// forward's bf16(U)); dw a multiple of 40.  Scratch: part rch * nb * nb *
// 128 * dw floats; dz_part nb * nb * r * dw (terms 3).  Writes out [n][d]
// and, with terms 3, dz [r][d].  Returns the first CUDA error.
extern "C" int tip_rel_scaled(const int8_t* strips, int r, int n, int nb,
                              int totcols, int d, int dw, const uint16_t* xt,
                              const float* zz, const uint16_t* ubp,
                              float* part, int terms, int rch, float* out,
                              float* dz_part, float* dz, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (((uintptr_t)strips | (uintptr_t)totcols) % 16 != 0 ||
      dw % rel_scaled::DC != 0 || d > dw || rch < 1 || rch > r)
    return (int)cudaErrorInvalidValue;
  if (terms == 1)
    return rel_scaled::launch<1>(strips, r, n, nb, totcols, d, dw, xt, zz, ubp,
                                 part, rch, out, dz_part, dz, s);
  if (terms == 3)
    return rel_scaled::launch<3>(strips, r, n, nb, totcols, d, dw, xt, zz, ubp,
                                 part, rch, out, dz_part, dz, s);
  return (int)cudaErrorInvalidValue;
}
