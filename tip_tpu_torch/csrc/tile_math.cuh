// Device helpers of the dense loss kernels on Hopper (sm_90a), shared by
// dense_bce_sym.cu (B1), dense_bce.cu (B2) and dense_bce_nn.cu (B3):
//  * 3xTF32 tensor-core products: tf32, split, mma (mma.sync m16n8k8 TF32
//    with a float32 accumulator) and mma3, which multiplies float32
//    operands split into TF32 high and low parts three times (hi*hi + hi*lo
//    + lo*hi), for float32-level error where one TF32 product keeps ~3
//    digits;
//  * the cell's softplus(-x) and sigmoid(-x) from one exponential,
//    e = exp(-|x|): softplus(-x) = max(-x, 0) + log(1 + e) and sigmoid(-x)
//    = (x >= 0 ? e : 1) / (1 + e), with ex2.approx and lg2.approx (a few
//    1e-7 absolute in softplus) and __fdividef in the sigmoid;
//  * asynchronous copies into shared memory: cp_async16, and stage_chunk,
//    stage_span_chunk and stage_span, which copy a byte span of any
//    alignment as the whole 16-byte chunks that cover it (the unpadded
//    pages of B2 and B3 start their rows at any byte);
//  * page_value, a page cell of any page dtype read as float.
// tests/test_torch_dense_bce_sym.py and tests/test_torch_dense_bce.py
// emulate the 3xTF32 products and the one-exponential cell in numpy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_math {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// x rounded to TF32 (10 mantissa bits, ties away from zero).  A NaN stays
// a NaN, so that a NaN in z or w reaches the loss, as it does in the plain
// versions (the training loop stops on a non-finite loss).
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo + O(2^-22 |x|), both parts TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A B as 3xTF32: the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(c, al[0], al[1], al[2], al[3], bh0, bh1);
  mma(c, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  mma(c, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// softplus(-x) and e = exp(-|x|), from which sigmoid_neg gives sigmoid(-x)
__device__ __forceinline__ float softplus_neg(float x, float& e) {
  e = ex2(__fmul_rn(-fabsf(x), LOG2E));
  return __fadd_rn(fmaxf(-x, 0.f), __fmul_rn(lg2(__fadd_rn(1.f, e)), LN2));
}

__device__ __forceinline__ float sigmoid_neg(float x, float e) {
  return __fdividef(x >= 0.f ? e : 1.f, 1.f + e);
}

// The loss terms of one cell: softplus(-x) * pos + (softplus(-x) + x) *
// cnt, in explicit round-to-nearest operations, so that the value-only and
// fused instantiations of a kernel add the same float for every cell.
__device__ __forceinline__ float cell_loss(float sp, float x, float pos,
                                           float cnt) {
  return __fadd_rn(__fmul_rn(sp, pos), __fmul_rn(__fadd_rn(sp, x), cnt));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of src in the 16-byte chunk it starts in: a span staged from
// that chunk on has src[b] at dst[span_shift(src) + b].
__device__ __forceinline__ int span_shift(const void* src) {
  return (int)((uintptr_t)src & 15);
}

// Start copying the 16-byte chunk at a (16-byte aligned) into dst (16-byte
// aligned).  A chunk that would pass `end`, the end of the array it lies
// in, is copied byte by byte up to it, synchronously: the unpadded pages of
// B2 and B3 may end in the middle of a chunk.
__device__ __forceinline__ void stage_chunk(uint8_t* dst, const uint8_t* a,
                                            const uint8_t* end) {
  if (a + 16 <= end) {
    cp_async16(dst, a);
  } else {
    for (int b = 0; a + b < end; ++b) dst[b] = a[b];
  }
}

// Staging a byte span [src, src + nbytes) into dst (16-byte aligned, room
// for span_shift(src) + nbytes rounded up to 16) as the whole 16-byte
// chunks that cover it (stage_chunk): dst[span_shift(src) + b] = src[b].
// The chunks may reach up to 15 bytes before src and after the span, inside
// the array, whose start must be 16-byte aligned; the other bytes of dst
// are unspecified.  stage_span_chunk starts chunk c of the span, if the
// span reaches it; stage_span deals the chunks to the `nthreads` threads
// numbered `id`.
__device__ __forceinline__ void stage_span_chunk(uint8_t* dst,
                                                 const uint8_t* src,
                                                 int nbytes,
                                                 const uint8_t* end, int c) {
  if (16 * c < span_shift(src) + nbytes)
    stage_chunk(dst + 16 * c,
                (const uint8_t*)((uintptr_t)src & ~(uintptr_t)15) + 16 * c,
                end);
}

__device__ __forceinline__ void stage_span(uint8_t* dst, const uint8_t* src,
                                           int nbytes, const uint8_t* end,
                                           int id, int nthreads) {
  const int chunks = (span_shift(src) + nbytes + 15) >> 4;
  for (int c = id; c < chunks; c += nthreads)
    stage_span_chunk(dst, src, nbytes, end, c);
}

// A page cell read as float, whatever the page dtype (B2: float32, bf16;
// B3: uint8, bf16, float32).
__device__ __forceinline__ float page_value(const uint8_t* p) {
  return (float)*p;
}
__device__ __forceinline__ float page_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float page_value(const float* p) { return *p; }

}  // namespace tile_math
