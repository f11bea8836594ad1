// Warpgroup MMA (wgmma, sm_90a) on TF32 operands with float32 sums, for
// kernel B13 (dense_bce_dedicom.cu); kernel B15's backward
// (rgcn_contract.cu) lays its bf16 B tiles out the same way, two k slots
// to a 32-bit word, and uses the descriptor and fences.  A warpgroup (four consecutive warps,
// warp w of it owning rows 16 w .. 16 w + 15) multiplies a 64 x 8 A tile,
// held in registers, by an 8 x N B tile in shared memory, N = 8, 16 or 32,
// into a 64 x N float32 accumulator in registers, asynchronously.
//  * A in registers: lane (g = lane / 4, t4 = lane % 4) of warp w holds
//    (16 w + g, t4), (16 w + g + 8, t4), (16 w + g, t4 + 4), (16 w + g + 8,
//    t4 + 4), mma.sync m16n8k8's A fragment;
//  * the accumulator: d[4 j + 2 h + e] is (16 w + g + 8 h, 8 j + 2 t4 + e),
//    j < N / 8, mma.sync's C fragment for each 8 columns;
//  * B in shared memory K-major (TF32 wgmma has no transpose): element
//    (n, k) of an operand whose rows hold kdim words at word kmajor(n, k,
//    kdim), 8 x 4-word core matrices of 128 bytes, the core matrices of a
//    row group next to each other along k, the row groups after them, no
//    swizzle.  desc() points at the 8-deep k step from (n0, k0).
// mma3_rs is 3xTF32 as tile_math.cuh's mma3: A and B split into high and
// low TF32 parts, lo*hi + hi*lo + hi*hi into one accumulator.
// Issue order: fence() after the registers a wgmma reads were written,
// the wgmmas, commit(); wait<k>() before the accumulator or the A
// registers of a committed group are touched (at most k groups left in
// flight), then fence_acc() on the accumulator, so that the compiler reads
// it after the wait.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_tf32 {

__host__ __device__ constexpr int kmajor(int n, int k, int kdim) {
  return (((n >> 3) * (kdim >> 2) + (k >> 2)) << 5) + ((n & 7) << 2) + (k & 3);
}

// Shared-memory matrix descriptor: start address, leading byte offset (the
// next core matrix along k: 128 bytes), stride byte offset (the next 8-row
// group: kdim / 4 core matrices), no swizzle; all in 16-byte units.
__device__ __forceinline__ uint64_t desc(const uint32_t* base, int n0, int k0,
                                         int kdim) {
  const uint32_t addr =
      (uint32_t)__cvta_generic_to_shared(base + kmajor(n0, k0, kdim));
  const uint64_t lbo = 128 >> 4;
  const uint64_t sbo = (uint64_t)(kdim >> 2) * 128 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, one 64 x N x 8 step; acc 0 overwrites d
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int acc);

template <>
__device__ __forceinline__ void mma_rs<8>(float (&d)[4], const uint32_t (&a)[4],
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (+)= A B as 3xTF32, the small products first; bh, bl: descriptors of
// B's high and low parts
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint64_t bh,
                                        uint64_t bl, int acc) {
  mma_rs<N>(d, al, bh, acc);
  mma_rs<N>(d, ah, bl, 1);
  mma_rs<N>(d, ah, bh, 1);
}

}  // namespace wgmma_tf32
