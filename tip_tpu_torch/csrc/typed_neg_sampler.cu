// Typed negative sampler for chunk-aligned edge buffers, for Hopper
// (sm_90a): one candidate pair per slot, sign-flagged where it is a
// positive of the slot's relation.
//
// Replaces the Pallas TPU kernel of tip_tpu/ops/pallas_sampler.py
// (typed_negative_sampling_padded: _sampler_kernel, called with one
// full-width round and no tail rounds).  Per slot (c, j) of the
// [n_chunks, C] buffer, for relation t = chunk_type[c]:
//   n^2 <= 2^24: pair = min(int(f32(u24[j]) * scale), n^2 - 1),
//                scale = f32(n^2 / 2^24)
//   n > 4096:    src = min(int(f32(u24[j]) * scale), n - 1),
//                dst = min(int(f32(u24[C + j]) * scale), n - 1),
//                scale = f32(n / 2^24), pair = dst * n + src
//   out = pair, or -pair - 1 when bit (pair & 7) of byte (pair >> 3) of
//   relation t's slice of the little-endian bitmap is set.
// The f32 multiply is rounded to nearest (__fmul_rn) and truncated toward
// zero, as the JAX kernel's astype(int32) does.  The lane-borrow pass that
// resolves flagged slots stays in PyTorch (ops/sampler.py:resolve_borrow),
// as it stays in XLA in the JAX package.
//
// Random bits.  The TPU kernel draws from its on-chip PRNG; here draw word
// w of chunk c is u24 = mix32(key_c ^ mix32(w)) >> 8 with key_c =
// mix32(seed + mix32(c + 0x9e3779b9)) (lowbias32 mixer), the field that
// ops/sampler.py:sampler_u24 computes in PyTorch, so kernel and plain
// version give the same pairs.  Given a draws buffer u24 [n_chunks,
// draws * C] int32 instead (a non-null pointer), it reads word w of chunk c
// from there, as the plain version does with explicit draws.
//
// The TPU kernel streams each relation's bitmap slice through VMEM and
// gathers bytes with one-hot matmuls.  Here each thread reads its one byte
// straight from device memory: the slots of a chunk share a relation, so
// their bytes lie in one 295 KB (n = 1536) or 53 KB (n = 645) slice that
// L2 keeps.
//
// Bound on an H100 at Decagon shape (~9.0 M slots): it must write the pairs
// (36 MB), read the chunk types, and read the bitmap bytes its draws touch
// (at most one per slot): ~0.01-0.02 ms at 3.35 TB/s.  Its arithmetic is
// two 32-bit hashes and one f32 multiply a draw; chip_smoke.py reckons the
// bound from the bytes this run's draws touch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Draw word w of a chunk: from its row of the draws buffer where one is
// given, else hashed from the chunk's key.
__device__ __forceinline__ int scaled(const int32_t* __restrict__ row,
                                      uint32_t key, uint32_t word, float scale,
                                      int hi) {
  const uint32_t u =
      row != nullptr ? (uint32_t)row[word] : mix32(key ^ mix32(word)) >> 8;
  return min((int)__fmul_rn((float)u, scale), hi);
}

__global__ void __launch_bounds__(THREADS)
sample(const int32_t* __restrict__ ct, const uint8_t* __restrict__ bitmap,
       const int32_t* __restrict__ u24, uint32_t seed, int n_chunks, int C,
       int n, int draws, float scale, long long stride_bytes,
       int32_t* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_chunks * C) return;
  const int c = (int)(idx / C), j = (int)(idx % C);
  const uint32_t key = mix32(seed + mix32((uint32_t)c + 0x9e3779b9U));
  const int32_t* row =
      u24 != nullptr ? u24 + (size_t)c * draws * C : nullptr;
  int pair;
  if (draws == 2) {
    const int src = scaled(row, key, (uint32_t)j, scale, n - 1);
    const int dst = scaled(row, key, (uint32_t)(C + j), scale, n - 1);
    pair = dst * n + src;
  } else {
    pair = scaled(row, key, (uint32_t)j, scale, n * n - 1);
  }
  const uint8_t byte = bitmap[(long long)ct[c] * stride_bytes + (pair >> 3)];
  out[idx] = ((byte >> (pair & 7)) & 1) ? -pair - 1 : pair;
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/sampler.py).  bitmap: the
// relation-strided uint32 words, read as bytes; u24: null (hash the draws
// from seed) or [n_chunks, draws * C] int32 draws below 2^24; out:
// [n_chunks, C] int32.  Returns the first CUDA error.
extern "C" int tip_typed_neg_sampler(const int32_t* ct, const uint8_t* bitmap,
                                     const int32_t* u24, unsigned int seed,
                                     int n_chunks, int C, int n, int draws,
                                     float scale, long long stride_bytes,
                                     int32_t* out, void* stream) {
  const size_t slots = (size_t)n_chunks * C;
  const unsigned blocks = (unsigned)((slots + THREADS - 1) / THREADS);
  sample<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      ct, bitmap, u24, seed, n_chunks, C, n, draws, scale, stride_bytes, out);
  return cudaGetLastError();
}
