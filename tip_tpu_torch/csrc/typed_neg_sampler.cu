// Typed negative sampler for chunk-aligned edge buffers, for Hopper
// (sm_90a): one candidate pair per slot, sign-flagged where it is a
// positive of the slot's relation, then the lane-borrow pass that resolves
// the flagged slots and the split of each pair into (src, dst), in one
// launch.
//
// Replaces the Pallas TPU kernel of tip_tpu/ops/pallas_sampler.py
// (typed_negative_sampling_padded: _sampler_kernel, called with one
// full-width round and no tail rounds) and the XLA pass that follows it
// there (resolve_borrow).  Per slot (c, j) of the [n_chunks, C] buffer, for
// relation t = chunk_type[c]:
//   n^2 <= 2^24: pair = min(int(f32(u24[j]) * scale), n^2 - 1),
//                scale = f32(n^2 / 2^24)
//   n > 4096:    src = min(int(f32(u24[j]) * scale), n - 1),
//                dst = min(int(f32(u24[C + j]) * scale), n - 1),
//                scale = f32(n / 2^24), pair = dst * n + src
//   raw = pair, or -pair - 1 when bit (pair & 7) of byte (pair >> 3) of
//   relation t's slice of the little-endian bitmap is set.
// The f32 multiply is rounded to nearest (__fmul_rn) and truncated toward
// zero, as the JAX kernel's astype(int32) does.  The borrow pass is four
// rounds at shifts s = 1, 2, 4, 8: a flagged lane j takes the value of
// lane (j - s) mod C of the previous round where that value is clean
// (torch.roll(out, s, dims=1) and a where, ops/sampler.py:resolve_borrow);
// a lane still flagged after the last round is un-flagged as drawn
// (-raw - 1).  The resolved pair is then written whole, or split into
// src = pair mod n and dst = pair div n (sampling/negative.py), or the raw
// flagged pairs are written and the borrow pass skipped (resolve = 0).
//
// Random bits.  The TPU kernel draws from its on-chip PRNG; here draw word
// w of chunk c is u24 = mix32(key_c ^ mix32(w)) >> 8 with key_c =
// mix32(seed + mix32(c + 0x9e3779b9)) (lowbias32 mixer), the field that
// ops/sampler.py:sampler_u24 computes in PyTorch, so kernel and plain
// version give the same pairs.  Given a draws buffer u24 [n_chunks,
// draws * C] int32 instead (a non-null pointer), it reads word w of chunk c
// from there, as the plain version does with explicit draws.
//
// Design.  One block takes one chunk, a thread LANES lanes of it (lane i *
// blockDim + threadIdx, so each round's loads and stores are coalesced).
// A lane keeps its value in registers as (signed pair, src | dst << 16):
// the split comes from the draws themselves in the two-draw mode and from
// one division in the one-draw mode, before the borrow pass, and travels
// with the pair.  Each borrow round writes the chunk's values to shared
// memory, waits for the block, reads lane (j - s) mod C, selects, and waits
// again before the next round overwrites the row.  Each slot reads its one
// bitmap byte from device memory: the slots of a chunk share a relation,
// so their bytes lie in one 53 KB (n = 645) or 295 KB (n = 1,536) slice
// that L2 keeps.  The flagged pairs never reach device memory in the
// resolved modes.  The first version launched one thread a slot (a 64-bit
// division of the slot index by C each) and left the borrow pass (four
// torch.roll / torch.where rounds over the whole buffer, and a final
// where) and the split (% and //) to PyTorch: ~0.6 ms a step at Decagon
// shape.
//
// Bound on an H100 at Decagon shape (~9.0 M slots): it must write src and
// dst (72 MB), read the chunk types, and read the bitmap bytes its draws
// touch (at most one per slot): ~0.022 ms at 3.35 TB/s.  Its arithmetic is
// two 32-bit hashes and one f32 multiply a draw; chip_smoke.py reckons the
// bound from the bytes this run's draws touch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;  // 2 lanes a thread at C = 1,024 (PERF.md)
constexpr int MAX_LANES = 8;  // lanes a thread: C <= MAX_LANES * THREADS

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
      row != nullptr ? (uint32_t)__ldg(row + word) : mix32(key ^ mix32(word)) >> 8;
  return min((int)__fmul_rn((float)u, scale), hi);
}

// resolve: 0 writes the raw flagged pairs to pair_out; 1 runs the borrow
// pass and writes the resolved pairs to pair_out (if not null) and their
// src, dst to src_out, dst_out (if not null).
template <int LANES>
__global__ void __launch_bounds__(THREADS)
sample(const int32_t* __restrict__ ct, const uint8_t* __restrict__ bitmap,
       const int32_t* __restrict__ u24, uint32_t seed, int C, int n, int draws,
       float scale, long long stride_bytes, int resolve,
       int32_t* __restrict__ pair_out, int32_t* __restrict__ src_out,
       int32_t* __restrict__ dst_out) {
  extern __shared__ int2 row_sh[];  // [C]: a borrow round's values
  const int c = blockIdx.x;
  const uint32_t key = mix32(seed + mix32((uint32_t)c + 0x9e3779b9U));
  const int32_t* row = u24 != nullptr ? u24 + (size_t)c * draws * C : nullptr;
  const uint8_t* slice = bitmap + (long long)__ldg(ct + c) * stride_bytes;
  const size_t base = (size_t)c * C;
  int p[LANES] = {}, sd[LANES] = {};  // signed pair; src | dst << 16
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    const int j = i * blockDim.x + threadIdx.x;
    if (j >= C) continue;
    int pair, src, dst;
    if (draws == 2) {
      src = scaled(row, key, (uint32_t)j, scale, n - 1);
      dst = scaled(row, key, (uint32_t)(C + j), scale, n - 1);
      pair = dst * n + src;
    } else {
      pair = scaled(row, key, (uint32_t)j, scale, n * n - 1);
      dst = pair / n;
      src = pair - dst * n;
    }
    const uint8_t byte = __ldg(slice + (pair >> 3));
    p[i] = ((byte >> (pair & 7)) & 1) ? -pair - 1 : pair;
    sd[i] = (int)((uint32_t)src | ((uint32_t)dst << 16));
  }
  if (!resolve) {
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      const int j = i * blockDim.x + threadIdx.x;
      if (j < C) pair_out[base + j] = p[i];
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = (1 << r) % C;  // shifts 1, 2, 4, 8
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      const int j = i * blockDim.x + threadIdx.x;
      if (j < C) row_sh[j] = make_int2(p[i], sd[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      const int j = i * blockDim.x + threadIdx.x;
      if (j >= C) continue;
      const int2 alt = row_sh[j >= s ? j - s : j - s + C];
      if (p[i] < 0 && alt.x >= 0) {
        p[i] = alt.x;
        sd[i] = alt.y;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < LANES; ++i) {
    const int j = i * blockDim.x + threadIdx.x;
    if (j >= C) continue;
    if (pair_out != nullptr) pair_out[base + j] = p[i] < 0 ? -p[i] - 1 : p[i];
    if (src_out != nullptr) {
      src_out[base + j] = sd[i] & 0xffff;
      dst_out[base + j] = (int)((uint32_t)sd[i] >> 16);
    }
  }
}

template <int LANES>
cudaError_t launch(const int32_t* ct, const uint8_t* bitmap, const int32_t* u24,
                   uint32_t seed, int n_chunks, int C, int n, int draws,
                   float scale, long long stride_bytes, int resolve,
                   int32_t* pair_out, int32_t* src_out, int32_t* dst_out,
                   int threads, cudaStream_t s) {
  const size_t smem = resolve ? (size_t)C * sizeof(int2) : 0;
  sample<LANES><<<n_chunks, threads, smem, s>>>(
      ct, bitmap, u24, seed, C, n, draws, scale, stride_bytes, resolve,
      pair_out, src_out, dst_out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/sampler.py).  bitmap: the
// relation-strided uint32 words, read as bytes; u24: null (hash the draws
// from seed) or [n_chunks, draws * C] int32 draws below 2^24; outputs
// [n_chunks, C] int32: with resolve = 0 the raw flagged pairs in pair_out,
// else the resolved pairs in pair_out and/or their src and dst in src_out
// and dst_out (null where not wanted).  1 <= C <= 4096 (a row of
// 32 KB in shared memory), n <= 46340.
// Returns the first CUDA error.
extern "C" int tip_typed_neg_sampler(const int32_t* ct, const uint8_t* bitmap,
                                     const int32_t* u24, unsigned int seed,
                                     int n_chunks, int C, int n, int draws,
                                     float scale, long long stride_bytes,
                                     int resolve, int32_t* pair_out,
                                     int32_t* src_out, int32_t* dst_out,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks == 0) return cudaSuccess;
  if (C < 1 || C > MAX_LANES * THREADS) return cudaErrorInvalidValue;
  const int threads = C < THREADS ? (C + 31) / 32 * 32 : THREADS;
  const int lanes = (C + threads - 1) / threads;
#define TIP_SAMPLE(L)                                                        \
  return launch<L>(ct, bitmap, u24, seed, n_chunks, C, n, draws, scale,     \
                   stride_bytes, resolve, pair_out, src_out, dst_out,       \
                   threads, s)
  if (lanes <= 1) TIP_SAMPLE(1);
  if (lanes <= 2) TIP_SAMPLE(2);
  if (lanes <= 4) TIP_SAMPLE(4);
  TIP_SAMPLE(8);
#undef TIP_SAMPLE
}
