// One ring step of the row-sharded P-P SpMM (kernel B11) for Hopper
// (sm_90a), with the activation shard's hand-off to the ring neighbour done
// by the kernel itself.
//
// Replaces the Pallas TPU kernel of tip_tpu/ops/pallas_ring.py
// (ring_spmm_rdma: _ring_kernel).  Ring rank i holds shards of n_local
// protein rows; over k steps it computes
//   out_i = sum_s A[rows_i, rows_(i+s) mod k] @ h_(i+s) mod k
// from its ring blocks src_l, dst_l, w [k, E_pad] (parallel/ring.py:
// build_ring_pp: each block's real edges sorted by local destination, then
// a tail of pad slots with dst_local = 0, w = 0).  The TPU kernel is one
// call over a grid of k steps; here each step is one launch
// (ops/ring.py:ring_spmm_cuda), in stream order on the rank's device:
//
//   * the first `copy_blocks` blocks copy the shard this rank holds (its own
//     h at step 0, else comm slot s % 2) into the LEFT neighbour's comm slot
//     (s + 1) % 2 through the neighbour's CUDA IPC pointer, when s < k - 1:
//     the counterpart of make_async_remote_copy(...).start();
//   * the other blocks run the block's SpMM over the same shard while the
//     copy is in flight, one warp a window of 32 slots: the warp finds the
//     slots of its window where a run of equal destinations starts (a
//     ballot), and for each such run reads the run's src and w 32 slots at
//     a time, one slot a lane, broadcasts them by shuffle, and has lane k
//     gather h[src][k] for every slot of the 32 at once (independent loads
//     in flight, not a chain), then sum them in slot order and add the run's
//     sum to out[row][k] once.  A run that goes on past the window is
//     followed by the warp that found its start.  A destination below the
//     previous slot's is the pad tail and starts no run (its slots have w =
//     0; where the real edges end on row 0 the tail extends that run by
//     zeros).  Each row has one run a block, so out is read and written by
//     one lane: no atomics, and the result is deterministic (each row's
//     sum in slot order).  out is zero-filled before step 0;
//   * the pairwise neighbour barrier of the TPU kernel: each block's
//     threads meet at __syncthreads(), and then one thread fences system-
//     wide (the fence is cumulative: it orders the block's writes that the
//     barrier made visible to it) and counts the block done (a counter in
//     this rank's buffer); the last block fences again, bumps its step
//     count in both neighbours' buffers (the left one's "from its right"
//     word, the right one's "from its left" word) and waits, with acquire
//     loads, until both of its own words reach `target`, its own step
//     count.  So no rank enters step s + 1 before both neighbours finished
//     step s: the right neighbour's copy into this rank's slot (s + 1) % 2
//     has landed, and the left neighbour no longer reads the slot this rank
//     writes next.  One word a neighbour, not one sum: a neighbour that is a
//     step ahead must not stand in for one that is a step behind.  Ranks
//     time-sliced on one card wait for each other's contexts; the wait is
//     bounded by timeout_ns (the card's global timer) and traps past it, so
//     a lost neighbour ends in a launch error, not a hang.
//
// The first version staged 512 slots a block, had one thread a (run,
// feature) walk its run with dependent loads, and fenced in every thread:
// about twice as slow a step (PERF.md).
//
// The backward of the ring SpMM is this same op on the cotangent, because
// the cached normalization A_hat is symmetric (ops/ring.py).
//
// Bound on an H100 at Decagon shape with k = 4 (n_local 4,771, E_pad 85,504,
// d = 32): one step reads the block (12 bytes a slot, 1.03 MB), the shard
// (0.61 MB) and out, writes out, and copies the shard (read and write):
// ~4.1 MB, ~1.2 us at 3.35 TB/s; its 2 float operations per slot and
// feature are ~0.1 us at 67 TFLOP/s, so bytes bound it, and at that size a
// launch costs more than the work.  chip_smoke.py reckons the bound from
// its run.  A block whose real edges all end on row 0 (or that has none)
// sums its zero tail in one warp: right, and slow; each block of the
// Decagon-shaped ring holds 79,784-85,200 real edges.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COPY_BLOCKS = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// out[dl] += sum of w[e] h[src[e]] over the run of destination dl that
// starts at slot e0, in slot order; called by a whole warp.
__device__ __forceinline__ void sum_run(const float* __restrict__ h,
                                        const int32_t* __restrict__ src,
                                        const int32_t* __restrict__ dst,
                                        const float* __restrict__ w, int e_pad,
                                        int d, int e0, int dl, int lane,
                                        float* __restrict__ out) {
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int k = k0 + lane;
    // the row's value so far (one writer: read it while the run loads)
    const float o = k < d ? out[(size_t)dl * d + k] : 0.f;
    float s = 0.f;
    for (int e = e0;; e += 32) {
      // src and w load beside dst, not after it
      const int g = e + lane;
      const bool ok = g < e_pad;
      const bool in = ok && dst[g] == dl;
      const int sg = ok ? src[g] : 0;
      const float wg = ok ? w[g] : 0.f;
      // the run's slots in this group: those before the first that is not
      const unsigned stay = __ballot_sync(FULL, in);
      const int len = __ffs(~stay) ? __ffs(~stay) - 1 : 32;
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int si = __shfl_sync(FULL, sg, i);
        const float wi = __shfl_sync(FULL, wg, i);
        v[i] = (i < len && k < d) ? __fmul_rn(h[(size_t)si * d + k], wi) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i < len) s = __fadd_rn(s, v[i]);
      if (len < 32) break;
    }
    if (k < d) out[(size_t)dl * d + k] = __fadd_rn(o, s);
  }
}

__global__ void __launch_bounds__(THREADS)
ring_step(const float* __restrict__ h, float* __restrict__ peer,
          const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
          const float* __restrict__ w, int e_pad, int d, int copy_blocks,
          size_t n_copy, float* __restrict__ out, unsigned* done,
          unsigned* my_flag, unsigned* left_flag, unsigned* right_flag,
          unsigned target, unsigned long long timeout_ns) {
  if ((int)blockIdx.x < copy_blocks) {
    // shard -> the left neighbour's spare slot, 16 bytes a thread where
    // both ends are 16-byte aligned (slots and shards are)
    const size_t stride = (size_t)copy_blocks * blockDim.x;
    const size_t n4 = n_copy / 4;
    const float4* h4 = reinterpret_cast<const float4*>(h);
    float4* p4 = reinterpret_cast<float4*>(peer);
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
         i += stride)
      p4[i] = h4[i];
    for (size_t i = 4 * n4 + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_copy; i += stride)
      peer[i] = h[i];
  } else {
    const int lane = threadIdx.x & 31;
    const int base =
        (((int)blockIdx.x - copy_blocks) * WARPS + (int)(threadIdx.x >> 5)) * 32;
    const int g = base + lane;
    bool f = false;
    int dl = 0;
    if (g < e_pad) {
      dl = dst[g];
      f = g == 0 || dst[g - 1] < dl;
    }
    // the runs that start in this window, in slot order
    for (unsigned m = __ballot_sync(FULL, f); m; m &= m - 1) {
      const int i = __ffs(m) - 1;
      sum_run(h, src, dst, w, e_pad, d, base + i, __shfl_sync(FULL, dl, i),
              lane, out);
    }
  }

  if (left_flag == nullptr) return;  // a ring of one: no neighbour
  __syncthreads();
  if (threadIdx.x != 0) return;
  // cumulative: orders every write of the block that the barrier ordered
  // before this thread's
  __threadfence_system();
  if (atomicAdd(done, 1u) != gridDim.x - 1) return;
  // the last block: every block's writes (out, the peer copy) are visible
  __threadfence_system();
  *done = 0u;  // for the next launch, which runs after this one ends
  atomicAdd_system(left_flag, 1u);
  atomicAdd_system(right_flag, 1u);
  const unsigned long long t0 = global_ns();
  // my_flag[0]: the left neighbour's steps; my_flag[1]: the right one's
  while ((int)(load_acquire(my_flag) - target) < 0 ||
         (int)(load_acquire(my_flag + 1) - target) < 0) {
    if (global_ns() - t0 > timeout_ns) __trap();
    __nanosleep(1000);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/ring.py).  Each returns
// the first CUDA error.

// A zero-filled device allocation of `bytes` on the current device (the
// ring buffers that neighbours open by IPC; cudaMalloc, which IPC needs).
extern "C" int tip_ring_alloc(long long bytes, void** out) {
  cudaError_t err = cudaMalloc(out, (size_t)bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemset(*out, 0, (size_t)bytes);
  if (err != cudaSuccess) return err;
  // zeroed before a neighbour can map it and write to it
  return cudaDeviceSynchronize();
}

extern "C" int tip_ring_free(void* p) { return cudaFree(p); }

// The 64-byte IPC handle of an allocation made by tip_ring_alloc.
extern "C" int tip_ring_export(void* p, void* handle) {
  return cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, p);
}

// Another process's allocation, mapped into this one.
extern "C" int tip_ring_import(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int tip_ring_close(void* p) { return cudaIpcCloseMemHandle(p); }

extern "C" int tip_ring_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// One ring step: out [n_local, d] += block(src, dst, w) @ h, and h's
// [n_local, d] copied to `peer` unless peer is null; then the neighbour
// barrier unless left_flag is null: bump *left_flag and *right_flag, wait
// until my_flag[0] and my_flag[1] reach target, `done` the block counter.
extern "C" int tip_ring_step(const float* h, float* peer, const int32_t* src,
                             const int32_t* dst, const float* w, int e_pad,
                             int n_local, int d, float* out, unsigned* done,
                             unsigned* my_flag, unsigned* left_flag,
                             unsigned* right_flag, unsigned int target,
                             long long timeout_ns, void* stream) {
  const int copy_blocks = peer == nullptr ? 0 : COPY_BLOCKS;
  const int spmm_blocks = (e_pad + THREADS - 1) / THREADS;  // a warp 32 slots
  ring_step<<<copy_blocks + spmm_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      h, peer, src, dst, w, e_pad, d, copy_blocks, (size_t)n_local * d, out,
      done, my_flag, left_flag, right_flag, target,
      (unsigned long long)timeout_ns);
  return cudaGetLastError();
}
