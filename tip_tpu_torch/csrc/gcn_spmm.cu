// Windowed P-P SpMM of the GCN for Hopper (sm_90a): out = A_hat @ x.
//
// Replaces the Pallas TPU kernel of tip_tpu/ops/pallas_segment.py
// (gcn_spmm_padded: _wscatter_kernel, with the x[src] * w gather that the
// JAX package runs outside it fused in):
//   out[win * W + dl, k] = sum_{e in window win, dst_local_e = dl} x[src_e, k] * w_e
// over the buffers of data/packing.py:pad_windowed_edges: src/dst_local/w
// [n_chunks, C], chunk_window [n_chunks] non-decreasing, pad slots with
// dst_local = W and w = 0 at the end of each window, every window owning
// >= 1 chunk.  The last window runs past n; its rows >= n are not written.
// Each product is rounded to float32 (and to bf16 with round_bf16, the JAX
// package's msgs cast) before it is summed, as the plain version does.
// The backward of the GCN layer is this same kernel on dout, which holds
// because A_hat is symmetric.
//
// Design.  Inside a window the buffer is sorted by destination (then
// source), so each output row's edges are one run of slots, which may go
// on across the window's chunks; two slots with the same window and row
// bound a run (same_run).  The slots are read as one flat array, cut into
// groups of 32, a warp a group (spmm):
//   * the warp loads its 32 slots' dst_local, src and w, one slot a lane,
//     and the slots just before and after the group, in one round, and
//     cuts the group into pieces, the runs' parts inside it (ballot);
//   * each lane gathers x[src][k] of its feature k for all 32 slots at
//     once, src broadcast by shuffle (d <= 16: a half-warp a slot, two
//     slots an instruction; the kernel is instantiated for d <= 16 and for
//     wider rows, which keeps it at ~60 registers), then walks the slots in
//     order, summing each piece;
//   * a piece that is a whole run is written to its row; the piece that a
//     run from an earlier group leaves in this group goes to first[group],
//     the piece of a run that starts here and goes on to last[group], and
//     the group records in meta how many later groups that run reaches;
//   * spmm_runs, a warp a group with such a run, adds last[g] + first[g +
//     1] + ... in group order into its row, its lanes over the features: a
//     hub row of thousands of edges is cut into groups like the rest.
// Every row is written once, with no atomics, its sum in an order fixed by
// the data: deterministic.  out is zero-filled first.  The first version
// gave one thread a (run, feature), which waited on one gather at a time
// (~69 a row at Decagon shape) and walked a hub alone (1.18 ms for a
// 4,569-edge row, PERF.md); one warp a run following it from its start
// (B11's walk) measured 0.101 ms at d = 32, slower than the first's 0.077,
// and this design 0.095 until its gathers issued unconditionally (not one
// after another behind their pad tests) and its registers fell from 126.
//
// Bound on an H100 at Decagon shape (n = 19,081 proteins, d = 32 or 16,
// ~1.31 M slots at window 1024 / chunk 512): it must read src, dst_local and
// w (12 bytes a slot, ~16 MB), x, and write out: ~0.006 ms at 3.35 TB/s;
// its 2 float operations per edge and feature are ~1 % of that at
// 67 TFLOP/s, so bytes bound it.  chip_smoke.py reckons the bound from its
// run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Bufs {
  const float* x;
  const int32_t* src;
  const int32_t* dstl;
  const float* w;
  const int32_t* cw;
  int E;  // slots (the wrapper checks that they fit an int)
  int C, window, n, d, round_bf16;
};

__device__ __forceinline__ int window_of(const Bufs& B, int e) {
  return B.cw[(unsigned)e / (unsigned)B.C];
}

// slots a < b (both < E) lie in one run: one window, one real row (the
// window is sorted, so every slot between them does too)
__device__ __forceinline__ bool same_run(const Bufs& B, int a, int b) {
  const int dl = B.dstl[b];
  return dl < B.window && B.dstl[a] == dl &&
         window_of(B, a) == window_of(B, b);
}

__device__ __forceinline__ float msg(float xv, float wv, int round_bf16) {
  const float m = __fmul_rn(xv, wv);
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(m)) : m;
}

// first, last: [groups][d]; meta[g] = (J, row) where a run starts in group
// g and reaches the J > 0 groups after it, else (0, row).  HALF: d <= 16,
// a half-warp a slot.  Control is warp-uniform throughout.
template <bool HALF>
__global__ void __launch_bounds__(THREADS)
spmm(Bufs B, float* __restrict__ out, float* __restrict__ first,
     float* __restrict__ last, int2* __restrict__ meta) {
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int base = grp * 32;
  if (base >= B.E) return;  // whole warps
  // the group's slots, one a lane, and (lanes 0 and 31) the slots just
  // before and after it, all in one round of loads
  const int gi = base + lane;
  int dl = B.window, win = -1, sv = 0;
  float wg = 0.f;
  if (gi < B.E) {
    dl = B.dstl[gi];
    win = window_of(B, gi);
    sv = B.src[gi];
    wg = B.w[gi];
  }
  const int nb = lane == 0 ? base - 1 : base + 32;
  int ndl = B.window, nwin = -2;
  if ((lane == 0 || lane == 31) && nb >= 0 && nb < B.E) {
    ndl = B.dstl[nb];
    nwin = window_of(B, nb);
  }
  const bool real = dl < B.window;
  const unsigned reals = __ballot_sync(FULL, real);
  const int pdl = __shfl_up_sync(FULL, dl, 1);
  const int pwin = __shfl_up_sync(FULL, win, 1);
  // piece starts; piece ends (real slots whose next slot starts no piece
  // or is not real)
  const unsigned brk =
      __ballot_sync(FULL, real && (lane == 0 || dl != pdl || win != pwin));
  const unsigned ends = reals & ~((reals & ~brk) >> 1);
  const int row31 = __shfl_sync(FULL, win, 31) * B.window +
                    __shfl_sync(FULL, dl, 31);
  if (!ends) {  // pads only
    if (lane == 0) meta[grp] = make_int2(0, row31);
    return;
  }
  // the first piece goes on from the group before; the last into the next
  // (lane 0, 31: its slot and the one before, after the group share a row)
  const bool same = ndl == dl && nwin == win;
  const bool cont_in = (reals & 1u) && __shfl_sync(FULL, same, 0);
  const bool cont_out = (reals >> 31) && __shfl_sync(FULL, same, 31);
  const int first_end = __ffs(ends) - 1;
  for (int k0 = 0; k0 < (HALF ? 1 : B.d); k0 += 32) {
    const int k = HALF ? (lane & 15) : k0 + lane;
    const bool kin = k < B.d;
    const int kk = kin ? k : 0;
    // The gathers are unconditional, so they all issue at once: a pad slot
    // (src 0, w 0) only feeds a piece that has ended, and a lane past d
    // reads feature 0 and writes nothing.  HALF: lane (k, h) holds slot
    // 2 m + h's product in p[m].
    float p[HALF ? 16 : 32];
#pragma unroll
    for (int m = 0; m < (HALF ? 16 : 32); ++m) {
      const int i = HALF ? 2 * m + (lane >> 4) : m;
      p[m] = B.x[(size_t)__shfl_sync(FULL, sv, i) * B.d + kk];
    }
#pragma unroll
    for (int m = 0; m < (HALF ? 16 : 32); ++m)
      p[m] = msg(p[m], __shfl_sync(FULL, wg, HALF ? 2 * m + (lane >> 4) : m),
                 B.round_bf16);
    const bool writer = HALF ? lane < B.d : kin;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float vi = !HALF ? p[i]
                     : (i & 1) ? __shfl_down_sync(FULL, p[i >> 1], 16)
                               : p[i >> 1];
      // a pad slot adds its 0 to the piece before it, which has ended
      s = __fadd_rn((brk >> i) & 1u ? 0.f : s, vi);
      if (!((ends >> i) & 1u)) continue;
      const int row = __shfl_sync(FULL, win, i) * B.window +
                      __shfl_sync(FULL, dl, i);
      float* dst;
      if (i == first_end && cont_in)
        dst = first + (size_t)grp * B.d;
      else if (i == 31 && cont_out)
        dst = last + (size_t)grp * B.d;
      else if (row < B.n)
        dst = out + (size_t)row * B.d;
      else
        continue;
      if (writer) dst[HALF ? lane : k] = s;
    }
  }
  // a run that starts here and goes on: count the groups it reaches
  int J = 0;
  if (cont_out && (first_end != 31 || !cont_in)) {
    for (;;) {
      const int e = base + 32 * (J + 1 + lane);
      const unsigned more =
          __ballot_sync(FULL, e < B.E && same_run(B, base + 31, e));
      const int run = ~more ? __ffs(~more) - 1 : 32;
      J += run;
      if (run < 32) break;
    }
  }
  if (lane == 0) meta[grp] = make_int2(J, row31);
}

// One warp a group g with meta[g].x = J > 0: its run's row gets last[g] +
// first[g + 1] + ... + first[g + J], in group order, its lanes over the
// features.
__global__ void __launch_bounds__(THREADS)
spmm_runs(Bufs B, const int2* __restrict__ meta,
          const float* __restrict__ first, const float* __restrict__ last,
          float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (grp * 32 >= B.E) return;
  const int2 m = meta[grp];
  if (m.x == 0 || m.y >= B.n) return;
  for (int k = lane; k < B.d; k += 32) {
    float s = last[(size_t)grp * B.d + k];
#pragma unroll 8
    for (int p = 1; p <= m.x; ++p)
      s = __fadd_rn(s, first[(size_t)(grp + p) * B.d + k]);
    out[(size_t)m.y * B.d + k] = s;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/typed_segment.py).  out:
// [n, d] float32, zero-filled here; scratch part: 2 ceil(n_chunks C / 32)
// (d + 1) floats (the pieces first, last [groups][d], then meta [groups]
// int2).  Returns the first CUDA error.
extern "C" int tip_gcn_spmm(const float* x, const int32_t* src,
                            const int32_t* dstl, const float* w,
                            const int32_t* cw, int n_chunks, int C, int window,
                            int n, int d, int round_bf16, float* part,
                            float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n * d * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const Bufs B{x, src, dstl, w, cw, n_chunks * C, C, window, n, d, round_bf16};
  if (B.E == 0) return cudaSuccess;
  const int groups = (B.E + 31) / 32;
  float* first = part;
  float* last = part + (size_t)groups * d;
  int2* meta = reinterpret_cast<int2*>(part + (size_t)2 * groups * d);
  const int blocks = (groups + WARPS - 1) / WARPS;
  if (d <= 16)
    spmm<true><<<blocks, THREADS, 0, s>>>(B, out, first, last, meta);
  else
    spmm<false><<<blocks, THREADS, 0, s>>>(B, out, first, last, meta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  spmm_runs<<<blocks, THREADS, 0, s>>>(B, meta, first, last, out);
  return cudaGetLastError();
}
