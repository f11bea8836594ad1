// Typed neighbour sum of the chunked R-GCN for Hopper (sm_90a), forward and
// backward.
//
// Replaces the Pallas TPU kernels of tip_tpu/ops/pallas_segment.py
// (typed_neighbor_sum_padded_t: _tns_fwd_kernel, _tns_bwd_kernel):
//   forward   P^T[t, k, d] = sum_{e in relation t, dst_e = d} x[src_e, k]
//   backward  dx[s, k]     = sum_t sum_{e in t, src_e = s} dP^T[t, k, dst_e]
// over the chunk-aligned buffers of data/packing.py:pad_typed_edges:
// src/dst [n_chunks, C] int32, chunk_type [n_chunks] non-decreasing, each
// relation's slots sorted by dst, pad slots (dst = n, src = 0) after them.
// A relation may own no chunk (a rank's shard of the buffers); its P^T rows
// are zero.  The output keeps the JAX package's transposed [n_et, d, n]
// layout.
//
// The TPU kernels gather and scatter with one-hot matmuls, since the TPU
// has no fast scatter; a GPU gathers and scatters natively, so nothing of
// that is carried over.
//
// Both directions run on a persistent grid of independent warps, each of
// which takes whole chunks from a counter, with no block-wide barrier
// between them.  A warp reads a chunk 32 slots at a time (one coalesced
// load, with the next window already in flight), finds the window's run
// starts and its end with two ballots, and walks the slots in order with
// its lanes over the features, branching only where a run starts.
//
// Forward.  Inside a relation the edges into (t, d) are one contiguous run
// of slots.  A block holds one feature slice of x in shared memory (kslice
// features, a power of two dividing d, read by consecutive lanes from
// consecutive banks; ops/typed_segment.py:tns_fwd_kslice picks it; past the
// shared-memory limit the global mode reads x from device memory).  A warp
// sums each run that starts in its chunk in slot order (reading on into the
// relation's next chunk to finish the last one; no atomics: the result is
// deterministic), and stages the sums in a [kslice][16 destinations] tile
// of its own, which it writes to P^T[t, k, p0..p0+15] as row segments,
// zeros included for destinations without edges: the chunk owns the
// destinations from the one after its predecessor's last to its own last
// (to n - 1 for the relation's last chunk).  The rows of relations that own
// no chunk (most of them on a rank's shard of the buffers) are zeroed first,
// a relation a warp, dealt round every block of the grid.  So every element
// of P^T is written once and no zero-fill pass precedes the kernel.
//
// Backward.  src is not sorted, so the scatter adds atomically.  A warp
// stages the dP^T columns of 16 destinations at a time ([slice][16] tile,
// coalesced row segments; the chunk's destinations are one sorted span, so
// each dP^T element is read about once), reads a run's column once and adds
// it into dx[src] for each slot of the run: one float2 atomic a lane into
// device memory (native vector atomics in L2; a float atomic add to shared
// memory is a compare-and-swap loop on this card, and an accumulator there
// measured slower at every shape).  Atomics add in no fixed order, so the
// backward is not bit-for-bit deterministic.
//
// Bound on an H100 at Decagon shape, layer 1 (d = 64, ~9.0 M slots in
// ~8.8 k chunks, n = 645, 1,097 relations): the forward must read the
// indices (72 MB) and write P^T (181 MB), ~0.076 ms at 3.35 TB/s; its
// 0.54 G float adds take 0.008 ms at 67 TFLOP/s, so bytes bound it; the
// backward reads the same bytes the other way.  chip_smoke.py reckons the
// bound from its run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int WIN = 32;       // slots a warp loads at a time
constexpr int SD = 16;        // destinations a warp stages at a time
constexpr int SDS = SD + 1;   // row stride of a warp's staging tile
constexpr unsigned FULL = 0xffffffffu;

// Shared memory, in floats: the slice [n][ks] (shared mode) and one
// [ks][SDS] staging tile a warp (ops/typed_segment.py plans with the same
// count).
int smem_floats(int n, int ks, int warps, bool shared) {
  return (shared ? n * ks : 0) + warps * ks * SDS;
}

// Slot `off` of chunk c (off >= C reads on into the next chunks) as
// (src, dst), or (0, n) past `limit` slots of chunk c or where its chunk
// belongs to another relation than t.
__device__ __forceinline__ void load_slot(const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ dst,
                                          const int32_t* __restrict__ ct,
                                          int c, int off, size_t limit, int C,
                                          int t, int n, int& sv, int& dv) {
  sv = 0;
  dv = n;
  const size_t idx = (size_t)c * C + off;
  if (off < limit && (off < C || ct[c + off / C] == t)) {
    sv = src[idx];
    dv = dst[idx];
  }
}

// P^T[t, slice, p] for p in [p0, min(p0 + SD, hi + 1)) from the warp's
// staging tile, which is zeroed behind.
__device__ __noinline__ void flush_stage(float* __restrict__ rows, int n,
                                         int ks, int p0, int hi,
                                         float* stage) {
  const int lane = threadIdx.x & 31, j = lane & (SD - 1);
  __syncwarp();
  const int p = p0 + j;
  for (int k = lane / SD; k < ks; k += WIN / SD) {
    float* s = stage + k * SDS + j;
    if (p <= hi) rows[(size_t)k * n + p] = *s;
    *s = 0.f;
  }
  __syncwarp();
}

// Stage the sums (s0: feature lane, s1: lane + 32) of the run into
// destination cur, writing out the staged destinations before it first.
template <int KPL>
__device__ __forceinline__ void emit_run(float* __restrict__ rows, int n,
                                         int ks, int hi, int cur, int& p0,
                                         float s0, float s1, float* stage) {
  const int lane = threadIdx.x & 31;
  while (cur >= p0 + SD) {
    flush_stage(rows, n, ks, p0, hi, stage);
    p0 += SD;
  }
  if (lane < ks) stage[lane * SDS + cur - p0] = s0;
  if (KPL == 2) stage[(lane + 32) * SDS + cur - p0] = s1;
}

// The next chunk for this warp: chunks are handed out in order from one
// counter a feature slice, so warps that finish early take more.
__device__ __forceinline__ int next_chunk(int* counter) {
  int c = 0;
  if ((threadIdx.x & 31) == 0) c = atomicAdd(counter, 1);
  return __shfl_sync(FULL, c, 0);
}

// Whether relation t owns a chunk (chunk_type is non-decreasing).
__device__ bool owns_chunk(const int32_t* __restrict__ ct, int n_chunks,
                           int t) {
  int lo = 0, hi = n_chunks;  // the first chunk of a relation >= t
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ct[mid] < t) lo = mid + 1;
    else hi = mid;
  }
  return lo < n_chunks && ct[lo] == t;
}

// P^T rows of relation t, slice k0..k0+ks: zeros (a warp).
__device__ void zero_rows(float* __restrict__ out, int t, int d, int n,
                          int k0, int ks) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < ks; ++k) {
    float* row = out + ((size_t)t * d + k0 + k) * n;
    for (int p = lane; p < n; p += WIN) row[p] = 0.f;
  }
}

// KPL: features a lane takes (2 for a 64-feature slice, else 1: lanes
// past the slice idle).
template <bool SHARED_X, int KPL>
__global__ void __launch_bounds__(MAX_THREADS)
tns_fwd(const float* __restrict__ x, const int32_t* __restrict__ src,
        const int32_t* __restrict__ dst, const int32_t* __restrict__ ct,
        int n_chunks, int C, int n, int d, int n_et, int ks,
        int* __restrict__ counters, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x % (d / ks), group = blockIdx.x / (d / ks);
  const int k0 = slice * ks;
  float* xs = smem;  // [n][ks]
  float* stage = smem + (SHARED_X ? n * ks : 0) + warp * ks * SDS;
  if (SHARED_X) {
    for (int i = tid; i < n * ks; i += blockDim.x) {
      const int r = i / ks;
      xs[i] = x[(size_t)r * d + k0 + (i - r * ks)];
    }
  }
  for (int i = lane; i < ks * SDS; i += WIN) stage[i] = 0.f;
  __syncthreads();

  // the relations without a chunk first, dealt round the slice's blocks
  const int groups = gridDim.x / (d / ks), warps = blockDim.x >> 5;
  for (int t = warp * groups + group; t < n_et; t += warps * groups)
    if (!owns_chunk(ct, n_chunks, t)) zero_rows(out, t, d, n, k0, ks);

  const bool ka = lane < ks;  // this lane's features: lane, lane + 32
  for (int c = next_chunk(counters + slice); c < n_chunks;
       c = next_chunk(counters + slice)) {
    const int t = ct[c];
    const size_t base = (size_t)c * C, cend = base + C;
    const bool first = c == 0 || ct[c - 1] != t;
    const int dprev = first ? -1 : dst[base - 1];
    if (dprev >= n) continue;  // the relation's pads began in an earlier chunk
    const bool last = c + 1 == n_chunks || ct[c + 1] != t;
    const int dl = dst[cend - 1];
    // this chunk owns destinations [dprev + 1, hi] of relation t
    const int hi = last || dl >= n ? n - 1 : dl;
    float* rows = out + ((size_t)t * d + k0) * n;
    int p0 = dprev + 1;  // the staging tile holds [p0, p0 + SD)
    int cur = dprev;     // the run being summed; its slots are skipped
    bool live = false;   // until the first run that starts in this chunk
    float s0 = 0.f, s1 = 0.f;
    // the slots still ahead in the buffer, from the chunk's start
    const size_t limit = (size_t)(n_chunks - c) * C;
    int sv_n, dv_n;  // the next window's slots
    load_slot(src, dst, ct, c, lane, limit, C, t, n, sv_n, dv_n);
    bool done = false;
    for (int off = 0; !done; off += WIN) {
      if (off >= C && !live) break;
      const int sv_l = sv_n, dv_l = dv_n;
      load_slot(src, dst, ct, c, off + WIN + lane, limit, C, t, n, sv_n, dv_n);
      float a0[WIN], a1[WIN];
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        const int sv = __shfl_sync(FULL, sv_l, j);
        if (SHARED_X) {
          const float* row = xs + sv * ks;
          a0[j] = ka ? row[lane] : 0.f;
          if (KPL == 2) a1[j] = row[lane + 32];
        } else {
          const float* row = x + (size_t)sv * d + k0;
          a0[j] = ka ? __ldg(row + lane) : 0.f;
          if (KPL == 2) a1[j] = __ldg(row + lane + 32);
        }
      }
      // the window's run starts, and where the walk stops: at a pad, or at
      // a run that starts past the chunk
      int prev = __shfl_up_sync(FULL, dv_l, 1);
      if (lane == 0) prev = cur;
      const unsigned starts = __ballot_sync(FULL, dv_l != prev);
      const unsigned stops =
          __ballot_sync(FULL, dv_l >= n || (off + lane >= C && dv_l != prev));
      const int jn = stops ? __ffs(stops) - 1 : WIN;
      const unsigned todo = jn == WIN ? FULL : (1u << jn) - 1u;
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (starts & todo & (1u << j)) {
          if (live) emit_run<KPL>(rows, n, ks, hi, cur, p0, s0, s1, stage);
          cur = __shfl_sync(FULL, dv_l, j);
          live = true;
          s0 = s1 = 0.f;
        }
        const bool go = (todo >> j) & 1u;  // slots past the stop add +0
        s0 = __fadd_rn(s0, go ? a0[j] : 0.f);
        if (KPL == 2) s1 = __fadd_rn(s1, go ? a1[j] : 0.f);
      }
      if (jn < WIN) {
        if (live) emit_run<KPL>(rows, n, ks, hi, cur, p0, s0, s1, stage);
        done = true;
      }
    }
    for (; p0 <= hi; p0 += SD) flush_stage(rows, n, ks, p0, hi, stage);
  }
}

// dx [n][d], zeroed, accumulates by vector atomics in device memory.
template <int KPL>
__global__ void __launch_bounds__(MAX_THREADS)
tns_bwd(const float* __restrict__ dpt, const int32_t* __restrict__ src,
        const int32_t* __restrict__ dst, const int32_t* __restrict__ ct,
        int n_chunks, int C, int n, int d, int ks, int* __restrict__ counters,
        float* __restrict__ dx) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = blockIdx.x % (d / ks);
  const int k0 = slice * ks;
  float* tile = smem + warp * ks * SDS;  // [ks][SDS]
  // this lane's features: 2 lane and 2 lane + 1 of a 64-feature slice (one
  // float2 atomic), else lane (idle past the slice)
  const int fa = KPL == 2 ? 2 * lane : lane;
  const bool ka = lane < ks;
  const int j16 = lane & (SD - 1);
  for (int c = next_chunk(counters + slice); c < n_chunks;
       c = next_chunk(counters + slice)) {
    const int t = ct[c];
    const float* dpr = dpt + ((size_t)t * d + k0) * n;
    int w0 = -SD - 1;  // the tile holds destinations [w0, w0 + SD)
    int cur = -1;
    float v0 = 0.f, v1 = 0.f;  // dP^T[t, k, cur] for this lane's features
    int sv_n, dv_n;  // the next window's slots
    load_slot(src, dst, ct, c, lane, C, C, t, n, sv_n, dv_n);
    for (int off = 0; off < C; off += WIN) {
      const int sv_l = sv_n, dv_l = dv_n;
      load_slot(src, dst, ct, c, off + WIN + lane, C, C, t, n, sv_n, dv_n);
      int rows[WIN];
#pragma unroll
      for (int j = 0; j < WIN; ++j) rows[j] = __shfl_sync(FULL, sv_l, j) * d;
      int prev = __shfl_up_sync(FULL, dv_l, 1);
      if (lane == 0) prev = cur;
      const unsigned starts = __ballot_sync(FULL, dv_l != prev);
      const unsigned stops = __ballot_sync(FULL, dv_l >= n);  // pads close it
      const int jn = stops ? __ffs(stops) - 1 : WIN;
      const unsigned todo = jn == WIN ? FULL : (1u << jn) - 1u;
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        if (starts & todo & (1u << j)) {
          cur = __shfl_sync(FULL, dv_l, j);
          if (cur >= w0 + SD) {
            __syncwarp();
            for (int k = lane / SD; k < ks; k += WIN / SD)
              tile[k * SDS + j16] =
                  cur + j16 < n ? dpr[(size_t)k * n + cur + j16] : 0.f;
            __syncwarp();
            w0 = cur;
          }
          if (ka) v0 = tile[fa * SDS + cur - w0];
          if (KPL == 2) v1 = tile[(fa + 1) * SDS + cur - w0];
        }
        float* row = dx + k0 + rows[j] + fa;
        const bool go = (todo >> j) & 1u;
        if (KPL == 2) {
          if (go) atomicAdd((float2*)row, make_float2(v0, v1));
        } else if (ka && go) {
          atomicAdd(row, v0);
        }
      }
      if (jn < WIN) break;
    }
  }
}

bool valid_plan(int ks, int d, int warps, int groups, int n_chunks) {
  return ks >= 1 && ks <= 64 && (ks & (ks - 1)) == 0 && d % ks == 0 &&
         warps >= 1 && warps <= MAX_THREADS / 32 && groups >= 1 &&
         n_chunks >= 1;
}

}  // namespace

// Plain C entry points (bound with ctypes by ops/typed_segment.py).  Each
// returns the first CUDA error.  warps: a block's warps; groups: blocks a
// feature slice (the grid is groups * d / |kslice| blocks); counters: one
// int a slice of scratch, zero-filled here, from which the warps take
// their chunks.

// out: [n_et, d, n] float32, every element written.  kslice > 0: x in
// shared memory in slices of kslice features; kslice < 0: the global mode,
// slices of -kslice features (a power of two up to 64 dividing d).
extern "C" int tip_tns_fwd(const float* x, const int32_t* src,
                           const int32_t* dst, const int32_t* ct, int n_chunks,
                           int C, int n, int d, int n_et, int kslice, int warps,
                           int groups, int* counters, float* out,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool shared = kslice > 0;
  const int ks = shared ? kslice : -kslice;
  if (!valid_plan(ks, d, warps, groups, n_chunks))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_floats(n, ks, warps, shared) * (int)sizeof(float);
  const int blocks = groups * (d / ks);
  cudaError_t err = cudaMemsetAsync(counters, 0, (d / ks) * sizeof(int), s);
  if (err != cudaSuccess) return err;
  auto run = [&](auto kernel) -> cudaError_t {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, warps * 32, smem, s>>>(x, src, dst, ct, n_chunks, C, n,
                                            d, n_et, ks, counters, out);
    return cudaGetLastError();
  };
  if (ks == 64) return shared ? run(tns_fwd<true, 2>) : run(tns_fwd<false, 2>);
  return shared ? run(tns_fwd<true, 1>) : run(tns_fwd<false, 1>);
}

// dx: [n, d] float32, zero-filled here.  kslice: the slice of a warp's
// dP^T tile (a power of two up to 64 dividing d).
extern "C" int tip_tns_bwd(const float* dpt, const int32_t* src,
                           const int32_t* dst, const int32_t* ct, int n_chunks,
                           int C, int n, int d, int kslice, int warps,
                           int groups, int* counters, float* dx,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!valid_plan(kslice, d, warps, groups, n_chunks))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_floats(0, kslice, warps, false) * (int)sizeof(float);
  cudaError_t err = cudaMemsetAsync(dx, 0, (size_t)n * d * sizeof(float), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counters, 0, (d / kslice) * sizeof(int), s);
  if (err != cudaSuccess) return err;
  auto run = [&](auto kernel) -> cudaError_t {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<groups * (d / kslice), warps * 32, smem, s>>>(
        dpt, src, dst, ct, n_chunks, C, n, d, kslice, counters, dx);
    return cudaGetLastError();
  };
  return kslice == 64 ? run(tns_bwd<2>) : run(tns_bwd<1>);
}
