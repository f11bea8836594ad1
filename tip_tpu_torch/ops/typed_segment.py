"""Chunked sparse aggregations of the beyond-dense layout: the typed
neighbour sum of the R-GCN (kernel B4) and the windowed P-P SpMM of the
GCN (kernel B5).

Port of tip_tpu/ops/pallas_segment.py (``typed_neighbor_sum_padded_t`` and
``gcn_spmm_padded``).  The TPU kernels turn each gather and scatter into
one-hot matmuls because the TPU has no fast scatter; the CUDA kernels
(``csrc/typed_neighbor_sum.cu``, ``csrc/gcn_spmm.cu``, whose headers say
what bounds them and how they are laid out) gather and scatter directly.
Both buffers are destination-sorted inside each relation bin or window, so
the forward passes sum each run of equal destinations in one thread, in
slot order, and write it once: no atomics, deterministic results.

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic; CPU tensors take it, CUDA tensors launch the kernel or raise.
``compute_dtype=bfloat16`` rounds the kernel inputs to bf16 (held as
float32) with float32 accumulation, as the JAX package's casts do.
"""

from __future__ import annotations

import torch

from tip_tpu_torch import kernels
from tip_tpu_torch.ops.matmul import compute_round, is_bf16

TNS = "typed_neighbor_sum"
SPMM = "gcn_spmm"


# ---------------------------------------------------------------------------
# B4: P^T[t, :, d] = sum_{e in t, dst_e = d} x[src_e]
# ---------------------------------------------------------------------------


def typed_neighbor_sum_fwd_plain(x, src2d, dst2d, chunk_type, n_et: int):
    """P^T [n_et, d, n] float32; pad slots (dst = n) land in a dropped
    extra column."""
    n, d = x.shape
    seg = (chunk_type.long()[:, None] * (n + 1) + dst2d.long()).reshape(-1)
    out = torch.zeros((n_et * (n + 1), d), dtype=torch.float32, device=x.device)
    out.index_add_(0, seg, x.float()[src2d.long().reshape(-1)])
    return out.reshape(n_et, n + 1, d)[:, :n].transpose(1, 2).contiguous()


def typed_neighbor_sum_bwd_plain(dpt, src2d, dst2d, chunk_type):
    """dx [n, d] = sum_t sum_{e in t, src_e = s} dP^T[t, :, dst_e]."""
    n_et, d, n = dpt.shape
    dp = torch.nn.functional.pad(dpt.float().transpose(1, 2), (0, 0, 0, 1))
    g = dp[chunk_type.long()[:, None], dst2d.long()]  # [n_chunks, C, d]
    dx = torch.zeros((n, d), dtype=torch.float32, device=dpt.device)
    return dx.index_add_(0, src2d.long().reshape(-1), g.reshape(-1, d))


def _check_chunked(src2d, dst2d, chunk_type, dev):
    kernels.require(src2d, "src2d", torch.int32, 2, dev)
    kernels.require(dst2d, "dst2d", torch.int32, 2, dev)
    kernels.require(chunk_type, "chunk_type", torch.int32, 1, dev)
    if dst2d.shape != src2d.shape or chunk_type.shape[0] != src2d.shape[0]:
        raise ValueError(f"buffers do not match: src2d {tuple(src2d.shape)}, "
                         f"dst2d {tuple(dst2d.shape)}, chunk_type "
                         f"{tuple(chunk_type.shape)}")


def typed_neighbor_sum_fwd_cuda(x, src2d, dst2d, chunk_type, n_et: int):
    """Launch the forward of csrc/typed_neighbor_sum.cu."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError("typed_neighbor_sum_fwd_cuda needs CUDA tensors")
    kernels.require(x, "x", torch.float32, 2, dev)
    _check_chunked(src2d, dst2d, chunk_type, dev)
    n, d = x.shape
    n_chunks, chunk = src2d.shape
    out = torch.empty((n_et, d, n), dtype=torch.float32, device=dev)
    kernels.launch(TNS, "tip_tns_fwd", "ppppiiiiip", x, src2d, dst2d,
                   chunk_type, n_chunks, chunk, n, d, n_et, out, device=dev)
    return out


def tns_bwd_kslice(n: int, d: int) -> int:
    """Widest feature slice (a divisor of d, of at least 8 features or all
    d) whose [n, slice + 1] float accumulator fits a block's shared memory;
    0 where none fits (n > 6,456), and the backward adds into a global dx."""
    for ks in (64, 32, 16, 8, 4, 2, 1):
        if (d % ks == 0 and ks >= min(8, d)
                and n * (ks + 1) * 4 <= kernels.SMEM_BYTES):
            return ks
    return 0


def typed_neighbor_sum_bwd_cuda(dpt, src2d, dst2d, chunk_type, table=None):
    """Launch the backward of csrc/typed_neighbor_sum.cu.  ``table`` None
    accumulates in shared memory where a slice fits, else in global memory;
    "shared" raises where none fits; "global" forces global."""
    dev = dpt.device
    if not dpt.is_cuda:
        raise ValueError("typed_neighbor_sum_bwd_cuda needs CUDA tensors")
    kernels.require(dpt, "dpt", torch.float32, 3, dev)
    _check_chunked(src2d, dst2d, chunk_type, dev)
    if table not in (None, "shared", "global"):
        raise ValueError(f"table {table!r} is not 'shared' or 'global'")
    _, d, n = dpt.shape
    n_chunks, chunk = src2d.shape
    kslice = 0 if table == "global" else tns_bwd_kslice(n, d)
    if table == "shared" and kslice == 0:
        raise ValueError(f"n = {n} nodes do not fit the backward's "
                         "shared-memory accumulator")
    sms = kernels.sm_count(dev)
    if kslice:  # one block per SM (the accumulator fills its shared memory)
        groups = max(1, min(n_chunks, sms // (d // kslice)))
    else:  # two 1,024-thread blocks per SM
        groups = max(1, min(n_chunks, 2 * sms))
    # scratch freed on return while the kernel may still run: the caching
    # allocator reuses it only for later work on this same stream
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty((groups if kslice else 0, n, d), **f32)
    dx = torch.empty((n, d), **f32)
    kernels.launch(TNS, "tip_tns_bwd", "ppppiiiiiipp", dpt, src2d, dst2d,
                   chunk_type, n_chunks, chunk, n, d, kslice, groups, part, dx,
                   device=dev)
    return dx


def _tns_fwd(x, src2d, dst2d, chunk_type, n_et):
    if x.is_cuda:
        return typed_neighbor_sum_fwd_cuda(x, src2d, dst2d, chunk_type, n_et)
    if x.device.type != "cpu":
        raise ValueError(f"no typed_neighbor_sum for device {x.device}")
    return typed_neighbor_sum_fwd_plain(x, src2d, dst2d, chunk_type, n_et)


def _tns_bwd(dpt, src2d, dst2d, chunk_type):
    if dpt.is_cuda:
        return typed_neighbor_sum_bwd_cuda(dpt, src2d, dst2d, chunk_type)
    if dpt.device.type != "cpu":
        raise ValueError(f"no typed_neighbor_sum for device {dpt.device}")
    return typed_neighbor_sum_bwd_plain(dpt, src2d, dst2d, chunk_type)


class _TypedNeighborSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src2d, dst2d, chunk_type, n_et, compute_dtype):
        ctx.save_for_backward(src2d, dst2d, chunk_type)
        ctx.compute_dtype = compute_dtype
        return _tns_fwd(compute_round(x, compute_dtype).contiguous(), src2d, dst2d,
                        chunk_type, n_et)

    @staticmethod
    def backward(ctx, dpt):
        src2d, dst2d, chunk_type = ctx.saved_tensors
        dx = _tns_bwd(compute_round(dpt, ctx.compute_dtype).contiguous(), src2d,
                      dst2d, chunk_type)
        return dx, None, None, None, None, None


def typed_neighbor_sum_padded_t(x, src2d, dst2d, chunk_type, n_et: int,
                                compute_dtype=torch.float32):
    """Per-relation neighbour sums over chunk-aligned typed edges, in the
    JAX package's TRANSPOSED layout.

    x [n, d] float; src2d/dst2d [n_chunks, chunk] int32 (pad slots have
    dst = n, src = 0); chunk_type [n_chunks] int32, non-decreasing.
    Returns P^T [n_et, d, n] float32.  Differentiable in x: the backward
    scatters dP^T at each edge's dst back to its src.  With
    ``compute_dtype=bfloat16`` x (and dP^T in the backward) are rounded to
    bf16 first; sums stay float32."""
    return _TypedNeighborSum.apply(x, src2d, dst2d, chunk_type, int(n_et),
                                   compute_dtype)


# ---------------------------------------------------------------------------
# B5: out = A_hat @ x over the windowed P-P buffers
# ---------------------------------------------------------------------------


def gcn_spmm_plain(x, src2d, dstl2d, w2d, chunk_window, n_windows: int,
                   window: int, n_nodes: int, compute_dtype=torch.float32):
    """out [n_nodes, d] = sum over each row's edges of x[src] * w, the
    products rounded to float32 (and to bf16 with that compute dtype)
    before the sum; pad slots (dst_local = window, w = 0) are dropped."""
    d = x.shape[1]
    msgs = compute_round(x.float()[src2d.long()] * w2d[..., None], compute_dtype)
    row = chunk_window.long()[:, None] * window + dstl2d.long()
    row = torch.where(dstl2d < window, row, torch.full_like(row, n_windows * window))
    out = torch.zeros((n_windows * window + 1, d), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, row.reshape(-1), msgs.reshape(-1, d))
    return out[:n_nodes]


def gcn_spmm_cuda(x, src2d, dstl2d, w2d, chunk_window, n_windows: int,
                  window: int, n_nodes: int, compute_dtype=torch.float32):
    """Launch csrc/gcn_spmm.cu.  Same contract as :func:`gcn_spmm_plain`."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError("gcn_spmm_cuda needs CUDA tensors")
    kernels.require(x, "x", torch.float32, 2, dev)
    kernels.require(src2d, "src2d", torch.int32, 2, dev)
    kernels.require(dstl2d, "dstl2d", torch.int32, 2, dev)
    kernels.require(w2d, "w2d", torch.float32, 2, dev)
    kernels.require(chunk_window, "chunk_window", torch.int32, 1, dev)
    n_chunks, chunk = src2d.shape
    if (dstl2d.shape != src2d.shape or w2d.shape != src2d.shape
            or chunk_window.shape[0] != n_chunks or x.shape[0] != n_nodes
            or n_windows * window < n_nodes):
        raise ValueError("windowed buffers do not match x")
    d = x.shape[1]
    out = torch.empty((n_nodes, d), dtype=torch.float32, device=dev)
    kernels.launch(SPMM, "tip_gcn_spmm", "pppppiiiiiip", x, src2d, dstl2d, w2d,
                   chunk_window, n_chunks, chunk, window, n_nodes, d,
                   int(is_bf16(compute_dtype)), out, device=dev)
    return out


def _spmm(x, *args):
    if x.is_cuda:
        return gcn_spmm_cuda(x.contiguous(), *args)
    if x.device.type != "cpu":
        raise ValueError(f"no gcn_spmm for device {x.device}")
    return gcn_spmm_plain(x, *args)


class _GcnSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src2d, dstl2d, w2d, chunk_window, n_windows, window,
                n_nodes, compute_dtype):
        ctx.save_for_backward(src2d, dstl2d, w2d, chunk_window)
        ctx.static = (n_windows, window, n_nodes, compute_dtype)
        return _spmm(x.float(), src2d, dstl2d, w2d, chunk_window, n_windows,
                     window, n_nodes, compute_dtype)

    @staticmethod
    def backward(ctx, dout):
        # A_hat is symmetric: dx = A_hat^T dout = A_hat dout
        dx = _spmm(dout.float(), *ctx.saved_tensors, *ctx.static)
        return (dx,) + (None,) * 8


def gcn_spmm_padded(x, src2d, dstl2d, w2d, chunk_window, n_windows: int,
                    window: int, n_nodes: int, compute_dtype=torch.float32):
    """out = A_hat @ x over a windowed, chunk-aligned edge buffer
    (data/packing.py:pad_windowed_edges).

    REQUIRES a symmetric A_hat, as GCN's D^-1/2 (A+I) D^-1/2 of an
    undirected graph is: the backward computes dx = A_hat^T @ dout as
    A_hat @ dout, by running the same kernel on dout."""
    return _GcnSpmm.apply(x, src2d, dstl2d, w2d, chunk_window, int(n_windows),
                          int(window), int(n_nodes), compute_dtype)
