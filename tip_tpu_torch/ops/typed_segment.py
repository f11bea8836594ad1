"""Chunked sparse ops over chunk-aligned buffers: the typed neighbour sum
of the R-GCN (kernel B4), the windowed P-P SpMM of the GCN (kernel B5),
and the v1 SDDMMs of the two decoders (kernels B6 and B7).

Port of tip_tpu/ops/pallas_segment.py (``typed_neighbor_sum_padded_t``,
``gcn_spmm_padded``, ``distmult_logits_padded``, ``nn_logits_padded``).
The TPU kernels turn each gather and scatter into one-hot matmuls because
the TPU has no fast scatter; the CUDA kernels (``csrc/typed_neighbor_sum.cu``,
``csrc/gcn_spmm.cu``, ``csrc/distmult_sddmm_v1.cu``, ``csrc/nn_sddmm_v1.cu``,
whose headers say what bounds them and how they are laid out) gather and
scatter directly.  B4's and B5's buffers are destination-sorted inside each
relation bin or window, so their forward passes sum each run of equal
destinations in slot order (B4 a warp a run, its lanes over the features;
B5 a warp a group of :data:`SPMM_GROUP` slots, its lanes over the
features, the pieces of a run that crosses groups added in group order)
and write it once: no atomics, deterministic results.  B4's backward
scatters its gradients with atomics; B6's and B7's backwards scatter with
B8's lane quads (float4 reductions of run sums into device memory; B6
launches B8's walk with its own rounding points).

B6 and B7 are the JAX package's first SDDMMs, which its decoder A/B
benchmark (scripts/decoder_ab.py; the port's is
tip_tpu_torch/scripts/decoder_ab.py) times against the second ones, B8 and
B9 (ops/sddmm2.py).  They compute the same logits (B6 launches B8's
forward, B7 B9's, so the logits are equal bit for bit); they round to
bf16 at other points (each scattered gradient contribution as the TPU
kernel casts it) and take no ``n_nodes`` argument.  B6's forward keeps
its z table in shared memory up to a node count past which it reads
device memory (B8's boundary, 3,417 nodes), B7's forward its score rows
(B9's boundary, 29,055 nodes); both backwards add into device memory at
any node count, and want a chunk length that is a multiple of 16.

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic; CPU tensors take it, CUDA tensors launch the kernel or raise.
``compute_dtype=bfloat16`` rounds the kernel inputs to bf16 (held as
float32) with float32 accumulation, as the JAX package's casts do.
"""

from __future__ import annotations

import torch

from tip_tpu_torch import kernels, trace
from tip_tpu_torch.ops.matmul import bf16_round, compute_round, is_bf16
from tip_tpu_torch.ops.sddmm2 import (
    D,
    PLAN_RELATIONS,
    SEG,
    TABLES,
    aligned,
    distmult_logits_plain,
    nn_fwd_args,
    nn_logits_plain,
    nn_shared_fits,
    pad_row,
    shared_table_fits,
)

TNS = "typed_neighbor_sum"
SPMM = "gcn_spmm"
DM1 = "distmult_sddmm_v1"
NN1 = "nn_sddmm_v1"
SPMM_GROUP = 32  # B5's warp takes this many slots (gcn_spmm.cu)
SPMM_MAX_SLOTS = 2**31 - 2**12  # B5 indexes slots with int32


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


# Plans of csrc/typed_neighbor_sum.cu: each of a block's 8-16 warps has a
# [slice, 17] staging tile in shared memory; the forward's block also holds
# a feature slice of x, [n, slice] floats, where one fits
_SDS = 17
_MIN_WARPS, _MAX_WARPS = 8, 16


def _tns_warps(n: int, ks: int) -> int:
    """Warps of a block whose x slice [n, ks] (n = 0: none) and staging
    tiles fit its shared memory (at most 16)."""
    return min(_MAX_WARPS, (kernels.SMEM_BYTES // 4 - n * ks) // (ks * _SDS))


def _pow2_slice(d: int) -> int:
    """The largest power of two up to 64 that divides d."""
    return next(ks for ks in (64, 32, 16, 8, 4, 2, 1) if d % ks == 0)


def tns_fwd_kslice(n: int, d: int) -> int:
    """Widest feature slice of B4's forward (a power of two up to 64
    dividing d, of at least 8 features or all d) whose x slice [n, slice]
    fits a block's shared memory beside the staging tiles of 8 warps; 0
    where none fits (n > 7,128), and the forward reads x from device
    memory."""
    for ks in (64, 32, 16, 8, 4, 2, 1):
        if (d % ks == 0 and ks >= min(8, d)
                and _tns_warps(n, ks) >= _MIN_WARPS):
            return ks
    return 0


def _tns_plan(n: int, ks: int, d: int, n_chunks: int, dev):
    """(warps, groups) of a B4 launch with slice ks and an x slice of n
    rows a block (n = 0: none): as many blocks a slice as fit the SMs at
    once, each warp taking whole chunks from a counter."""
    warps = _tns_warps(n, ks)
    smem = 4 * (n * ks + warps * ks * _SDS)
    per_sm = max(1, min(2048 // (32 * warps), kernels.SMEM_BYTES // smem))
    groups = max(1, min(-(-n_chunks // warps),
                        per_sm * kernels.sm_count(dev) // (d // ks)))
    return warps, groups


def typed_neighbor_sum_fwd_cuda(x, src2d, dst2d, chunk_type, n_et: int,
                                force_global: bool = False):
    """Launch the forward of csrc/typed_neighbor_sum.cu: x's feature slice
    in shared memory where one fits (:func:`tns_fwd_kslice`), else, or with
    ``force_global``, x read from device memory."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError("typed_neighbor_sum_fwd_cuda needs CUDA tensors")
    kernels.require(x, "x", torch.float32, 2, dev)
    _check_chunked(src2d, dst2d, chunk_type, dev)
    n, d = x.shape
    n_chunks, chunk = src2d.shape
    if n_chunks == 0:
        return torch.zeros((n_et, d, n), dtype=torch.float32, device=dev)
    ks = 0 if force_global else tns_fwd_kslice(n, d)
    if ks:
        warps, groups = _tns_plan(n, ks, d, n_chunks, dev)
        kslice = ks
    else:
        ks = _pow2_slice(d)
        warps, groups = _tns_plan(0, ks, d, n_chunks, dev)
        kslice = -ks
    out = torch.empty((n_et, d, n), dtype=torch.float32, device=dev)
    counters = torch.empty(d // ks, dtype=torch.int32, device=dev)
    kernels.launch(TNS, "tip_tns_fwd", "ppppiiiiiiiipp", x, src2d, dst2d,
                   chunk_type, n_chunks, chunk, n, d, n_et, kslice, warps,
                   groups, counters, out, device=dev)
    return out


def typed_neighbor_sum_bwd_cuda(dpt, src2d, dst2d, chunk_type):
    """Launch the backward of csrc/typed_neighbor_sum.cu (atomic adds into
    dx in device memory)."""
    dev = dpt.device
    if not dpt.is_cuda:
        raise ValueError("typed_neighbor_sum_bwd_cuda needs CUDA tensors")
    kernels.require(dpt, "dpt", torch.float32, 3, dev)
    _check_chunked(src2d, dst2d, chunk_type, dev)
    _, d, n = dpt.shape
    n_chunks, chunk = src2d.shape
    if n_chunks == 0:
        return torch.zeros((n, d), dtype=torch.float32, device=dev)
    dx = torch.empty((n, d), dtype=torch.float32, device=dev)
    ks = _pow2_slice(d)
    warps, groups = _tns_plan(0, ks, d, n_chunks, dev)
    counters = torch.empty(d // ks, dtype=torch.int32, device=dev)
    kernels.launch(TNS, "tip_tns_bwd", "ppppiiiiiiipp", dpt, src2d, dst2d,
                   chunk_type, n_chunks, chunk, n, d, ks, warps, groups,
                   counters, dx, device=dev)
    return dx


def typed_csr(src2d, dst2d, chunk_type, n: int, n_et: int,
              transpose: bool = False):
    """The typed adjacency of the chunk buffers as one CSR matrix: A [n_et
    * n, n] with a 1 at (t * n + dst, src) for each edge, or with
    ``transpose`` A^T [n, n_et * n].  ``torch.sparse.mm(A, x)`` is the
    forward's P^T as [n_et * n, d] (P^T transposed), and
    ``torch.sparse.mm(A^T, dP)`` with dP^T transposed to [n_et * n, d] is
    the backward: the one-library-call yardstick that chip_smoke.py times
    beside kernel B4 (the port never calls it)."""
    valid = dst2d < n
    rows = (chunk_type.long()[:, None] * n + dst2d.long())[valid]
    cols = src2d.long()[valid]
    shape = (n_et * n, n)
    if transpose:
        order = torch.argsort(cols, stable=True)
        rows, cols, shape = cols[order], rows[order], (n, n_et * n)
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=shape[0]), 0)
    return torch.sparse_csr_tensor(
        crow, cols, torch.ones(cols.shape, dtype=torch.float32,
                               device=cols.device), shape)


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
    @trace.spanned("typed_neighbor_sum")
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
    if n_chunks * chunk > SPMM_MAX_SLOTS:
        raise ValueError(f"{n_chunks * chunk} slots: the kernel indexes at "
                         f"most {SPMM_MAX_SLOTS}")
    d = x.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    # the pieces of the runs that cross groups: scratch freed on return
    # while the kernel may still run (reused only by later work on this
    # stream)
    part = torch.empty(2 * -(-n_chunks * chunk // SPMM_GROUP) * (d + 1), **f32)
    out = torch.empty((n_nodes, d), **f32)
    kernels.launch(SPMM, "tip_gcn_spmm", "pppppiiiiiipp", x, src2d, dstl2d,
                   w2d, chunk_window, n_chunks, chunk, window, n_nodes, d,
                   int(is_bf16(compute_dtype)), part, out, device=dev)
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
    @trace.spanned("gcn_spmm")
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


# ---------------------------------------------------------------------------
# B6: v1 DistMult SDDMM, logit[c, j] = sum_k z[src, k] z[dst, k] w[ct[c], k]
# ---------------------------------------------------------------------------


# logits [n_chunks, chunk] float32, pad slots reading a zero dst row
# (exactly 0): B6's forward is B8's, product for product
distmult_v1_fwd_plain = distmult_logits_plain


def distmult_v1_bwd_plain(z, w, src2d, dst2d, chunk_type, g,
                          bf16: bool = False):
    """(dz [n, d], dw [n_et, d]) for the incoming gradient g [n_chunks,
    chunk]: dz[src] += (z[dst] w) g and dz[dst] += (z[src] w) g, each
    contribution rounded to bf16 with ``bf16``; dw sums (z[src] z[dst]) g
    per chunk, then per relation in chunk order (0 where a relation owns no
    chunk)."""
    n, d = z.shape
    zp = pad_row(z.float())
    zs, zd = zp[src2d.long()], zp[dst2d.long()]
    wt = w.float()[chunk_type.long()][:, None, :]
    g3 = g.float()[..., None]
    a, b = (zd * wt) * g3, (zs * wt) * g3
    if bf16:
        a, b = bf16_round(a), bf16_round(b)
    dz = torch.zeros((n + 1, d), dtype=torch.float32, device=z.device)
    dz.index_add_(0, src2d.long().reshape(-1), a.reshape(-1, d))
    dz.index_add_(0, dst2d.long().reshape(-1), b.reshape(-1, d))
    dw = torch.zeros(w.shape, dtype=torch.float32, device=z.device)
    dw.index_add_(0, chunk_type.long(), ((zs * zd) * g3).sum(1))
    return dz[:n], dw


def v1_shared_fits(n: int, tables: int, grads: bool) -> bool:
    """Whether the kernel with ``tables`` node tables keeps them in one
    block's shared memory.  B6 (one): its forward is B8's, whose [n + 1,
    17] float table fits up to 3,417 nodes.  B7 (two): its forward is
    B9's, whose two score rows of n + 1 floats fit up to 29,055 nodes.
    Neither backward keeps a table in shared memory (both add into device
    memory at any n)."""
    if grads:
        return False
    if tables == 2:
        return nn_shared_fits(n)
    return shared_table_fits(n)


def _check_v1_args(nodes: dict, rels: dict, bufs, grads: bool, table=None,
                   g=None):
    """(n, shared) for B6 (``nodes`` {"z"}) or B7 ({"h1", "h2"}): float32
    [n, 16] node tables, [n_et, 16] relation rows ``rels``, ``bufs``
    (src2d, dst2d, chunk_type) and the backward's ``g``.  ``table`` None
    picks "shared" where the tables fit (:func:`v1_shared_fits`), else
    "global"; "shared" raises where they do not fit, and for a backward.
    Both want a chunk length that is a multiple of 16 (the backwards' lane
    quads walk 16 slots; B7's forward reads 16 bytes a lane), and B7's
    forward at most sddmm2.PLAN_RELATIONS relations (B9's plan)."""
    dev = bufs[0].device
    for name, x in {**nodes, **rels}.items():
        kernels.require(x, name, torch.float32, 2, dev)
    _check_chunked(*bufs, dev)
    n = next(iter(nodes.values())).shape[0]
    n_et = next(iter(rels.values())).shape[0]
    if (any(x.shape != (n, D) for x in nodes.values())
            or any(x.shape != (n_et, D) for x in rels.values())):
        raise ValueError(f"the kernel is built for width {D}; shapes: " + ", ".join(
            f"{k} {tuple(x.shape)}" for k, x in {**nodes, **rels}.items()))
    if g is not None:
        kernels.require(g, "g", torch.float32, 2, dev)
        if g.shape != bufs[0].shape:
            raise ValueError(f"g {tuple(g.shape)} != src2d "
                             f"{tuple(bufs[0].shape)}")
    if table not in (None, *TABLES):
        raise ValueError(f"table {table!r} not in {TABLES}")
    if bufs[0].shape[1] % SEG:
        raise ValueError(f"chunk length {bufs[0].shape[1]} is not a "
                         f"multiple of {SEG} (the backward's lane quads walk "
                         f"{SEG} slots)")
    if len(nodes) == 2 and not grads and n_et > PLAN_RELATIONS:
        raise ValueError(f"{n_et} relations: the forward's plan takes at "
                         f"most {PLAN_RELATIONS}")
    if grads and table == "shared":
        raise ValueError("the backward keeps no table in shared memory")
    fits = v1_shared_fits(n, len(nodes), grads)
    if table == "shared" and not fits:
        raise ValueError(f"n = {n} does not fit the shared-memory tables")
    return n, fits if table is None else table == "shared"


def distmult_v1_fwd_cuda(z, w, src2d, dst2d, chunk_type, table=None):
    """Launch the forward of csrc/distmult_sddmm_v1.cu (``table``: see
    :func:`_check_v1_args`)."""
    if not z.is_cuda:
        raise ValueError("distmult_v1_fwd_cuda needs CUDA tensors")
    bufs = (src2d, dst2d, chunk_type)
    n, shared = _check_v1_args({"z": z}, {"w": w}, bufs, False, table)
    n_chunks, chunk = src2d.shape
    out = torch.empty((n_chunks, chunk), dtype=torch.float32, device=z.device)
    if w.data_ptr() % 16:  # the forward reads w's rows 16 bytes a lane
        w = w.clone()
    # B8's grid (sddmm2.distmult_logits_cuda)
    kernels.launch(DM1, "tip_dm1_fwd", "pppppiiiiip", pad_row(z), w, *bufs,
                   n_chunks, chunk, n, int(shared),
                   (2 if shared else 4) * kernels.sm_count(z.device), out,
                   device=z.device)
    return out


def distmult_v1_bwd_cuda(z, w, src2d, dst2d, chunk_type, g,
                         bf16: bool = False, table=None):
    """Launch the backward of csrc/distmult_sddmm_v1.cu (B8's lane-quad
    walk with B6's rounding points): (dz, dw).  It adds into device memory
    at any n (``table`` None or "global")."""
    if not z.is_cuda:
        raise ValueError("distmult_v1_bwd_cuda needs CUDA tensors")
    n, _ = _check_v1_args({"z": z}, {"w": w}, (src2d, dst2d, chunk_type),
                          True, table, g)
    n_chunks, chunk = src2d.shape
    n_et = w.shape[0]
    w, src2d, dst2d, g = aligned(w, src2d, dst2d, g)
    # scratch freed on return while the kernel may still run: the caching
    # allocator reuses it only for later work on this same stream
    f32 = dict(dtype=torch.float32, device=z.device)
    dwc = torch.empty((n_chunks, D), **f32)
    dz = torch.empty((n + 1, D), **f32)
    dw = torch.empty((n_et, D), **f32)
    kernels.launch(DM1, "tip_dm1_bwd", "ppppppiiiiiippp", pad_row(z), w,
                   src2d, dst2d, chunk_type, g, n_chunks, chunk, n, n_et,
                   int(bf16), kernels.sm_count(z.device), dwc, dz, dw,
                   device=z.device)
    return dz[:n], dw


class _DistmultV1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w, src2d, dst2d, chunk_type, compute_dtype):
        zr = compute_round(z, compute_dtype).contiguous()
        wf = w.float().contiguous()
        ctx.save_for_backward(zr, wf, src2d, dst2d, chunk_type)
        ctx.bf16 = is_bf16(compute_dtype)
        if zr.is_cuda:
            return distmult_v1_fwd_cuda(zr, wf, src2d, dst2d, chunk_type)
        if zr.device.type != "cpu":
            raise ValueError(f"no v1 DistMult SDDMM for device {zr.device}")
        return distmult_v1_fwd_plain(zr, wf, src2d, dst2d, chunk_type)

    @staticmethod
    @trace.spanned("distmult_v1")
    def backward(ctx, g):
        args = ctx.saved_tensors
        bwd = distmult_v1_bwd_cuda if args[0].is_cuda else distmult_v1_bwd_plain
        dz, dw = bwd(*args, g.float().contiguous(), ctx.bf16)
        return dz, dw, None, None, None, None


def distmult_logits_padded(z, w, src2d, dst2d, chunk_type,
                           compute_dtype=torch.float32):
    """v1 DistMult logits [n_chunks, chunk] for padded typed edges (kernel
    B6); pad slots (dst = n) give exactly 0.

    z [n, d]; w [n_et, d] per-relation diagonal; src2d/dst2d [n_chunks,
    chunk] int32; chunk_type [n_chunks] int32, non-decreasing.  With
    ``compute_dtype=bfloat16`` z, and each scattered dz contribution of the
    backward, are rounded to bf16; w and the sums stay float32.
    Differentiable in z and w."""
    return _DistmultV1.apply(z, w, src2d, dst2d, chunk_type, compute_dtype)


# ---------------------------------------------------------------------------
# B7: v1 NN-decoder SDDMM, logit = h1[src] . w1[t] + h2[dst] . w2[t]
# ---------------------------------------------------------------------------


# logits [n_chunks, chunk] float32, h1[src] . w1[t] + h2[dst] . w2[t] per
# slot (a pad slot's dst term is 0, its src term real): B7's forward is
# B9's function
nn_v1_fwd_plain = nn_logits_plain


def nn_v1_bwd_plain(h1, h2, w1, w2, src2d, dst2d, chunk_type, g,
                    bf16: bool = False):
    """(dh1, dh2 [n, l1], dw1, dw2 [n_et, l1]) for the incoming gradient g
    [n_chunks, chunk]: dh1[src] += w1[t] g (pad slots too), dh2[dst] +=
    w2[t] g, each rounded to bf16 with ``bf16``; dw1, dw2 sum h1[src] g and
    h2[dst] g per chunk, then per relation in chunk order."""
    n, d = h1.shape
    ct = chunk_type.long()
    hs = pad_row(h1.float())[src2d.long()]
    hd = pad_row(h2.float())[dst2d.long()]
    g3 = g.float()[..., None]
    out = []
    for ids, wt in ((src2d, w1.float()[ct][:, None, :]),
                    (dst2d, w2.float()[ct][:, None, :])):
        contrib = wt * g3
        if bf16:
            contrib = bf16_round(contrib)
        dh = torch.zeros((n + 1, d), dtype=torch.float32, device=g.device)
        dh.index_add_(0, ids.long().reshape(-1), contrib.reshape(-1, d))
        out.append(dh[:n])
    for hx, w in ((hs, w1), (hd, w2)):
        dw = torch.zeros(w.shape, dtype=torch.float32, device=g.device)
        out.append(dw.index_add_(0, ct, (hx * g3).sum(1)))
    return tuple(out)


def nn_v1_fwd_cuda(h1, h2, w1, w2, src2d, dst2d, chunk_type, table=None):
    """Launch the forward of csrc/nn_sddmm_v1.cu, B9's forward under B7's
    entry point (``table``: see :func:`_check_v1_args`)."""
    if not h1.is_cuda:
        raise ValueError("nn_v1_fwd_cuda needs CUDA tensors")
    bufs = (src2d, dst2d, chunk_type)
    n, shared = _check_v1_args({"h1": h1, "h2": h2}, {"w1": w1, "w2": w2},
                               bufs, False, table)
    out, args = nn_fwd_args(h1, h2, w1, w2, *bufs, shared)
    kernels.launch(NN1, "tip_nn1_fwd", "pppppppiiiiiiipppp", *args,
                   device=h1.device)
    return out


def nn_v1_bwd_cuda(h1, h2, w1, w2, src2d, dst2d, chunk_type, g,
                   bf16: bool = False, table=None):
    """Launch the backward of csrc/nn_sddmm_v1.cu: (dh1, dh2, dw1, dw2).
    It adds into device memory at any n (``table`` None or "global")."""
    if not h1.is_cuda:
        raise ValueError("nn_v1_bwd_cuda needs CUDA tensors")
    bufs = (src2d, dst2d, chunk_type)
    n, _ = _check_v1_args({"h1": h1, "h2": h2}, {"w1": w1, "w2": w2}, bufs,
                          True, table, g)
    n_chunks, chunk = src2d.shape
    n_et = w1.shape[0]
    w1, w2, src2d, dst2d, g = aligned(w1, w2, src2d, dst2d, g)
    # scratch freed on return while the kernel may still run: the caching
    # allocator reuses it only for later work on this same stream
    f32 = dict(dtype=torch.float32, device=h1.device)
    dwc = torch.empty((n_chunks, 2, D), **f32)
    dh = torch.empty((2, n + 1, D), **f32)
    dw = torch.empty((n_et, 2, D), **f32)
    kernels.launch(NN1, "tip_nn1_bwd", "ppppppppiiiiiippp", pad_row(h1),
                   pad_row(h2), w1, w2, src2d, dst2d, chunk_type, g, n_chunks,
                   chunk, n, n_et, int(bf16), kernels.sm_count(h1.device),
                   dwc, dh, dw, device=h1.device)
    return dh[0, :n], dh[1, :n], dw[:, 0], dw[:, 1]


class _NNV1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h1, h2, w1, w2, src2d, dst2d, chunk_type, compute_dtype):
        h1r = compute_round(h1, compute_dtype).contiguous()
        h2r = compute_round(h2, compute_dtype).contiguous()
        w1f, w2f = w1.float().contiguous(), w2.float().contiguous()
        args = (h1r, h2r, w1f, w2f, src2d, dst2d, chunk_type)
        ctx.save_for_backward(*args)
        ctx.bf16 = is_bf16(compute_dtype)
        if h1r.is_cuda:
            return nn_v1_fwd_cuda(*args)
        if h1r.device.type != "cpu":
            raise ValueError(f"no v1 NN-decoder SDDMM for device {h1r.device}")
        return nn_v1_fwd_plain(*args)

    @staticmethod
    @trace.spanned("nn_v1")
    def backward(ctx, g):
        args = ctx.saved_tensors
        bwd = nn_v1_bwd_cuda if args[0].is_cuda else nn_v1_bwd_plain
        grads = bwd(*args, g.float().contiguous(), ctx.bf16)
        return (*grads, None, None, None, None)


def nn_logits_padded(h1, h2, w1, w2, src2d, dst2d, chunk_type,
                     compute_dtype=torch.float32):
    """v1 NN-decoder logits [n_chunks, chunk] from the per-node L1 tables
    (kernel B7).

    h1, h2 [n, l1] (relu'd L1 projections); w1, w2 [n_et, l1] per-relation
    L2 rows; buffers as :func:`distmult_logits_padded`.  Pad slots (dst =
    n) score their pad src, which the caller masks (the JAX package's
    contract).  With ``compute_dtype=bfloat16`` h1, h2, and each scattered
    dh contribution of the backward, are rounded to bf16.  Differentiable
    in h1, h2, w1 and w2."""
    return _NNV1.apply(h1, h2, w1, w2, src2d, dst2d, chunk_type,
                       compute_dtype)
