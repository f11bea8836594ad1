"""Chunked SDDMMs over chunk-aligned typed edges: one logit per edge slot,
with the gradients for the embeddings and relation weights.  Two kernels:

**B8, DistMult** (``distmult_logits_padded2`` of
tip_tpu/ops/pallas_sddmm2.py):

    logit[c, j] = sum_k (z[src, k] * z[dst, k]) * w[chunk_type[c], k]

Pad slots carry dst = n, which reads a zero row: their logits are exactly
0.0.  The backward scatters ``(g * z[dst]) * w`` to src and
``(g * z[src]) * w`` to dst, and sums ``(z[src] * z[dst]) * g`` per chunk,
then per relation over its chunks in chunk order, as the TPU kernel's
wrapper does.  The TPU kernel saves the gathered endpoints as residuals
(two [n_chunks, d, chunk] arrays per call); the port saves only z, w and
the indices and gathers again in the backward.  The forward keeps z in
shared memory where the table fits (:func:`shared_table_fits`), else
reads it through L1, so any node count runs; the backward reads z
through L1 and adds dz into a device-memory table, four lanes a slot
adding its 16 contributions as float4 reductions.  With
``compute_dtype=bfloat16`` z is rounded to bf16 and so is each scattered
gradient contribution, with float32 accumulation (the TPU kernel's
casts).

**B9, the NN decoder** (``nn_logits_padded2``):

    logit[c, j] = h1[src] . w1[t] + h2[dst] . w2[t],   t = chunk_type[c]

Pad slots (dst = n) get a dst term of exactly 0; their src term is whatever
the pad src reads, and the caller masks it (the JAX package's contract).
The backward adds ``g * w1[t]`` to dh1[src], ``g * w2[t]`` to dh2[dst] and
``g * h[endpoint]`` to dw1[t], dw2[t].  Relation rows are constant over a
relation's chunks, so the kernel factors both directions through
per-(relation, node) scalars: the scores ``h . w[t]`` forward, the sums of
g per (relation, endpoint) backward (the plain versions do the same).  The
kernel cuts the chunks into items, runs of at most :data:`ITEM_CHUNKS`
chunks of one relation (:func:`nn_items`), and keeps an item's 2 (n + 1)
scores or sums in shared memory up to 29,055 nodes (:func:`nn_shared_fits`),
else in device memory; the backward sums in a fixed order and is
deterministic.  With ``compute_dtype=bfloat16`` h1 and h2 are rounded to
bf16 and so is each scattered dh contribution ``g * w[t]``, with float32
accumulation.  No gathered endpoints are saved for the backward.

CPU tensors take the plain versions; CUDA tensors launch
``csrc/distmult_sddmm.cu`` / ``csrc/nn_sddmm.cu`` or raise.
"""

from __future__ import annotations

import torch

from tip_tpu_torch import kernels, trace
from tip_tpu_torch.ops.matmul import bf16_round, compute_round, is_bf16

KERNEL = "distmult_sddmm"
NN_KERNEL = "nn_sddmm"
D = 16  # the kernels' width: n_hid2 of every configuration, DR-NN's l1
TABLES = ("shared", "global")  # where the forward keeps z


def pad_row(z):
    """z with a zero row at the pad id n, as the kernel reads it."""
    return torch.nn.functional.pad(z, (0, 0, 0, 1))


def _gather(z, w, src2d, dst2d, chunk_type):
    zp = pad_row(z)
    return (zp[src2d.long()], zp[dst2d.long()],
            w[chunk_type.long()][:, None, :])


def distmult_logits_plain(z, w, src2d, dst2d, chunk_type):
    """logits [n_chunks, chunk] float32."""
    zs, zd, wt = _gather(z.float(), w.float(), src2d, dst2d, chunk_type)
    return ((zs * zd) * wt).sum(-1)


def distmult_bwd_plain(z, w, src2d, dst2d, chunk_type, g, bf16: bool = False):
    """(dz [n, d], dw [n_et, d]) for the incoming gradient g [n_chunks,
    chunk]; ``bf16`` rounds each scattered contribution to bf16."""
    n, d = z.shape
    zs, zd, wt = _gather(z.float(), w.float(), src2d, dst2d, chunk_type)
    g3 = g.float()[..., None]
    dzs, dzd = (g3 * zd) * wt, (g3 * zs) * wt
    if bf16:
        dzs, dzd = bf16_round(dzs), bf16_round(dzd)
    dz = torch.zeros((n + 1, d), dtype=torch.float32, device=z.device)
    dz.index_add_(0, src2d.long().reshape(-1), dzs.reshape(-1, d))
    dz.index_add_(0, dst2d.long().reshape(-1), dzd.reshape(-1, d))
    dwc = ((zs * zd) * g3).sum(1)  # [n_chunks, d]
    dw = torch.zeros_like(w, dtype=torch.float32)
    dw.index_add_(0, chunk_type.long(), dwc)
    return dz[:n], dw


SEG = 16  # slots a lane quad of the backward walks; C must be a multiple
BWD_WARPS = 8  # warps of a backward block (the order of its dw reduction)


def shared_table_fits(n: int) -> bool:
    """Whether the forward's z table (n + 1 rows of 17 floats) fits one
    block's shared memory: n <= 3,417."""
    return (n + 1) * (D + 1) * 4 <= kernels.SMEM_BYTES


def _check_cuda_args(z, w, src2d, dst2d, chunk_type, grads: bool,
                     table=None):
    """(n, shared): the node count and whether the kernel keeps z in shared
    memory.  The forward's ``table``: None picks "shared" where it fits,
    else "global"; "shared" raises where it does not fit.  The backward
    (``grads``) reads z through L1 at any n: "global" or None."""
    dev = z.device
    kernels.require(z, "z", torch.float32, 2, dev)
    kernels.require(w, "w", torch.float32, 2, dev)
    for name, x in (("src2d", src2d), ("dst2d", dst2d)):
        kernels.require(x, name, torch.int32, 2, dev)
    kernels.require(chunk_type, "chunk_type", torch.int32, 1, dev)
    n, d = z.shape
    if (w.shape[1] != d or dst2d.shape != src2d.shape
            or chunk_type.shape[0] != src2d.shape[0]):
        raise ValueError(f"shapes do not match: z {tuple(z.shape)}, w "
                         f"{tuple(w.shape)}, src2d {tuple(src2d.shape)}, "
                         f"dst2d {tuple(dst2d.shape)}")
    if d != D:
        raise ValueError(f"feature width {d}: the kernel is built for {D}")
    if table not in (None, *TABLES):
        raise ValueError(f"table {table!r} not in {TABLES}")
    if grads:
        if src2d.shape[1] % SEG:
            raise ValueError(f"chunk length {src2d.shape[1]} is not a "
                             f"multiple of {SEG} (the backward's lane quads "
                             f"walk {SEG} slots)")
        if table == "shared":
            raise ValueError("the backward keeps no table in shared memory")
        return n, False
    fits = shared_table_fits(n)
    if table == "shared" and not fits:
        raise ValueError(f"n = {n} does not fit the shared-memory table")
    return n, fits if table is None else table == "shared"


def aligned(*tensors):
    """The tensors, each cloned where its data is not 16-byte aligned (the
    kernel reads 16 bytes a lane)."""
    return [x if x.data_ptr() % 16 == 0 else x.clone() for x in tensors]


def distmult_logits_cuda(z, w, src2d, dst2d, chunk_type, table=None):
    """Launch the forward of csrc/distmult_sddmm.cu (``table``: see
    :func:`_check_cuda_args`)."""
    dev = z.device
    if not z.is_cuda:
        raise ValueError("distmult_logits_cuda needs CUDA tensors")
    n, shared = _check_cuda_args(z, w, src2d, dst2d, chunk_type, False, table)
    n_chunks, chunk = src2d.shape
    out = torch.empty((n_chunks, chunk), dtype=torch.float32, device=dev)
    if w.data_ptr() % 16:  # the forward reads w's rows 16 bytes a lane
        w = w.clone()
    blocks = (2 if shared else 4) * kernels.sm_count(dev)
    kernels.launch(KERNEL, "tip_dm_fwd", "pppppiiiiip", pad_row(z), w, src2d,
                   dst2d, chunk_type, n_chunks, chunk, n, int(shared), blocks,
                   out, device=dev)
    return out


def distmult_bwd_cuda(z, w, src2d, dst2d, chunk_type, g, bf16: bool = False):
    """Launch the backward of csrc/distmult_sddmm.cu."""
    dev = z.device
    if not z.is_cuda:
        raise ValueError("distmult_bwd_cuda needs CUDA tensors")
    n, _ = _check_cuda_args(z, w, src2d, dst2d, chunk_type, True)
    kernels.require(g, "g", torch.float32, 2, dev)
    if g.shape != src2d.shape:
        raise ValueError(f"g {tuple(g.shape)} != src2d {tuple(src2d.shape)}")
    n_chunks, chunk = src2d.shape
    src2d, dst2d, g, w = aligned(src2d, dst2d, g, w)
    n_et = w.shape[0]
    # scratch freed on return while the kernel may still run: the caching
    # allocator reuses it only for later work on this same stream
    f32 = dict(dtype=torch.float32, device=dev)
    dwc = torch.empty((n_chunks, D), **f32)
    dz = torch.empty((n + 1, D), **f32)
    dw = torch.empty((n_et, D), **f32)
    kernels.launch(KERNEL, "tip_dm_bwd", "ppppppiiiiiippp", pad_row(z), w,
                   src2d, dst2d, chunk_type, g, n_chunks, chunk, n, n_et,
                   int(bf16), kernels.sm_count(dev), dwc, dz, dw, device=dev)
    return dz[:n], dw


class _DistmultLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w, src2d, dst2d, chunk_type, compute_dtype):
        zr = compute_round(z, compute_dtype).contiguous()
        wf = w.float().contiguous()
        ctx.save_for_backward(zr, wf, src2d, dst2d, chunk_type)
        ctx.bf16 = is_bf16(compute_dtype)
        if zr.is_cuda:
            return distmult_logits_cuda(zr, wf, src2d, dst2d, chunk_type)
        if zr.device.type != "cpu":
            raise ValueError(f"no distmult SDDMM for device {zr.device}")
        return distmult_logits_plain(zr, wf, src2d, dst2d, chunk_type)

    @staticmethod
    @trace.spanned("distmult_logits")
    def backward(ctx, g):
        zr, wf, src2d, dst2d, chunk_type = ctx.saved_tensors
        bwd = distmult_bwd_cuda if zr.is_cuda else distmult_bwd_plain
        dz, dw = bwd(zr, wf, src2d, dst2d, chunk_type, g.float().contiguous(),
                     ctx.bf16)
        return dz, dw, None, None, None, None


def distmult_logits_padded2(z, w, src2d, dst2d, chunk_type, n_nodes: int,
                            compute_dtype=torch.float32):
    """DistMult logits [n_chunks, chunk] for padded typed edges.

    z [n_nodes, d]; w [n_et, d]; src2d/dst2d [n_chunks, chunk] int32 with
    pad slots at dst = n_nodes (their logits are exactly 0.0); chunk_type
    [n_chunks] int32.  Differentiable in z and w."""
    if z.shape[0] != n_nodes:
        raise ValueError(f"z has {z.shape[0]} rows, n_nodes = {n_nodes}")
    return _DistmultLogits.apply(z, w, src2d, dst2d, chunk_type,
                                 compute_dtype)


def nn_logits_plain(h1, h2, w1, w2, src2d, dst2d, chunk_type):
    """logits [n_chunks, chunk] float32: the per-relation scores of every
    node, gathered per slot, as the kernel computes them."""
    h1p, h2p = pad_row(h1.float()), pad_row(h2.float())
    s1, s2 = h1p @ w1.float().T, h2p @ w2.float().T  # [n + 1, n_et]
    ct = chunk_type.long()[:, None]
    return s1[src2d.long(), ct] + s2[dst2d.long(), ct]


def nn_bwd_plain(h1, h2, w1, w2, src2d, dst2d, chunk_type, g,
                 bf16: bool = False):
    """(dh1, dh2 [n, d], dw1, dw2 [n_et, d]) for the incoming gradient g
    [n_chunks, chunk], through the sums of g per (relation, endpoint);
    ``bf16`` rounds each scattered dh contribution to bf16 instead."""
    n, d = h1.shape
    n_et = w1.shape[0]
    ct = chunk_type.long()[:, None].expand_as(src2d).reshape(-1)
    gf = g.float().reshape(-1)
    sums = []
    for ids in (src2d, dst2d):
        a = torch.zeros((n_et, n + 1), dtype=torch.float32, device=g.device)
        a.index_put_((ct, ids.long().reshape(-1)), gf, accumulate=True)
        sums.append(a[:, :n])
    (g1, g2), (h1f, h2f), (w1f, w2f) = sums, (h1.float(), h2.float()), (
        w1.float(), w2.float())
    dw1, dw2 = g1 @ h1f, g2 @ h2f
    if not bf16:
        return g1.T @ w1f, g2.T @ w2f, dw1, dw2
    dh = []
    for ids, w in ((src2d, w1f), (dst2d, w2f)):
        contrib = bf16_round(gf[:, None] * w[ct])  # [slots, d]
        acc = torch.zeros((n + 1, d), dtype=torch.float32, device=g.device)
        acc.index_add_(0, ids.long().reshape(-1), contrib)
        dh.append(acc[:n])
    return dh[0], dh[1], dw1, dw2


ITEM_CHUNKS = 16  # most chunks of one B9 work item (csrc/nn_sddmm.cu)
CONTRACT_SLAB = 128  # items per slab of contract.cuh's cols


def contract_slabs(items: int) -> int:
    """Slabs of contract.cuh's cols over ``items`` items (B3: relations)."""
    return max(1, -(-items // CONTRACT_SLAB))


def nn_max_items(n_chunks: int, n_et: int) -> int:
    """An upper bound on B9's item count (sum of ceil(m_t / ITEM_CHUNKS)
    over the relations' chunk counts m_t), known without reading
    chunk_type."""
    return min(n_chunks, n_chunks // ITEM_CHUNKS + n_et)


def nn_items(chunk_type, n_et: int):
    """B9's work items, as csrc/nn_sddmm.cu's nn_plan lists them: (items
    int64 [count, 3] of (relation, first chunk, end chunk), rel_items
    [n_et + 1], relation t's items being rel_items[t] .. rel_items[t + 1]
    - 1).  A relation of m chunks gets ceil(m / ITEM_CHUNKS) near-equal
    runs of its chunks, in chunk order."""
    import numpy as np

    ct = np.asarray(chunk_type, dtype=np.int64)
    start = np.searchsorted(ct, np.arange(n_et + 1), side="left")
    items, rel_items = [], [0]
    for t in range(n_et):
        s, m = int(start[t]), int(start[t + 1] - start[t])
        p = -(-m // ITEM_CHUNKS)
        items += [(t, s + j * m // p, s + (j + 1) * m // p) for j in range(p)]
        rel_items.append(len(items))
    return (np.asarray(items, dtype=np.int64).reshape(-1, 3),
            np.asarray(rel_items, dtype=np.int64))


def nn_shared_fits(n: int) -> bool:
    """Whether an item's 2 (n + 1) scores (the forward's) or gradient sums
    (the backward's) fit one block's shared memory: n <= 29,055."""
    return 2 * (n + 1) * 4 <= kernels.SMEM_BYTES


PLAN_RELATIONS = 12287  # most relations of B9's plan (n_et + 1 ints, 48 KB)


def _check_nn_args(h1, h2, w1, w2, src2d, dst2d, chunk_type, table=None):
    """(n, shared): the node count and whether the kernel keeps an item's
    vectors in shared memory.  ``table``: None picks "shared" where they
    fit, else "global"; "shared" raises where they do not fit."""
    dev = h1.device
    for name, x in (("h1", h1), ("h2", h2), ("w1", w1), ("w2", w2)):
        kernels.require(x, name, torch.float32, 2, dev)
    for name, x in (("src2d", src2d), ("dst2d", dst2d)):
        kernels.require(x, name, torch.int32, 2, dev)
    kernels.require(chunk_type, "chunk_type", torch.int32, 1, dev)
    n, d = h1.shape
    if (h2.shape != h1.shape or w1.shape[1] != d or w2.shape != w1.shape
            or dst2d.shape != src2d.shape
            or chunk_type.shape[0] != src2d.shape[0]):
        raise ValueError(f"shapes do not match: h1 {tuple(h1.shape)}, h2 "
                         f"{tuple(h2.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}, src2d {tuple(src2d.shape)}, "
                         f"dst2d {tuple(dst2d.shape)}")
    if d != D:
        raise ValueError(f"hidden width {d}: the kernel is built for {D}")
    if src2d.shape[1] % SEG:
        raise ValueError(f"chunk length {src2d.shape[1]} is not a multiple "
                         f"of {SEG} (the kernel reads 16 bytes a lane and its "
                         f"bf16 backward's lane quads walk {SEG} slots)")
    if w1.shape[0] > PLAN_RELATIONS:
        raise ValueError(f"{w1.shape[0]} relations: the plan takes at most "
                         f"{PLAN_RELATIONS}")
    if table not in (None, *TABLES):
        raise ValueError(f"table {table!r} not in {TABLES}")
    fits = nn_shared_fits(n)
    if table == "shared" and not fits:
        raise ValueError(f"n = {n} does not fit the shared-memory vectors")
    return n, fits if table is None else table == "shared"


def _nn_plan_scratch(n_chunks: int, n_et: int, dev):
    """(max_items, items [max_items][4] int32, rel_items [n_et + 1])."""
    m = nn_max_items(n_chunks, n_et)
    i32 = dict(dtype=torch.int32, device=dev)
    return m, torch.empty((max(m, 1), 4), **i32), torch.empty(n_et + 1, **i32)


def nn_fwd_args(h1, h2, w1, w2, src2d, dst2d, chunk_type, shared: bool):
    """(out, the C arguments) of the NN-decoder forward of csrc/nn_fwd.cuh,
    which B9's ``tip_nn_fwd`` and B7's ``tip_nn1_fwd`` launch alike: the
    items' score rows in shared memory (``shared``), else the score table
    in device memory.  The arguments are checked by the caller."""
    dev = h1.device
    n_chunks, chunk = src2d.shape
    n, n_et = h1.shape[0], w1.shape[0]
    h1, h2, w1, w2, src2d, dst2d = aligned(h1, h2, w1, w2, src2d, dst2d)
    f32 = dict(dtype=torch.float32, device=dev)
    if shared:  # the items' score rows
        m, items, rel_items = _nn_plan_scratch(n_chunks, n_et, dev)
        scores = None
    else:  # the score table
        m, items, rel_items = 0, None, None
        scores = torch.empty((n_et, 2, n + 1), **f32)
    out = torch.empty((n_chunks, chunk), **f32)
    return out, (h1, h2, w1, w2, src2d, dst2d, chunk_type, n_chunks, chunk, n,
                 n_et, int(shared), m, 4 * kernels.sm_count(dev), items,
                 rel_items, scores, out)


def nn_logits_cuda(h1, h2, w1, w2, src2d, dst2d, chunk_type, table=None):
    """Launch the forward of csrc/nn_sddmm.cu (``table``: None picks
    "shared", the items' score rows in shared memory, where they fit, else
    "global", the score table in device memory)."""
    if not h1.is_cuda:
        raise ValueError("nn_logits_cuda needs CUDA tensors")
    _, shared = _check_nn_args(h1, h2, w1, w2, src2d, dst2d, chunk_type, table)
    out, args = nn_fwd_args(h1, h2, w1, w2, src2d, dst2d, chunk_type, shared)
    kernels.launch(NN_KERNEL, "tip_nn_fwd", "pppppppiiiiiiipppp", *args,
                   device=h1.device)
    return out


def nn_bwd_cuda(h1, h2, w1, w2, src2d, dst2d, chunk_type, g,
                bf16: bool = False, table=None):
    """Launch the backward of csrc/nn_sddmm.cu: (dh1, dh2, dw1, dw2)
    (``table``: None picks "shared" where an item's vectors fit, else
    "global")."""
    dev = h1.device
    if not h1.is_cuda:
        raise ValueError("nn_bwd_cuda needs CUDA tensors")
    n, shared = _check_nn_args(h1, h2, w1, w2, src2d, dst2d, chunk_type, table)
    kernels.require(g, "g", torch.float32, 2, dev)
    if g.shape != src2d.shape:
        raise ValueError(f"g {tuple(g.shape)} != src2d {tuple(src2d.shape)}")
    n_chunks, chunk = src2d.shape
    n_et = w1.shape[0]
    h1, h2, w1, w2, src2d, dst2d, g = aligned(h1, h2, w1, w2, src2d, dst2d, g)
    m, items, rel_items = _nn_plan_scratch(n_chunks, n_et, dev)
    slabs = contract_slabs(m)
    # scratch freed on return while the kernel may still run: the caching
    # allocator reuses it only for later work on this same stream
    f32 = dict(dtype=torch.float32, device=dev)
    gs = torch.empty((max(m, 1), 2, n + 1), **f32)
    slab_part = torch.empty((2, slabs, n, D), **f32)
    dw1, dw2 = torch.empty((n_et, D), **f32), torch.empty((n_et, D), **f32)
    dh1, dh2 = torch.empty((n + 1, D), **f32), torch.empty((n + 1, D), **f32)
    kernels.launch(NN_KERNEL, "tip_nn_bwd", "ppppppppiiiiiiiiipppppppp", h1,
                   h2, w1, w2, src2d, dst2d, chunk_type, g, n_chunks, chunk, n,
                   n_et, int(bf16), int(shared), m, slabs,
                   4 * kernels.sm_count(dev), items, rel_items, gs, slab_part,
                   dw1, dw2, dh1, dh2, device=dev)
    return dh1[:n], dh2[:n], dw1, dw2


class _NNLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h1, h2, w1, w2, src2d, dst2d, chunk_type, compute_dtype):
        h1r = compute_round(h1, compute_dtype).contiguous()
        h2r = compute_round(h2, compute_dtype).contiguous()
        w1f, w2f = w1.float().contiguous(), w2.float().contiguous()
        ctx.save_for_backward(h1r, h2r, w1f, w2f, src2d, dst2d, chunk_type)
        ctx.bf16 = is_bf16(compute_dtype)
        args = (h1r, h2r, w1f, w2f, src2d, dst2d, chunk_type)
        if h1r.is_cuda:
            return nn_logits_cuda(*args)
        if h1r.device.type != "cpu":
            raise ValueError(f"no NN-decoder SDDMM for device {h1r.device}")
        return nn_logits_plain(*args)

    @staticmethod
    @trace.spanned("nn_logits")
    def backward(ctx, g):
        args = ctx.saved_tensors
        bwd = nn_bwd_cuda if args[0].is_cuda else nn_bwd_plain
        dh1, dh2, dw1, dw2 = bwd(*args, g.float().contiguous(), ctx.bf16)
        return dh1, dh2, dw1, dw2, None, None, None, None


def nn_logits_padded2(h1, h2, w1, w2, src2d, dst2d, chunk_type, n_nodes: int,
                      compute_dtype=torch.float32):
    """NN-decoder logits [n_chunks, chunk] for padded typed edges.

    h1, h2 [n_nodes, l1] endpoint hiddens; w1, w2 [n_et, l1] relation rows;
    src2d/dst2d [n_chunks, chunk] int32 with pad slots at dst = n_nodes
    (dst term 0; the src term is real, so callers mask pad slots);
    chunk_type [n_chunks] int32.  Differentiable in h1, h2, w1 and w2."""
    if h1.shape[0] != n_nodes or h2.shape[0] != n_nodes:
        raise ValueError(f"h1/h2 have {h1.shape[0]}/{h2.shape[0]} rows, "
                         f"n_nodes = {n_nodes}")
    return _NNLogits.apply(h1, h2, w1, w2, src2d, dst2d, chunk_type,
                           compute_dtype)
