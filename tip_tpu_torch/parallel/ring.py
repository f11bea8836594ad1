"""Protein-row ring decomposition of the P-P GCN (port of
tip_tpu/parallel/ring.py).

Each rank of the ring owns a contiguous shard of ``n_local`` protein rows
(the last shard zero-padded).  At ring step s rank i multiplies its
adjacency block ``A[rows_i, rows_(i+s) mod k]`` against the activation
shard it holds, then passes that shard to rank (i-1) mod k; after k steps
every output row has seen every source shard.  Activations move, the
adjacency never does.  On CUDA tensors the ring is kernel B11
(ops/ring.py), which copies the shard into the neighbour's buffer itself;
:func:`ring_spmm` here is its plain version over the collectives of
parallel/collectives.py.

Block layout (host side, :func:`build_ring_pp`, bit-identical to the JAX
package's): edges binned by (dst_shard, (src_shard - dst_shard) mod k),
sorted by local destination within each bin, each bin padded to one block
size with ``dst_local = 0, w = 0`` after its real edges.  The P->D
hierarchy reads the row-sharded output directly: each rank sums its local
protein rows into the drug rows and one sum over the ring completes the
mean (:func:`ring_hierarchy_apply`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tip_tpu_torch.data.packing import dense_pp_feasible, dense_pp_parts
from tip_tpu_torch.ops.matmul import bf16_round
from tip_tpu_torch.ops.segment import mean_from_sum, segment_sum_sorted
from tip_tpu_torch.parallel.collectives import (
    all_gather_tiled,
    group_rank,
    ppermute_from,
    psum,
)

# the replicated P-P and P->D buffers the ring buffers take the place of
_REPLACED_BY_RING = ("pp_a1", "pp_dinv", "ppw_src", "ppw_dstl", "ppw_w",
                     "ppw_chunk_window", "pp_norm_index", "pp_norm_weight",
                     "dp_src", "dp_dst")


def ring_shard_size(n_rows: int, n_shards: int) -> int:
    return -(-n_rows // n_shards)


@dataclass(frozen=True)
class RingPP:
    """Host-packed ring blocks; all arrays lead with the shard axis."""

    src_local: np.ndarray  # [k, k, E_pad] int32, row within the SOURCE shard
    dst_local: np.ndarray  # [k, k, E_pad] int32, row within the DEST shard
    weight: np.ndarray  # [k, k, E_pad] f32, 0 on padding
    dp_src_local: np.ndarray  # [k, Edp_pad] int32
    dp_dst: np.ndarray  # [k, Edp_pad] int32 (global drug row)
    dp_weight: np.ndarray  # [k, Edp_pad] f32 valid mask
    n_shards: int
    n_local: int  # protein rows per shard (last shard padded)


def build_ring_pp(norm_index: np.ndarray, norm_weight: np.ndarray,
                  dp_edge_index: np.ndarray, n_prot: int, n_shards: int,
                  pad_multiple: int = 512) -> RingPP:
    """Bin the cached-normalized P-P COO and the P->D edges into ring
    blocks.  Block (i, s) holds the edges whose destination row lives in
    shard i and whose source row lives in shard (i + s) mod k, sorted by
    local destination."""
    k = n_shards
    n_local = ring_shard_size(n_prot, k)
    src, dst = np.asarray(norm_index, np.int64)
    w = np.asarray(norm_weight, np.float32)
    ss, ds = src // n_local, dst // n_local
    step = (ss - ds) % k
    bin_id = ds * k + step
    order = np.lexsort((dst, bin_id))
    src, dst, w, bin_id = src[order], dst[order], w[order], bin_id[order]
    counts = np.bincount(bin_id, minlength=k * k)
    e_pad = max(int(counts.max()), 1)
    e_pad = -(-e_pad // pad_multiple) * pad_multiple
    src_l = np.zeros((k * k, e_pad), np.int32)
    dst_l = np.zeros((k * k, e_pad), np.int32)
    w_p = np.zeros((k * k, e_pad), np.float32)
    offs = np.concatenate([[0], np.cumsum(counts)])
    for b in range(k * k):
        lo, hi = offs[b], offs[b + 1]
        n = hi - lo
        src_l[b, :n] = (src[lo:hi] % n_local).astype(np.int32)
        dst_l[b, :n] = (dst[lo:hi] % n_local).astype(np.int32)
        w_p[b, :n] = w[lo:hi]

    # P->D edges binned by source (protein) shard, sorted by drug dst
    dsrc, ddst = np.asarray(dp_edge_index, np.int64)
    pshard = dsrc // n_local
    order = np.lexsort((ddst, pshard))
    dsrc, ddst, pshard = dsrc[order], ddst[order], pshard[order]
    dcounts = np.bincount(pshard, minlength=k)
    dp_pad = -(-max(int(dcounts.max()), 1) // pad_multiple) * pad_multiple
    dp_src_l = np.zeros((k, dp_pad), np.int32)
    dp_dst = np.zeros((k, dp_pad), np.int32)
    dp_w = np.zeros((k, dp_pad), np.float32)
    doffs = np.concatenate([[0], np.cumsum(dcounts)])
    for i in range(k):
        lo, hi = doffs[i], doffs[i + 1]
        n = hi - lo
        dp_src_l[i, :n] = (dsrc[lo:hi] % n_local).astype(np.int32)
        dp_dst[i, :n] = ddst[lo:hi].astype(np.int32)
        dp_w[i, :n] = 1.0
    return RingPP(
        src_local=src_l.reshape(k, k, e_pad),
        dst_local=dst_l.reshape(k, k, e_pad),
        weight=w_p.reshape(k, k, e_pad),
        dp_src_local=dp_src_l, dp_dst=dp_dst, dp_weight=dp_w,
        n_shards=k, n_local=n_local,
    )


def add_ring_pp(graph: dict, data, gs, n_shards: int, dense_pp=None):
    """Replace the replicated P-P and P->D buffers of a host graph dict
    by ring-sharded ones.

    Returns (graph', gs') with ``gs'.pp_ring_shards = n_shards`` and
    ``gs'.pp_layout = 'none'``: graph' carries only what the ring path
    reads (``dp_deg`` stays replicated).  The new keys ("ppr_*", "dpr_*",
    and "pp_a1r" + "pp_dinv" with ``dense_pp``) lead with the shard axis;
    parallel/sharded.py:place_graph hands each
    ring rank its slice.  ``dense_pp`` ships the row-sharded int8 (A+I)
    ``pp_a1r`` [n_shards * n_local, n_prot] (zero pad rows) and the
    replicated ``pp_dinv``, so the sharded encoder runs the dense row-block
    GEMM (:func:`ring_pp_encoder_apply_dense`); None = where feasible
    (data/packing.py:dense_pp_feasible) and free of duplicate edges."""
    ring = build_ring_pp(data.pp_norm_index, data.pp_norm_weight,
                         data.dp_edge_index, gs.n_prot, n_shards)
    g = {k: v for k, v in graph.items() if k not in _REPLACED_BY_RING}
    g["ppr_src"] = torch.from_numpy(ring.src_local)
    g["ppr_dstl"] = torch.from_numpy(ring.dst_local)
    g["ppr_w"] = torch.from_numpy(ring.weight)
    g["dpr_srcl"] = torch.from_numpy(ring.dp_src_local)
    g["dpr_dst"] = torch.from_numpy(ring.dp_dst)
    g["dpr_w"] = torch.from_numpy(ring.dp_weight)
    if dense_pp is None:
        dense_pp = dense_pp_feasible(gs.n_prot)
    if dense_pp:
        try:
            a1, dinv = dense_pp_parts(data.pp_norm_index, gs.n_prot)
        except ValueError:  # duplicate P-P edges: 0/1 cannot hold them
            a1 = None
        if a1 is not None:
            pad = n_shards * ring.n_local - a1.shape[0]
            if pad:
                a1 = np.pad(a1, ((0, pad), (0, 0)))  # zero rows: inert
            g["pp_a1r"] = torch.from_numpy(a1)
            g["pp_dinv"] = torch.from_numpy(dinv)
    return g, dataclasses.replace(gs, pp_ring_shards=n_shards,
                                  pp_layout="none")


def ring_spmm(h_own, src_l, dst_l, w, n_local: int, mesh):
    """out[rows_i] = sum_s A[rows_i, rows_(i+s)] @ h[rows_(i+s)] on ring
    rank i (the plain version of kernel B11).

    h_own: [n_local, d], this rank's own source-row shard; src_l/dst_l/w:
    [k, E_pad], this rank's ring blocks, step-major.  k steps of gather *
    weight -> segment sum, the shard passed to rank (i-1) mod k between
    steps; autograd runs back through the permutations."""
    k = src_l.shape[0]
    out = torch.zeros((n_local, h_own.shape[1]), dtype=h_own.dtype,
                      device=h_own.device)
    h = h_own
    for s in range(k):
        out = out + segment_sum_sorted(h[src_l[s].long()] * w[s][:, None],
                                       dst_l[s], n_local)
        if s < k - 1:
            h = ppermute_from(h, 1, mesh.ring_group)
    return out


def local_rows(x, mesh, n_shards: int, n_local: int):
    """This ring rank's row shard of a replicated [n_rows, d] tensor
    (zero-padded past n_rows)."""
    i = group_rank(mesh.ring_group)
    pad = n_shards * n_local - x.shape[0]
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x[i * n_local:(i + 1) * n_local]


def ring_pp_encoder_apply(params, graph, gs, mesh, x_prot=None,
                          backend: str = "pallas"):
    """Row-sharded 2-layer P-P GCN over the COO ring blocks; returns
    hp_local [n_local, pp_hid2].  Identity protein features (x_prot=None):
    layer 1's weight rows are the activation table, so each rank slices its
    own rows; with features, each rank projects its own row shard.  The
    SpMM is kernel B11 on CUDA tensors (ops/ring.py:ring_spmm_rdma), its
    plain version on CPU tensors; ``backend="xla"`` takes the ppermute ring
    (:func:`ring_spmm`) on either, as the JAX package's XLA branch."""
    from tip_tpu_torch.ops.ring import ring_spmm_rdma

    k, n_local = gs.pp_ring_shards, ring_shard_size(gs.n_prot, gs.pp_ring_shards)
    blocks = (graph["ppr_src"][0], graph["ppr_dstl"][0], graph["ppr_w"][0])

    def spmm(h):
        if backend == "xla":
            return ring_spmm(h, *blocks, n_local, mesh)
        return ring_spmm_rdma(h, *blocks, mesh)

    if x_prot is None:
        h = local_rows(params["conv1"]["weight"], mesh, k, n_local)
    else:
        h = local_rows(x_prot, mesh, k, n_local) @ params["conv1"]["weight"]
    h = torch.relu(spmm(h) + params["conv1"]["bias"])
    h = spmm(h @ params["conv2"]["weight"])
    return h + params["conv2"]["bias"]


def ring_pp_encoder_apply_dense(params, graph, gs, mesh, x_prot=None):
    """Row-sharded 2-layer P-P GCN over this rank's dense (A+I) row block
    ``pp_a1r`` [n_local, n_prot]:

        out_local = dinv_local * (A1_local @ (dinv * (x @ W)))

    with bf16-rounded operands and float32 accumulation, as
    nn/gcn.py:gcn_conv_apply_dense does for the whole matrix.  Layer 1
    needs no communication under identity features; layer 2 all-gathers
    the [n_prot, d] hidden.  Returns hp_local [n_local, pp_hid2]."""
    k = gs.pp_ring_shards
    n_local = ring_shard_size(gs.n_prot, k)
    a1l = bf16_round(graph["pp_a1r"])  # int8 0/1: the upcast is exact
    dinv = graph["pp_dinv"]
    dinv_l = local_rows(dinv[:, None], mesh, k, n_local)

    def conv_local(xw_full, bias):
        g = xw_full * dinv[: xw_full.shape[0], None]
        out = (a1l @ bf16_round(g)) * dinv_l
        return out if bias is None else out + bias

    xw = (params["conv1"]["weight"] if x_prot is None
          else x_prot @ params["conv1"]["weight"])
    h_local = torch.relu(conv_local(xw, params["conv1"]["bias"]))
    # layer 2 needs every source row of the hidden: gather the row shards
    h_full = all_gather_tiled(h_local, mesh.ring_group)[: gs.n_prot]
    return conv_local(h_full @ params["conv2"]["weight"],
                      params["conv2"]["bias"])


def ring_hierarchy_apply(params, hp_local, graph, dp_deg, n_drug: int, mesh):
    """P->D mean conv from the row-sharded protein embedding: each rank
    sums its local protein rows into the drug rows, one sum over the ring
    completes them, then the mean and the projection."""
    sl = graph["dpr_srcl"][0].long()
    dst = graph["dpr_dst"][0]
    w = graph["dpr_w"][0]
    part = segment_sum_sorted(hp_local[sl] * w[:, None], dst, n_drug)
    total = psum(part, mesh.ring_group)
    return mean_from_sum(total, dp_deg) @ params["weight"]
