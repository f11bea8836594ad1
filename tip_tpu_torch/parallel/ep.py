"""Relation-partitioned (EP) sharding of the relation-indexed weights and
the D-D buffers (port of tip_tpu/parallel/ep.py).

The R-GCN ``att [R, B]`` and the decoder's relation rows (DistMult
``weight [R, d]``, the NN decoder's ``w1_l2``/``w2_l2 [R, l1]``) behave
like experts: relations are partitioned over the ranks so that all chunks
of a relation live on one rank, and

  * each rank holds only its relations' rows, ``[1, r_max, ...]`` (a slice
    of the ``[n_dev, r_max, ...]`` layout :func:`ep_params` builds);
  * the D-D buffers are re-laid device-major: the chunk axis by owner
    (inert pad chunks fill each rank's segment to one length), the dense
    strips ``dd_adj_sym`` and pages ``dd_adj_t`` and their thresholds into
    ``[n_dev * r_max, ...]`` slot order, zero pages on padding slots;
  * the R-GCN contracts each rank's relation block and one sum over the
    ranks completes the aggregate (nn/rgcn.py); the fused dense BCE (B1 on
    the strips, B2 on the pages) scores the rank's block and the loss sums
    over the ranks (train/model.py);
  * gradients of the relation rows never leave their rank
    (parallel/sharded.py:average_grads scales them, sums nothing).

Host outputs (every array :func:`ep_shard_graph` returns, ``slot``,
``r_max``) are bit-identical to the JAX package's on the same inputs.

The CUDA kernels that bin or score over chunk types (B4, B9) want each
relation's chunks to be one run of non-decreasing types.  A rank's local
relation ids follow the greedy partition, not the chunk order, so the
rank's view also carries its chunks' *bins* (:func:`local_bins`): local
relations renumbered in chunk order, pad chunks joined to the run before
them, and the local row of each bin.  The view's consumers bin by
``dd_chunk_bin`` and gather their rows through ``ep_bin_rel``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tip_tpu_torch.parallel.collectives import all_gather_tiled


@dataclass(frozen=True)
class RelationPartition:
    """Host-side relation -> rank assignment (greedy chunk balance)."""

    dev_of_rel: np.ndarray  # [n_et] rank owning each relation
    local_id: np.ndarray  # [n_et] row within the rank's weight shard
    slot: np.ndarray  # [n_et] dev * r_max + local_id (global gather table)
    r_max: int  # weight rows per rank (padded)
    n_dev: int


def partition_relations(chunk_type, n_et: int, n_dev: int) -> RelationPartition:
    """Greedy longest-processing-time assignment of relations to ranks,
    balancing the ranks' chunk counts."""
    chunk_type = np.asarray(chunk_type)
    counts = np.bincount(chunk_type, minlength=n_et)
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(n_dev, np.int64)
    nrel = np.zeros(n_dev, np.int32)
    dev_of_rel = np.zeros(n_et, np.int32)
    local_id = np.zeros(n_et, np.int32)
    for t in order:
        d = int(np.argmin(load))
        dev_of_rel[t] = d
        local_id[t] = nrel[d]
        nrel[d] += 1
        load[d] += counts[t]
    r_max = int(nrel.max())
    slot = dev_of_rel.astype(np.int64) * r_max + local_id
    return RelationPartition(dev_of_rel=dev_of_rel, local_id=local_id,
                             slot=slot, r_max=r_max, n_dev=n_dev)


def ep_chunk_order(chunk_type, part: RelationPartition) -> np.ndarray:
    """[n_dev * seg] int64: the input chunk at each position of the
    device-major order (-1 for an inert pad chunk)."""
    dev = part.dev_of_rel[np.asarray(chunk_type)]
    order = np.argsort(dev, kind="stable")
    per_dev = np.bincount(dev, minlength=part.n_dev)
    seg = int(per_dev.max())
    idx = np.full((part.n_dev, seg), -1, np.int64)
    offs = np.concatenate([[0], np.cumsum(per_dev)])
    for d in range(part.n_dev):
        idx[d, : per_dev[d]] = order[offs[d]: offs[d + 1]]
    return idx.reshape(-1)


def _numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scatter_rows(full, part: RelationPartition):
    """[n_et, ...] -> [n_dev, r_max, ...] by owner and local row, zeros on
    padding slots; numpy in, numpy out, a tensor in, a tensor out (bf16
    pages included)."""
    shape = (part.n_dev, part.r_max) + tuple(full.shape[1:])
    if isinstance(full, torch.Tensor):
        out = torch.zeros(shape, dtype=full.dtype, device=full.device)
        out[torch.as_tensor(part.dev_of_rel, dtype=torch.long),
            torch.as_tensor(part.local_id, dtype=torch.long)] = full
        return out
    out = np.zeros(shape, full.dtype)
    out[part.dev_of_rel, part.local_id] = full
    return out


def _gather_rows(sharded, part: RelationPartition):
    """Inverse of :func:`_scatter_rows`: [n_dev, r_max, ...] -> [n_et, ...]."""
    if isinstance(sharded, torch.Tensor):
        return sharded[torch.as_tensor(part.dev_of_rel, dtype=torch.long),
                       torch.as_tensor(part.local_id, dtype=torch.long)]
    return np.asarray(sharded)[part.dev_of_rel, part.local_id]


def _slot_pages(pages, part: RelationPartition) -> torch.Tensor:
    """[n_et, ...] pages or thresholds (a tensor, or numpy) -> a tensor
    [n_dev * r_max, ...] in slot order."""
    if not isinstance(pages, torch.Tensor):
        pages = np.asarray(pages)
    out = _scatter_rows(pages, part)
    out = out.reshape((part.n_dev * part.r_max,) + tuple(pages.shape[1:]))
    return out if isinstance(out, torch.Tensor) else torch.from_numpy(out)


def ep_shard_graph(graph: dict, gs, part: RelationPartition, dense_adj=None,
                   neg_q=None, sym_pages=None, neg_q8=None):
    """Reorder the chunk axis device-major by relation owner and pad each
    rank's segment to a common length with inert chunks (dst = n_drug,
    valid 0, global type n_et - 1, local type 0).

    Adds ``dd_chunk_type_local`` (relation row within the owning rank's
    shard) and ``ep_slot`` (global relation -> flattened shard row, for the
    unsharded eval).  ``dd_chunk_type`` stays GLOBAL: the sampler's bitmap
    is keyed by global relation id.

    ``dense_adj``/``neg_q`` (the full pages [n_et, n, n] and their
    [n_et, 3] thresholds) and ``sym_pages``/``neg_q8`` (the strips
    [n_et, 128, NB*128] and their [n_et, 8] thresholds) are re-laid into
    ``[n_dev * r_max, ...]`` slot order (zero pages and thresholds on
    padding slots: inert in the M-first R-GCN and the fused BCE);
    parallel/sharded.py:place_graph hands each rank its ``r_max`` rows.
    Where a page array is not given, the graph's replicated one is
    dropped.

    Returns (graph', gs'): gs' with the padded chunk count, ``ep_r_max``
    and the layout the re-laid buffers make: 'strips' with the strips,
    else 'pages' with the pages, else 'chunked'; ``dd_sampled`` where the
    strips or pages come without their thresholds."""
    chunk_type = _numpy(graph["dd_chunk_type"])
    n_chunks = chunk_type.shape[0]
    chunk = graph["dd_src2d"].shape[1]
    flat = ep_chunk_order(chunk_type, part)
    real = flat >= 0
    take = np.where(real, flat, 0)

    def reorder(x, fill):
        out = _numpy(x)[take]
        out[~real] = fill
        return torch.from_numpy(out)

    g = dict(graph)
    g["dd_src2d"] = reorder(graph["dd_src2d"], 0)
    g["dd_dst2d"] = reorder(graph["dd_dst2d"], gs.n_drug)
    g["dd_chunk_type"] = reorder(chunk_type, gs.n_et - 1)
    g["dd_chunk_type_local"] = reorder(part.local_id[chunk_type], 0)
    valid2d = _numpy(graph["dd_valid"]).reshape(n_chunks, chunk)
    g["dd_valid"] = reorder(valid2d, 0.0).reshape(-1)
    g["ep_slot"] = torch.from_numpy(part.slot.astype(np.int32))
    # (key, array, the pages it rides with): thresholds need their pages
    for key, pages, base in (("dd_adj_t", dense_adj, dense_adj),
                             ("dd_neg_q", neg_q, dense_adj),
                             ("dd_adj_sym", sym_pages, sym_pages),
                             ("dd_neg_q8", neg_q8, sym_pages)):
        if pages is None or base is None:
            g.pop(key, None)
        else:
            g[key] = _slot_pages(pages, part)
    if "dd_adj_sym" in g:
        layout, q = "strips", "dd_neg_q8"
    elif "dd_adj_t" in g:
        layout, q = "pages", "dd_neg_q"
    else:
        layout, q = "chunked", None
    seg = flat.shape[0] // part.n_dev
    gs2 = dataclasses.replace(
        gs, dd_n_chunks=part.n_dev * seg, ep_r_max=part.r_max,
        dd_layout=layout, dd_sampled=q is not None and q not in g)
    return g, gs2


def local_bins(chunk_type_local, valid, r_max: int):
    """A rank's chunk bins: (bins int32 [m], rel int64 [r_max]).

    ``bins`` renumbers the local relation of each chunk in order of first
    appearance among the real chunks (a chunk with a valid slot); a pad
    chunk joins the bin of the chunk before it (bin 0 if none), where it is
    inert.  So the bins never decrease and each is one run of chunks, as
    kernels B4 and B9 want.  ``rel[b]`` is the local row of bin b; local
    rows no chunk of this rank holds follow in order.  Raises if a
    relation's chunks are not one run (ep_shard_graph keeps them so)."""
    lt = _numpy(chunk_type_local).astype(np.int64)
    m = lt.shape[0]
    real = _numpy(valid).reshape(m, -1).any(axis=1)
    bins = np.zeros(m, np.int32)
    rel, seen, prev = [], np.zeros(r_max, bool), -1
    for c in range(m):
        if real[c] and lt[c] != prev:
            if seen[lt[c]]:
                raise ValueError(f"local relation {lt[c]}'s chunks are not "
                                 "one run; re-lay the graph with "
                                 "ep_shard_graph")
            seen[lt[c]] = True
            rel.append(lt[c])
            prev = lt[c]
        bins[c] = max(len(rel) - 1, 0)
    rel += [t for t in range(r_max) if not seen[t]]
    return bins, np.asarray(rel, np.int64)


# Relation-indexed decoder leaves by decoder family: DistMult ``weight``,
# the NN decoder's ``w1_l2``/``w2_l2`` (its L1 matrices stay replicated).
_DECODER_REL_LEAVES = ("weight", "w1_l2", "w2_l2")


def _is_ep_leaf(path: tuple) -> bool:
    return path[-1] == "att" or (path[0] == "decoder"
                                 and path[-1] in _DECODER_REL_LEAVES)


def _map_paths(fn, tree: dict, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def ep_params(params: dict, part: RelationPartition) -> dict:
    """Re-lay the relation-indexed rows into rank shards: ``att`` of both
    R-GCN layers and the decoder's relation rows [n_et, ...] ->
    [n_dev, r_max, ...]; the other leaves as they are.  Leaves are numpy
    arrays or tensors; the result keeps each leaf's kind."""
    dec = params["decoder"]
    if not any(k in dec for k in _DECODER_REL_LEAVES):
        raise ValueError(f"no relation-indexed decoder leaves among "
                         f"{sorted(dec)}")
    return _map_paths(lambda p, x: _scatter_rows(x, part) if _is_ep_leaf(p)
                      else x, params)


def unep_params(params: dict, part: RelationPartition) -> dict:
    """Inverse of :func:`ep_params` (for checkpoints, gradients, analysis)."""
    return _map_paths(lambda p, x: _gather_rows(x, part) if _is_ep_leaf(p)
                      else x, params)


def ep_param_specs(params: dict) -> dict:
    """Per leaf of ``params``: 'edges' where the leaf is rank-local (split
    over all ranks along its leading axis: ``att`` and the decoder's
    relation rows), None where it is replicated (the JAX package's
    PartitionSpec pytree)."""
    return _map_paths(lambda p, _: "edges" if _is_ep_leaf(p) else None, params)


def shard_params(params: dict, specs: dict, rank: int) -> dict:
    """This rank's view of EP params: row ``rank`` (kept as [1, r_max, ...])
    of each rank-local leaf, the replicated leaves whole."""
    def take(path, x):
        spec = specs
        for k in path:
            spec = spec[k]
        return x[rank:rank + 1] if spec == "edges" else x

    return _map_paths(take, params)


def gather_params(params: dict, specs: dict, mesh) -> dict:
    """The whole EP layout from the ranks' views: each rank-local leaf
    gathered over all ranks into [n_dev, r_max, ...] (a collective: every
    rank calls it), the replicated leaves as they are; detached."""
    def gather(path, x):
        spec = specs
        for k in path:
            spec = spec[k]
        if spec != "edges":
            return x.detach()
        with torch.no_grad():
            return all_gather_tiled(x.detach())

    return _map_paths(gather, params)
