"""Edge-sharded training step over ``torch.distributed`` (port of
tip_tpu/parallel/sharded.py).

Sharding layout, as the JAX package's:

  * **Edge-chunk sharding.**  The D-D chunk-aligned edge buffers are split
    evenly over all ranks (padded with inert chunks first, :func:`shard_graph`).
    Each rank bins only its chunks (kernel B4) and one sum over ranks of the
    basis-mixed [num_base, d_in, n_drug] intermediate rebuilds the global
    aggregate (nn/rgcn.py).
  * **Decoder and loss.**  Each rank negative-samples (B10) and scores (B8)
    its own chunks; the masked log-likelihood sums are summed over ranks
    before dividing by the global number of train edges (train/model.py).
  * **P-P ring.**  With :func:`~tip_tpu_torch.parallel.ring.add_ring_pp`,
    the protein rows are sharded over the ring axis and the P-P GCN runs as
    a ring (kernel B11, or the dense row blocks).
  * **Relation partition (EP).**  With parallel/ep.py:ep_shard_graph the
    chunks are laid out device-major by relation owner, and the dense
    strips and pages in slot order: they ride the chunk axis, so each rank
    holds its relations' block and the dense layouts run sharded too.
  * **Parameters** are replicated, apart from the EP leaves
    (parallel/ep.py:ep_param_specs), of which each rank holds its own rows.
    Each rank backpropagates the replicated loss; the step sums the
    gradients of the replicated leaves over all ranks and divides by their
    number, and divides those of the rank-local leaves by the number of
    ranks without summing them (:func:`average_grads` says why both give
    the single-device gradient).  Every rank runs the same Adam update, so
    the replicated parameters stay identical on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from tip_tpu_torch.convert import leaves
from tip_tpu_torch.parallel.collectives import all_reduce_plain
from tip_tpu_torch.parallel.ep import local_bins

# Graph keys sharded along their leading axis over all ranks: the D-D chunk
# axis, and the EP relation pages and strips with their thresholds
# (parallel/ep.py, [n_dev * r_max, ...] in slot order); the ring buffers
# (parallel/ring.py) over the ring axis.
_SHARDED_KEYS = ("dd_src2d", "dd_dst2d", "dd_chunk_type", "dd_chunk_type_local",
                 "dd_valid", "dd_adj_t", "dd_neg_q", "dd_adj_sym", "dd_neg_q8")
_RING_KEYS = ("ppr_src", "ppr_dstl", "ppr_w", "dpr_srcl", "dpr_dst",
              "dpr_w", "pp_a1r")
# replicated dense layouts of one device: every rank would hold a whole
# copy and the dense branches would count each edge once per rank; the EP
# re-lay (parallel/ep.py:ep_shard_graph) attaches the sharded ones
_REPLICATED_DENSE = ("dd_adj_t", "dd_neg_q", "dd_adj_sym", "dd_neg_q8",
                     "dd_adj_u8", "pp_a1")


def shard_graph(graph: dict, gs, n_devices: int):
    """Pad the D-D chunk axis to a multiple of ``n_devices``; drop the
    replicated dense buffers unless the graph is EP-laid.

    Pad chunks take relation n_et-1 with all-pad slots (dst = n_drug,
    valid 0), so they add nothing to the aggregation or the loss.  Returns
    (graph', gs').  A graph that is not EP-laid (``gs.ep_r_max`` 0) loses
    its dense buffers and gs' says the chunked layout with the padded chunk
    count (parallel/ep.py:ep_shard_graph then re-attaches the pages in slot
    order); an EP-laid graph keeps its slot-ordered pages and its layout.
    ``pp_layout`` is 'windowed' where the windowed P-P buffers remain (a
    mesh without the ring runs them replicated), else 'none' (add the
    ring)."""
    if "dd_src2d" not in graph:
        raise ValueError("sharding splits the chunk-aligned D-D buffers: pack "
                         "the graph with dense_dtype=None (or sampled=True), "
                         "or add them (train/model.py:chunk_arrays)")
    ep = gs.ep_r_max > 0
    g = {k: v for k, v in graph.items()
         if not (k in _REPLICATED_DENSE and not (ep and k in _SHARDED_KEYS))}
    n_chunks, chunk = g["dd_src2d"].shape
    pad = (-n_chunks) % n_devices
    if pad and ep:
        raise ValueError(f"an EP-laid graph of {n_chunks} chunks does not "
                         f"split over {n_devices} ranks")
    if pad:
        i32 = dict(dtype=torch.int32)
        g["dd_src2d"] = torch.cat([g["dd_src2d"], torch.zeros((pad, chunk), **i32)])
        g["dd_dst2d"] = torch.cat([g["dd_dst2d"],
                                   torch.full((pad, chunk), gs.n_drug, **i32)])
        g["dd_chunk_type"] = torch.cat([g["dd_chunk_type"],
                                        torch.full((pad,), gs.n_et - 1, **i32)])
        g["dd_valid"] = torch.cat([g["dd_valid"], torch.zeros(
            pad * chunk, dtype=g["dd_valid"].dtype)])
    pp_layout = "windowed" if "ppw_src" in g else "none"
    if ep:
        return g, dataclasses.replace(gs, pp_layout=pp_layout)
    return g, dataclasses.replace(
        gs, dd_layout="chunked", dd_sampled=False, dd_n_chunks=n_chunks + pad,
        pp_layout=pp_layout)


def graph_specs(graph: dict) -> dict:
    """How each graph entry is laid out over the mesh: 'ring' (split over
    the ring axis), 'edges' (split over all ranks) or None (replicated)."""
    return {k: ("ring" if k in _RING_KEYS else
                "edges" if k in _SHARDED_KEYS else None) for k in graph}


def place_graph(graph: dict, mesh, gs=None) -> dict:
    """This rank's view of a host graph on its device: the ring keys' block
    for its ring index, the chunk keys' block for its rank, the rest
    whole.  For an EP-laid graph (``gs.ep_r_max`` > 0) the view also holds
    its chunks' bins ``dd_chunk_bin`` and their local rows ``ep_bin_rel``
    (parallel/ep.py:local_bins)."""
    out, host = {}, {}
    for k, spec in graph_specs(graph).items():
        v = graph[k]
        if spec is not None:
            parts, i = ((mesh.n_ring, mesh.ring_rank) if spec == "ring"
                        else (mesh.world, mesh.rank))
            if v.shape[0] % parts:
                raise ValueError(f"{k}: {v.shape[0]} rows do not split over "
                                 f"{parts} ranks; shard_graph pads the chunks")
            m = v.shape[0] // parts
            v = v[i * m:(i + 1) * m]
        host[k] = v
        out[k] = v.to(mesh.device)
    if gs is not None and gs.ep_r_max and "dd_chunk_type_local" in graph:
        bins, rel = local_bins(host["dd_chunk_type_local"], host["dd_valid"],
                               gs.ep_r_max)
        out["dd_chunk_bin"] = torch.from_numpy(bins).to(mesh.device)
        out["ep_bin_rel"] = torch.from_numpy(rel).to(mesh.device)
    return out


def average_grads(params, mesh, specs=None) -> None:
    """Turn each rank's gradients into the single-device gradient.

    Every rank backpropagates the replicated loss, a cotangent of 1, and
    the backward of each sum over the ranks sums the cotangents
    (parallel/collectives.py), so every path from the loss back through a
    sum over ranks carries the world size.  A replicated leaf's gradient is
    a share on each rank, each share times the world size: the sum over
    the ranks divided by their number is its gradient.  A rank-local leaf
    (``specs`` 'edges', parallel/ep.py:ep_param_specs: the EP relation
    rows) is used by its rank alone, on the far side of the loss's and the
    aggregate's sums over ranks, so its gradient is whole on its rank, times
    the world size: it is divided by their number and not summed.  One
    collective over the replicated leaves' flattened gradients."""
    flags = leaves(specs) if specs is not None else None
    ps = [(p, flags is not None and flags[i] == "edges")
          for i, p in enumerate(leaves(params)) if p.grad is not None]
    shared = [p for p, local in ps if not local]
    if shared:
        flat = torch.cat([p.grad.reshape(-1) for p in shared])
        total = all_reduce_plain(flat) / mesh.world
        off = 0
        for p in shared:
            n = p.grad.numel()
            p.grad.copy_(total[off:off + n].view_as(p.grad))
            off += n
    for p, local in ps:
        if local:
            p.grad.div_(mesh.world)


def make_sharded_train_step(model, opt, mesh, remat: bool = False,
                            param_specs=None):
    """step(params, graph, seed, u24=None) -> loss: the replicated loss of
    ``model`` (train/model.py:TIP) on this rank's graph view
    (:func:`place_graph`), its backward, the gradients averaged over the
    ranks (:func:`average_grads`; ``param_specs`` marks the EP leaves),
    then ``opt`` (a torch optimizer over ``leaves(params)``).  ``remat``
    recomputes the encoder in the backward, its collectives included
    (TIP.encode).  Every rank calls it with the same seed; ``u24`` is this
    rank's slice of the sampler's draws."""

    def step(params, graph, seed: int, u24=None):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, graph, seed, u24=u24, mesh=mesh,
                          remat=remat)
        loss.backward()
        average_grads(params, mesh, param_specs)
        opt.step()
        return loss.detach()

    return step
