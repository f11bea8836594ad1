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
  * **Parameters** are replicated.  Each rank backpropagates the replicated
    loss, the step sums the gradients over all ranks and divides by their
    number (parallel/collectives.py says why that is the single-device
    gradient), and every rank runs the same Adam update, so the parameters
    stay identical on every rank.

The relation-partitioned (EP) layout of the JAX package
(tip_tpu/parallel/ep.py) is not ported yet; its dense buffers are dropped.
"""

from __future__ import annotations

import dataclasses

import torch

from tip_tpu_torch.convert import leaves
from tip_tpu_torch.parallel.collectives import all_reduce_plain

# Graph keys sharded along their leading axis: the D-D chunk axis over all
# ranks (the JAX package's list also holds the EP pages, not ported yet);
# the ring buffers (parallel/ring.py) over the ring axis.
_SHARDED_KEYS = ("dd_src2d", "dd_dst2d", "dd_chunk_type", "dd_valid")
_RING_KEYS = ("ppr_src", "ppr_dstl", "ppr_w", "dpr_srcl", "dpr_dst",
              "dpr_w", "pp_a1r")
# replicated dense layouts of one device: every rank would hold a whole
# copy and the dense branches would count each edge once per rank
_REPLICATED_DENSE = ("dd_adj_t", "dd_neg_q", "dd_adj_sym", "dd_neg_q8",
                     "dd_adj_u8", "pp_a1")


def shard_graph(graph: dict, gs, n_devices: int):
    """Drop the replicated dense buffers and pad the D-D chunk axis to a
    multiple of ``n_devices``.

    Pad chunks take relation n_et-1 with all-pad slots (dst = n_drug,
    valid 0), so they add nothing to the aggregation or the loss.  Returns
    (graph', gs'): gs' says the chunked layout (the only one a mesh runs)
    with the padded chunk count; ``pp_layout`` 'windowed' where the
    windowed P-P buffers remain (a mesh without the ring runs them
    replicated), else 'none' (add the ring)."""
    if "dd_src2d" not in graph:
        raise ValueError("sharding splits the chunk-aligned D-D buffers: pack "
                         "the graph with dense_dtype=None (or sampled=True)")
    g = {k: v for k, v in graph.items() if k not in _REPLICATED_DENSE}
    n_chunks, chunk = g["dd_src2d"].shape
    pad = (-n_chunks) % n_devices
    if pad:
        i32 = dict(dtype=torch.int32)
        g["dd_src2d"] = torch.cat([g["dd_src2d"], torch.zeros((pad, chunk), **i32)])
        g["dd_dst2d"] = torch.cat([g["dd_dst2d"],
                                   torch.full((pad, chunk), gs.n_drug, **i32)])
        g["dd_chunk_type"] = torch.cat([g["dd_chunk_type"],
                                        torch.full((pad,), gs.n_et - 1, **i32)])
        g["dd_valid"] = torch.cat([g["dd_valid"], torch.zeros(
            pad * chunk, dtype=g["dd_valid"].dtype)])
    return g, dataclasses.replace(
        gs, dd_layout="chunked", dd_sampled=False, dd_n_chunks=n_chunks + pad,
        pp_layout="windowed" if "ppw_src" in g else "none")


def graph_specs(graph: dict) -> dict:
    """How each graph entry is laid out over the mesh: 'ring' (split over
    the ring axis), 'edges' (split over all ranks) or None (replicated)."""
    return {k: ("ring" if k in _RING_KEYS else
                "edges" if k in _SHARDED_KEYS else None) for k in graph}


def place_graph(graph: dict, mesh) -> dict:
    """This rank's view of a host graph on its device: the ring keys' block
    for its ring index, the chunk keys' block for its rank, the rest
    whole."""
    out = {}
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
        out[k] = v.to(mesh.device)
    return out


def average_grads(params, mesh) -> None:
    """Replace each parameter's gradient by its sum over all ranks divided
    by their number: one collective over the flattened gradients."""
    ps = [p for p in leaves(params) if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in ps])
    total = all_reduce_plain(flat) / mesh.world
    off = 0
    for p in ps:
        n = p.grad.numel()
        p.grad.copy_(total[off:off + n].view_as(p.grad))
        off += n


def make_sharded_train_step(model, opt, mesh):
    """step(params, graph, seed, u24=None) -> loss: the replicated loss of
    ``model`` (train/model.py:TIP) on this rank's graph view
    (:func:`place_graph`), its backward, the gradients averaged over the
    ranks, then ``opt`` (a torch optimizer over ``leaves(params)``).  Every
    rank calls it with the same seed; ``u24`` is this rank's slice of the
    sampler's draws."""

    def step(params, graph, seed: int, u24=None):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, graph, seed, u24=u24, mesh=mesh)
        loss.backward()
        average_grads(params, mesh)
        opt.step()
        return loss.detach()

    return step
