"""Encoders (port of tip_tpu/nn/encoders.py:36-100, 100-218 and 226-242).

P-P: two GCN layers, dense over the int8 (A+I) where the graph ships it
(kernel B12, ops/pp_aggregate.py; with ``backend="xla"`` the float32
product of its upcast), else windowed over the P-P edge buffers (kernel
B5, the JAX package's ``backend="pallas"`` branch) or, with
``backend="xla"``, over the COO cached normalization
(:func:`pp_encoder_apply`, plain ``index_add_``, the JAX package's XLA
branch; PP-GAE's too, where its dense (A+I) cannot be built); P->D: the
mean hierarchy conv; the drug embedding joined by concatenation (TIP-cat) or sum (TIP-add); D-D: both R-GCN layers from one
M-first contraction over the symmetric strips or the full count pages
where the graph ships them, else two chunked layers (kernel B4, or the
segment sum of the XLA branch).  Under a mesh (parallel/mesh.py) with
ring-sharded protein rows (``gs.pp_ring_shards``) the P-P GCN runs
row-sharded over the ring (the dense row blocks where ``pp_a1r`` ships,
else the COO ring: kernel B11 with 'pallas', the ppermute ring of
parallel/ring.py with 'xla') and the hierarchy completes its sum over the
ring (parallel/ring.py); the D-D side runs chunked there, each rank on its
own chunks, or on any layout once it is relation-partitioned
(parallel/ep.py, ``gs.ep_r_max`` > 0: each rank on its relations' block).
The P-D-only hierarchy encoder (PR-HMP-NN) embeds drugs from their
protein targets alone.
"""

from __future__ import annotations

import torch

from tip_tpu_torch import trace
from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.nn.gcn import (
    gcn_conv_apply,
    gcn_conv_apply_dense,
    gcn_conv_apply_windowed,
    gcn_conv_init,
)
from tip_tpu_torch.nn.hierarchy import hierarchy_conv_apply, hierarchy_conv_init
from tip_tpu_torch.nn.rgcn import rgcn_init, rgcn_pair_on_layout
from tip_tpu_torch.parallel.ring import (
    ring_hierarchy_apply,
    ring_pp_encoder_apply,
    ring_pp_encoder_apply_dense,
)


def pp_encoder_init(gen, in_dim: int, hid1: int = 32, hid2: int = 16,
                    device=None):
    return {
        "conv1": gcn_conv_init(gen, in_dim, hid1, device=device),
        "conv2": gcn_conv_init(gen, hid1, hid2, device=device),
    }


def pp_encoder_apply(params, x_prot, norm_index, norm_weight, n_prot: int):
    """Two GCN layers over the COO cached normalization; x_prot=None is the
    identity-feature fast path."""
    h = torch.relu(gcn_conv_apply(params["conv1"], x_prot, norm_index,
                                  norm_weight, n_prot))
    return gcn_conv_apply(params["conv2"], h, norm_index, norm_weight, n_prot)


def pp_encoder_apply_dense(params, x_prot, a1, dinv,
                           backend: str = "pallas"):
    """Two dense GCN layers over the resident int8 (A+I) (kernel B12 on the
    card: no upcast copy); ``backend="xla"`` upcasts it once for both and
    takes the plain float32 products."""
    if backend == "xla":
        a1 = a1.float()
    h = torch.relu(gcn_conv_apply_dense(params["conv1"], x_prot, a1, dinv,
                                        backend))
    return gcn_conv_apply_dense(params["conv2"], h, a1, dinv, backend)


def pp_encoder_apply_windowed(params, x_prot, graph, gs,
                              kernel_dtype: str = "float32"):
    """Two GCN layers over the pre-windowed P-P buffers (kernel B5)."""
    args = (graph["ppw_src"], graph["ppw_dstl"], graph["ppw_w"],
            graph["ppw_chunk_window"], gs.pp_n_windows, gs.pp_window,
            gs.n_prot)
    h = torch.relu(gcn_conv_apply_windowed(params["conv1"], x_prot, *args,
                                           kernel_dtype=kernel_dtype))
    return gcn_conv_apply_windowed(params["conv2"], h, *args,
                                   kernel_dtype=kernel_dtype)


def fm_encoder_init(gen, cfg: ModelConfig, n_drug: int, n_prot: int,
                    n_et: int, in_dim_drug=None, device=None):
    """in_dim_drug defaults to n_drug (identity drug features)."""
    in_dim_drug = n_drug if in_dim_drug is None else in_dim_drug
    return {
        "pp": pp_encoder_init(gen, n_prot, cfg.pp_hid1, cfg.pp_hid2, device),
        "embed": init.normal(gen, (in_dim_drug, cfg.n_embed), device=device),
        "hier": hierarchy_conv_init(gen, cfg.pp_hid2, cfg.prot_drug_dim,
                                    device=device),
        "rgcn1": rgcn_init(gen, cfg.rgcn_in_dim, cfg.n_hid1, n_et,
                           cfg.num_base, after_relu=False, device=device),
        "rgcn2": rgcn_init(gen, cfg.n_hid1, cfg.n_hid2, n_et, cfg.num_base,
                           after_relu=True, device=device),
    }


def fm_encoder_apply(params, graph, cfg: ModelConfig, gs, x_drug=None,
                     x_prot=None, d_norm=None, mesh=None,
                     backend: str = "pallas"):
    """Final drug embeddings z [n_drug, n_hid2]; ``gs.pp_layout`` and
    ``gs.dd_layout`` say which buffers ``graph`` carries.  ``mesh``: this
    rank's place when ``graph`` is its view of a sharded graph
    (parallel/sharded.py:place_graph); the chunked layout, or any layout
    once it is relation-partitioned (``gs.ep_r_max`` > 0; ``params`` then
    hold the rank's own ``att`` rows and ``graph`` the rank's relation
    block, train/model.py:TIP._ep_encoder_view).  ``backend``: 'pallas'
    (the kernels) or 'xla' (the JAX package's XLA branches)."""
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}: 'pallas' or 'xla'")
    if mesh is not None and gs.dd_layout != "chunked" and not gs.ep_r_max:
        raise ValueError(f"a mesh shards the chunked D-D layout, or a dense "
                         f"one partitioned by relation (parallel/ep.py:"
                         f"ep_shard_graph), not a replicated "
                         f"{gs.dd_layout!r} (parallel/sharded.py:shard_graph)")
    if mesh is not None and gs.pp_ring_shards > 0:
        with trace.span("pp_gcn"):
            if "pp_a1r" in graph:
                hp_local = ring_pp_encoder_apply_dense(params["pp"], graph, gs,
                                                       mesh, x_prot)
            else:
                hp_local = ring_pp_encoder_apply(params["pp"], graph, gs, mesh,
                                                 x_prot, backend=backend)
        with trace.span("hierarchy"):
            hd = ring_hierarchy_apply(params["hier"], hp_local, graph,
                                      graph["dp_deg"], gs.n_drug, mesh)
    else:
        with trace.span("pp_gcn"):
            hp = _pp_encoder(params["pp"], x_prot, graph, cfg, gs, backend)
        with trace.span("hierarchy"):
            hd = hierarchy_conv_apply(params["hier"], hp, graph["dp_src"],
                                      graph["dp_dst"], graph["dp_deg"],
                                      gs.n_drug)
    xd = params["embed"] if x_drug is None else x_drug @ params["embed"]
    if d_norm is not None:
        xd = xd / d_norm[:, None]
    x = torch.cat([xd, hd], dim=1) if cfg.mode == "cat" else xd + hd
    with trace.span("rgcn"):
        return rgcn_pair_on_layout(params["rgcn1"], params["rgcn2"], x, graph,
                                   gs, cfg.kernel_dtype, backend, mesh)


def _pp_encoder(params, x_prot, graph, cfg: ModelConfig, gs, backend: str):
    """The unsharded P-P GCN on the layout ``gs.pp_layout`` names."""
    if gs.pp_layout == "dense":
        return pp_encoder_apply_dense(params, x_prot, graph["pp_a1"],
                                      graph["pp_dinv"], backend)
    if gs.pp_layout == "windowed" and backend == "xla":
        return pp_encoder_apply(params, x_prot, graph["pp_norm_index"],
                                graph["pp_norm_weight"], gs.n_prot)
    if gs.pp_layout == "windowed":
        return pp_encoder_apply_windowed(params, x_prot, graph, gs,
                                         cfg.kernel_dtype)
    raise ValueError("the graph ships no P-P side: add the ring "
                     "(parallel/ring.py:add_ring_pp)")


def hier_encoder_init(gen, source_dim: int, embed_dim: int, target_dim: int,
                      device=None):
    return {
        "embed": init.normal(gen, (source_dim, embed_dim), device=device),
        "hier": hierarchy_conv_init(gen, embed_dim, target_dim,
                                    device=device),
    }


def hier_encoder_apply(params, graph, n_drug: int, x_src=None, x_norm=None):
    """Drug embeddings [n_drug, target_dim] from the protein embedding
    table (or ``x_src @ embed``) through the P->D mean hierarchy conv."""
    x = params["embed"] if x_src is None else x_src @ params["embed"]
    if x_norm is not None:
        x = x / x_norm[:, None]
    return hierarchy_conv_apply(params["hier"], x, graph["dp_src"],
                                graph["dp_dst"], graph["dp_deg"], n_drug)
