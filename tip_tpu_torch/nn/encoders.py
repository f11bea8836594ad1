"""Tri-graph encoder, dense-strip branch (port of tip_tpu/nn/encoders.py:36,
51, 80 and the dense branches of 100-194).

P-P: two dense GCN layers over the int8 (A+I); P->D: the mean hierarchy
conv; the drug embedding joined by concatenation (TIP-cat) or sum
(TIP-add); D-D: both R-GCN layers from one M-first contraction over the
symmetric strips.  Graphs without the dense P-P matrix or the strips take
the COO / chunked paths of the JAX package, which this package does not
have yet: it raises for them.
"""

from __future__ import annotations

import torch

from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.nn.gcn import gcn_conv_apply_dense, gcn_conv_init
from tip_tpu_torch.nn.hierarchy import hierarchy_conv_apply, hierarchy_conv_init
from tip_tpu_torch.nn.rgcn import dense_rgcn_pair_apply_sym, rgcn_init
from tip_tpu_torch.ops.matmul import bf16_round


def pp_encoder_init(gen, in_dim: int, hid1: int = 32, hid2: int = 16,
                    device=None):
    return {
        "conv1": gcn_conv_init(gen, in_dim, hid1, device=device),
        "conv2": gcn_conv_init(gen, hid1, hid2, device=device),
    }


def pp_encoder_apply_dense(params, x_prot, a1, dinv):
    """Two dense GCN layers; the int8 (A+I) is upcast once for both."""
    a1f = bf16_round(a1)
    h = torch.relu(gcn_conv_apply_dense(params["conv1"], x_prot, a1f, dinv))
    return gcn_conv_apply_dense(params["conv2"], h, a1f, dinv)


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
                     x_prot=None, d_norm=None):
    """Final drug embeddings z [n_drug, n_hid2]."""
    missing = [k for k in ("pp_a1", "pp_dinv", "dd_adj_sym") if k not in graph]
    if missing:
        raise NotImplementedError(
            f"graph lacks {missing}: the COO P-P and chunked/full-page D-D "
            "paths are later slices of the port")
    hp = pp_encoder_apply_dense(params["pp"], x_prot, graph["pp_a1"],
                                graph["pp_dinv"])
    hd = hierarchy_conv_apply(params["hier"], hp, graph["dp_src"],
                              graph["dp_dst"], graph["dp_deg"], gs.n_drug)
    xd = params["embed"] if x_drug is None else x_drug @ params["embed"]
    if d_norm is not None:
        xd = xd / d_norm[:, None]
    x = torch.cat([xd, hd], dim=1) if cfg.mode == "cat" else xd + hd
    return dense_rgcn_pair_apply_sym(params["rgcn1"], params["rgcn2"], x,
                                     graph["dd_adj_sym"], graph["dd_deg"])
