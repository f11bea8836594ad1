"""TIP-cat (the NYXFLOWER/TIP reference, tip.py:14; Xu, Sang and Lu,
arXiv:1908.06570): the P-P GCN, the P->D hierarchy, x = [drug embedding |
hierarchy output], two basis R-GCN layers, the DistMult decoder
L = z_s . (w_t * z_d)."""

from __future__ import annotations

import math

import torch

from tipbench.reference.model import gcn_layer, hierarchy, rgcn_pair


def param_spec(config: dict, gs) -> list:
    """The program's parameter tree (tip_tpu_torch/nn/encoders.py:
    fm_encoder_init, nn/decoders.py:distmult_init at the commit that added
    this benchmark) as (path, shape, kind, scale) entries of
    lib/weights.py, on identity drug features."""
    if gs.drug_feat_dim:
        raise ValueError("the spec covers identity drug features")
    d_in = config["n_embed"] + config["prot_drug_dim"]
    r, b = gs.n_et, config["num_base"]
    h1, h2 = config["n_hid1"], config["n_hid2"]
    p1, p2 = config["pp_hid1"], config["pp_hid2"]
    return [
        ("decoder/weight", (r, h2), "normal", 1 / math.sqrt(h2)),
        ("encoder/embed", (gs.n_drug, config["n_embed"]), "normal", 1.0),
        ("encoder/hier/weight", (p2, config["prot_drug_dim"]), "normal",
         1 / math.sqrt(p2)),
        ("encoder/pp/conv1/bias", (p1,), "zeros", 0.0),
        ("encoder/pp/conv1/weight", (gs.n_prot, p1), "glorot", 0.0),
        ("encoder/pp/conv2/bias", (p2,), "zeros", 0.0),
        ("encoder/pp/conv2/weight", (p1, p2), "glorot", 0.0),
        ("encoder/rgcn1/att", (r, b), "normal", 1 / math.sqrt(b)),
        ("encoder/rgcn1/basis", (b, d_in, h1), "normal", 1 / math.sqrt(d_in)),
        ("encoder/rgcn1/root", (d_in, h1), "normal", 1 / math.sqrt(d_in)),
        ("encoder/rgcn2/att", (r, b), "normal", 1 / math.sqrt(b)),
        ("encoder/rgcn2/basis", (b, h1, h2), "normal", 2.0 / h1),
        ("encoder/rgcn2/root", (h1, h2), "normal", 2.0 / h1),
    ]


def encode(params, T, prec, mfirst: bool):
    enc = params["encoder"]
    pp = enc["pp"]
    h = torch.relu(gcn_layer(T, prec, pp["conv1"]["weight"],
                             pp["conv1"]["bias"]))
    hp = gcn_layer(T, prec, prec.mm(h, pp["conv2"]["weight"]),
                   pp["conv2"]["bias"])
    hd = hierarchy(T, prec, hp, enc["hier"]["weight"])
    x = torch.cat([enc["embed"], hd], dim=1)
    return rgcn_pair(T, prec, enc["rgcn1"], enc["rgcn2"], x, mfirst)


def score(z, dec, src, dst, et, prec):
    """Logits of (src, dst, relation) triples."""
    return torch.sum(z[src] * z[dst] * dec["weight"][et], -1)


def dense_logits(z, dec, t0: int, t1: int, prec):
    """[t1 - t0, n, n] logits of every pair of relations t0..t1 (dst
    rows, src columns; DistMult is symmetric)."""
    zw = z[None] * dec["weight"][t0:t1, None, :]
    return prec.mm(zw, z.T)
