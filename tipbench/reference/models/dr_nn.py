"""DR-NN (the NYXFLOWER/TIP reference, model/ddm-nn.py; src/layers.py:598
``NNDecoder``): x = the drug embedding, two basis R-GCN layers and a final
ReLU, the NN decoder L = relu(z_s W1) . w1_t + relu(z_d W2) . w2_t."""

from __future__ import annotations

import math

import torch

from tipbench.reference.model import nn_hiddens, rgcn_pair


def param_spec(config: dict, gs) -> list:
    """The program's parameter tree (tip_tpu_torch/models/dd.py:
    DDModel.init at the commit that added this benchmark) for the NN
    decoder, as (path, shape, kind, scale) entries of lib/weights.py, on
    identity drug features."""
    if gs.drug_feat_dim:
        raise ValueError("the spec covers identity drug features")
    r, b, l1 = gs.n_et, config["num_base"], config["nn_decoder_l1_dim"]
    e, h1, h2 = config["n_embed"], config["n_hid1"], config["n_hid2"]
    return [
        ("decoder/w1_l1", (h2, l1), "normal", 1.0),
        ("decoder/w1_l2", (r, l1), "normal", 1 / math.sqrt(l1)),
        ("decoder/w2_l1", (h2, l1), "normal", 1.0),
        ("decoder/w2_l2", (r, l1), "normal", 1 / math.sqrt(l1)),
        ("embed", (gs.n_drug, e), "normal", 1.0),
        ("rgcn1/att", (r, b), "normal", 1 / math.sqrt(b)),
        ("rgcn1/basis", (b, e, h1), "normal", 1 / math.sqrt(e)),
        ("rgcn1/root", (e, h1), "normal", 1 / math.sqrt(e)),
        ("rgcn2/att", (r, b), "normal", 1 / math.sqrt(b)),
        ("rgcn2/basis", (b, h1, h2), "normal", 2.0 / h1),
        ("rgcn2/root", (h1, h2), "normal", 2.0 / h1),
    ]


def encode(params, T, prec, mfirst: bool):
    z = rgcn_pair(T, prec, params["rgcn1"], params["rgcn2"], params["embed"],
                  mfirst)
    return torch.relu(z)


def score(z, dec, src, dst, et, prec):
    """Logits of (src, dst, relation) triples."""
    h1, h2 = nn_hiddens(dec, z, prec)
    return (torch.sum(h1[src] * dec["w1_l2"][et], -1)
            + torch.sum(h2[dst] * dec["w2_l2"][et], -1))


def dense_logits(z, dec, t0: int, t1: int, prec):
    """[t1 - t0, n, n] logits of every pair of relations t0..t1 (dst
    rows, src columns)."""
    h1, h2 = nn_hiddens(dec, z, prec)
    s1 = prec.mm(h1, dec["w1_l2"][t0:t1].T)  # [n, Rb], src side
    s2 = prec.mm(h2, dec["w2_l2"][t0:t1].T)  # dst side
    return s2.T[:, :, None] + s1.T[:, None, :]
