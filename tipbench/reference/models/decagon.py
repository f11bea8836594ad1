"""Decagon (Zitnik, Agrawal and Leskovec, Bioinformatics 34(13):i457, 2018;
github.com/mims-harvard/decagon, deep/layers.py, deep/model.py): a
multi-type graph convolution over the tri-graph, two layers, and the
DEDICOM decoder of the D-D relations.

    m_ij = l2norm_rows(sum_{r in rel(i, j)} A_hat_r X_j W_r)
    layer 1: H_i = relu(sum_j m_ij);  layer 2: Z_drug = sum_j m_drug,j

Each D-D relation's A_hat_r = D_r^-1/2 (A_r + I) D_r^-1/2 (its own self
loop and degree), the P-P one the GCN normalization, the drug-protein ones
rowsum^-1/2 A colsum^-1/2 in both directions; one-hot inputs, so layer 1's
W_r are tables.  DEDICOM scores relation t's (dst i, src j) as z_i D_t R
D_t z_j^T.  The loss covers the D-D relations alone, so layer 2 computes
the drug rows only.

Stated precision: the operand s_t Y_t of each D-D relation's contraction
rounded to bf16 where the traffic states bf16 operands for it ("rgcn"),
its gradient passing unrounded; the P-P GCN's as reference/model.py's
``gcn_layer`` rounds it ("pp_gcn").  The sums run in the order the
program's plain versions use (64 relations at a time; the drug-protein
edges in (drug, protein) order), so that on the CPU a bf16 rounding of
layer 2's operand cannot go the other way for round-off alone.
"""

from __future__ import annotations

import numpy as np
import torch

from tipbench.reference.model import bf16, gcn_layer

CHUNK = 64  # relations a step of the D-D contraction


def param_spec(config: dict, gs) -> list:
    """The program's parameter tree (tip_tpu_torch/models/decagon.py:
    DecagonModel.init at the commit that added this benchmark): the
    source's glorot initializers, a relation's diagonal a [h2, 1] column,
    on one-hot drug features."""
    if gs.drug_feat_dim:
        raise ValueError("the spec covers one-hot drug features")
    r, h1, h2 = gs.n_et, config["n_hid1"], config["n_hid2"]
    return [
        ("decoder/global", (h2, h2), "glorot", 0.0),
        ("decoder/local", (r, h2, 1), "glorot", 0.0),
        ("layer1/dd", (r, gs.n_drug, h1), "glorot", 0.0),
        ("layer1/dp", (gs.n_drug, h1), "glorot", 0.0),
        ("layer1/pd", (gs.n_prot, h1), "glorot", 0.0),
        ("layer1/pp", (gs.n_prot, h1), "glorot", 0.0),
        ("layer2/dd", (r, h1, h2), "glorot", 0.0),
        ("layer2/pd", (h1, h2), "glorot", 0.0),
    ]


def l2norm(x):
    """tf.nn.l2_normalize(x, dim=1)."""
    return x * torch.rsqrt(torch.clamp((x * x).sum(1, keepdim=True),
                                       min=1e-12))


class _Parts:
    """The D-D scales and the drug-protein edges of a reference graph."""

    def __init__(self, T):
        g = T.g
        n, r = g.n_drug, g.n_et
        deg = T.da.reshape(r, n, n).sum(2).cpu().numpy().astype(np.float64)
        self.s = torch.from_numpy((1.0 / np.sqrt(deg + 1.0)).astype(
            np.float32)).to(T.dev)
        dp = g.dp[:, np.lexsort((g.dp[0], g.dp[1]))]
        prot, drug = dp
        deg_d = np.bincount(drug, minlength=n).astype(np.float64)
        deg_p = np.bincount(prot, minlength=g.n_prot).astype(np.float64)
        self.w = torch.from_numpy((1.0 / np.sqrt(deg_d[drug] * deg_p[prot]))
                                  .astype(np.float32)).to(T.dev)
        self.prot = torch.from_numpy(prot).to(T.dev)
        self.drug = torch.from_numpy(drug).to(T.dev)


def _gather(x, src, dst, w, n_out):
    out = torch.zeros(n_out, x.shape[1], device=x.device)
    return out.index_add(0, dst, x.index_select(0, src) * w[:, None])


def dd_conv(T, prec, s, y):
    """sum_t s_t (A_t + I) (s_t y_t) over the count pages."""
    g = T.g
    n, r = g.n_drug, g.n_et
    out = None
    for c0 in range(0, r, CHUNK):
        c1 = min(c0 + CHUNK, r)
        sc = s[c0:c1, :, None]
        u = sc * y[c0:c1]
        if prec.rgcn_bf16:
            u = u + (bf16(u) - u).detach()
        da = T.da[c0:c1].reshape(-1, n, n)
        part = (sc * (prec.mm(da, u) + u)).sum(0)
        out = part if out is None else out + part
    return out


def encode(params, T, prec, mfirst: bool):
    p1, p2 = params["layer1"], params["layer2"]
    pt = _Parts(T)
    n, n_prot = T.g.n_drug, T.g.n_prot
    h_drug = torch.relu(l2norm(_gather(p1["pd"], pt.prot, pt.drug, pt.w, n))
                        + l2norm(dd_conv(T, prec, pt.s, p1["dd"])))
    h_prot = torch.relu(
        l2norm(gcn_layer(T, prec, p1["pp"], 0.0))
        + l2norm(_gather(p1["dp"], pt.drug, pt.prot, pt.w, n_prot)))
    y = prec.mm(h_drug, p2["dd"])  # [R, n, h2]
    return (l2norm(_gather(prec.mm(h_prot, p2["pd"]), pt.prot, pt.drug, pt.w,
                           n))
            + l2norm(dd_conv(T, prec, pt.s, y)))


def score(z, dec, src, dst, et, prec):
    """DEDICOM logits of (src, dst, relation) triples."""
    d = dec["local"][..., 0][et]
    return torch.sum(prec.mm(z[dst] * d, dec["global"]) * (z[src] * d), -1)


def dense_logits(z, dec, t0: int, t1: int, prec):
    """[t1 - t0, n, n] logits of relations t0..t1 (dst rows, src
    columns): ((z d_t) R) (z d_t)^T."""
    zd = z[None] * dec["local"][t0:t1, :, 0][:, None, :]
    return prec.mm(prec.mm(zd, dec["global"]), zd.transpose(1, 2))
