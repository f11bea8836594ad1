"""CompGCN (Vashishth, Sanyal, Nitin and Talukdar, ICLR 2020,
arXiv:1911.03082; github.com/malllabiisc/CompGCN): one composition-based
layer, ``mult`` composition, DistMult score, over the tri-graph as one
knowledge graph of K = R + 2 relations (the R D-D relations, P-P, D-P).

    P_d = sum_{(h, r, t) in T_d} deg_d(h)^-1/2 deg_d(t)^-1/2 (x_t * z_r)
    H   = tanh(BN((P_in W_I + P_out W_O + (X * z_loop) W_S) / 3))
    score(i, r, j) = sum_k H_ik (Z W_rel)_rk H_jk

T holds the D-D train edges (dst, r, src) (each pair both ways), the P-P
train edges (dst, pp, src) (both ways, no self loop) and the drug-protein
triples (drug, dp, protein); T^-1 each reversed under r + K; deg_d(v)
counts the triples of direction d whose head is v (a zero degree gives a
zero factor).  BN over all entity rows with batch statistics, eps 1e-5,
its scale 1 + ``bn_scale_delta``.  The loss covers the D-D relations.

Everything is worked out from the raw edges of the reference graph: the
triples, the degrees and the normalisations; the D-D messages as the
relations' count pages (built from the same edges) times the drugs'
operand, 32 relations at a time, the P-P and drug-protein messages edge by
edge.  Stated precision: each drug's D-D operand s x rounded to bf16 where
the traffic states bf16 operands for it ("rgcn"), its gradient passing
unrounded; each protein's P-P operand s (x * z_pp) rounded to bf16 by a
cast where the traffic states it ("pp_gcn"), its gradient rounded to bf16;
every product float32 with TF32 off (``prec.mm``: TF32 operands under the
control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tipbench.reference.model import bf16

BLOCK = 32  # D-D relations a step of the messages
EPS = 1e-5


def param_spec(config: dict, gs) -> list:
    """The program's parameter tree (tip_tpu_torch/models/compgcn.py:
    CompGCNModel.init at the commit that added this cell): xavier-normal
    matrices (N(0, 2 / (fan_in + fan_out)), a [a, b] tensor's fans b and
    a), BN's scale offset and shift zero."""
    if gs.drug_feat_dim:
        raise ValueError("CompGCN learns its entity table")
    d0, d1 = config["init_dim"], config["gcn_dim"]
    n, k = gs.n_drug + gs.n_prot, gs.n_et + 2

    def xavier(path, *shape):
        return (path, shape, "normal", math.sqrt(2.0 / sum(shape)))

    return [
        xavier("decoder/rel", 2 * k, d0),
        xavier("decoder/w_rel", d0, d1),
        ("encoder/bn_scale_delta", (d1,), "zeros", 0.0),
        ("encoder/bn_shift", (d1,), "zeros", 0.0),
        xavier("encoder/ent", n, d0),
        xavier("encoder/loop_rel", 1, d0),
        xavier("encoder/w_in", d0, d1),
        xavier("encoder/w_loop", d0, d1),
        xavier("encoder/w_out", d0, d1),
    ]


def _scales(deg: np.ndarray, dev) -> torch.Tensor:
    deg = deg.astype(np.float64)
    s = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)
    return torch.from_numpy(s.astype(np.float32)).to(dev)


class _KG:
    """The triples' degrees and edges of a reference graph."""

    def __init__(self, T):
        g = T.g
        n_d, n_p = g.n_drug, g.n_prot
        keep = g.pp[0] != g.pp[1]
        ps, pd = g.pp[0][keep], g.pp[1][keep]
        prot, drug = g.dp
        dd = np.bincount(g.train[1], minlength=n_d)
        pp = np.bincount(pd, minlength=n_p)
        dp_d = np.bincount(drug, minlength=n_d)
        dp_p = np.bincount(prot, minlength=n_p)
        self.s_in = _scales(np.concatenate([dd + dp_d, pp]), T.dev)
        self.s_out = _scales(np.concatenate([dd, pp + dp_p]), T.dev)

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(T.dev)

        self.pp_src, self.pp_dst = t(ps), t(pd)
        self.dp_prot, self.dp_drug = t(prot), t(drug)


def _dd(T, prec, kg_s, x_d, z):
    """s sum_r (A_r U) * z_r over the count pages, U = s x_d."""
    g = T.g
    n, r = g.n_drug, g.n_et
    s = kg_s[:n, None]
    u = s * x_d
    if prec.rgcn_bf16:
        u = u + (bf16(u) - u).detach()
    out = None
    for t0 in range(0, r, BLOCK):
        t1 = min(t0 + BLOCK, r)
        da = T.da[t0:t1].reshape(-1, n, n)
        part = (prec.mm(da, u) * z[t0:t1, None, :]).sum(0)
        out = part if out is None else out + part
    return s * out


def _pp(T, prec, kg, kg_s, x_p, z_pp):
    """s sum over the P-P triples of the tail's operand s (x * z_pp)."""
    n_d = T.g.n_drug
    s = kg_s[n_d:, None]
    u = s * (x_p * z_pp)
    if prec.pp_bf16:
        u = bf16(u)
    out = torch.zeros_like(u).index_add(0, kg.pp_dst,
                                        u.index_select(0, kg.pp_src))
    return s * out


def encode(params, T, prec, mfirst: bool):
    """H's drug rows [n_drug, gcn_dim]."""
    g = T.g
    n_d, r = g.n_drug, g.n_et
    k = r + 2
    kg = _KG(T)
    enc, rel = params["encoder"], params["decoder"]["rel"]
    x = enc["ent"]
    x_d, x_p = x[:n_d], x[n_d:]
    dd_in = _dd(T, prec, kg.s_in, x_d, rel[:r])
    dd_out = _dd(T, prec, kg.s_out, x_d, rel[k:k + r])
    pp_in = _pp(T, prec, kg, kg.s_in, x_p, rel[r])
    pp_out = _pp(T, prec, kg, kg.s_out, x_p, rel[k + r])
    w_in = (kg.s_in[kg.dp_drug] * kg.s_in[n_d + kg.dp_prot])[:, None]
    w_out = (kg.s_out[n_d + kg.dp_prot] * kg.s_out[kg.dp_drug])[:, None]
    to_d = torch.zeros_like(x_d).index_add(
        0, kg.dp_drug, w_in * (x_p.index_select(0, kg.dp_prot) * rel[r + 1]))
    to_p = torch.zeros_like(x_p).index_add(
        0, kg.dp_prot,
        w_out * (x_d.index_select(0, kg.dp_drug) * rel[k + r + 1]))
    p_in = torch.cat([dd_in + to_d, pp_in])
    p_out = torch.cat([dd_out, pp_out + to_p])
    pre = (prec.mm(p_in, enc["w_in"]) + prec.mm(p_out, enc["w_out"])
           + prec.mm(x * enc["loop_rel"], enc["w_loop"])) * (1.0 / 3.0)
    xc = pre - pre.mean(0)
    var = (xc * xc).mean(0)
    h = torch.tanh(xc * torch.rsqrt(var + EPS) * (1.0 + enc["bn_scale_delta"])
                   + enc["bn_shift"])
    return h[:n_d]


def _weight(dec, t0: int, t1: int, prec):
    """DistMult's rows of relations t0..t1: (Z W_rel)[t0:t1]."""
    return prec.mm(dec["rel"][t0:t1], dec["w_rel"])


def score(z, dec, src, dst, et, prec):
    """DistMult logits of (src, dst, relation) triples."""
    r = dec["rel"].shape[0] // 2 - 2
    return torch.sum(z[src] * z[dst] * _weight(dec, 0, r, prec)[et], -1)


def dense_logits(z, dec, t0: int, t1: int, prec):
    """[t1 - t0, n, n] logits of relations t0..t1 (dst rows, src columns;
    DistMult is symmetric)."""
    zw = z[None] * _weight(dec, t0, t1, prec)[:, None, :]
    return prec.mm(zw, z.T)
