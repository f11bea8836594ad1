"""A plain reference of CompGCN (Vashishth et al., ICLR 2020; DistMult
score, ``mult`` composition, one layer) over the tri-graph as one
knowledge graph, for the port's tests: plain ``torch`` in float32 with
TF32 off, importing nothing of either package and no kernel.

From the graph's edges alone it works out the triples of both directions
(T: the D-D train edges (dst, r, src), the P-P train edges (dst, pp, src),
the drug-protein triples (drug, dp, protein); T^-1: each reversed under r +
K), each direction's head degrees and normalisations, the symmetric strip
estimator's cells, thresholds and hashed draws (the rules the port's
kernels are defined by, copied here), and computes the layer message by
message, the DistMult scores and the mean loss, the gradients by autograd.

Stated precision (the port's): the D-D messages' operand s x_t of each
drug rounded to bf16, its gradient passing unrounded (kernel B16's float32
backward); the P-P messages' operand s (x_t * z) rounded to bf16 by a cast,
whose backward rounds the gradient to bf16 (kernel B12's); products and
sums float32 elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
BLOCK = 128
EPS = 1e-5


# --- the estimator's draws and thresholds -----------------------------------


def _mul32(x, c):
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def u24(seed: int, rel: torch.Tensor, npad: int) -> torch.Tensor:
    """[len(rel), npad, npad] int64 draws of the padded plane's cells."""
    t = rel.to(torch.int64)
    key = mix32(((int(seed) & M32) + mix32((t + GOLDEN) & M32)) & M32)
    idx = torch.arange(npad, dtype=torch.int64)
    cell = idx[:, None] * npad + idx[None, :]
    return mix32(key[:, None, None] ^ mix32(cell)[None]) >> 8


def binom_tails(m, p) -> np.ndarray:
    """floor(P(X >= k) 2^24), k = 1..4, X ~ Binomial(m, p), [R, 4]."""
    pmf = np.exp(m * np.log1p(-p))
    cdf = pmf.copy()
    qs = []
    for k in range(1, 5):
        qs.append(1.0 - cdf)
        pmf = pmf * np.where((m >= k) & (p < 1.0),
                             (m - k + 1) / k * p / np.maximum(1.0 - p, 1e-300),
                             0.0)
        cdf = cdf + pmf
    q = np.clip(np.stack(qs, axis=1), 0.0, 1.0)
    return np.floor(q * (1 << 24)).astype(np.int64)


def thresholds_sym(counts: np.ndarray, n: int) -> np.ndarray:
    """[R, 8]: the single rate 1 / (n^2 - m_t) (diagonal blocks), then the
    doubled rate (the blocks that stand for a cell and its mirror)."""
    m = counts.astype(np.float64)
    nonpos = np.maximum(float(n) ** 2 - m, 1.0)
    return np.concatenate([binom_tails(m, 1.0 / nonpos),
                           binom_tails(m, np.minimum(2.0 / nonpos, 1.0))],
                          axis=1)


# --- the graph ---------------------------------------------------------------


class Graph:
    """The KG of the tri-graph: ``dd`` (src, dst, relation) [3, E] directed
    D-D train edges (each pair both ways), ``pp`` (src, dst) [2, E] P-P
    train edges (self loops dropped), ``dp`` (protein, drug) [2, E]."""

    def __init__(self, n_drug, n_prot, n_et, dd, pp, dp):
        self.n_drug, self.n_prot, self.n_et = n_drug, n_prot, n_et
        self.n = n_drug + n_prot
        self.k = n_et + 2
        src, dst, et = (np.asarray(x, np.int64) for x in dd)
        self.n_train = int(src.shape[0])
        flat = torch.from_numpy((et * n_drug + dst) * n_drug + src)
        self.pages = torch.bincount(
            flat, minlength=n_et * n_drug * n_drug).float().reshape(
                n_et, n_drug, n_drug)
        self.q = torch.from_numpy(thresholds_sym(
            np.bincount(et, minlength=n_et), n_drug))
        ps, pd = (np.asarray(x, np.int64) for x in pp)
        keep = ps != pd
        ps, pd = ps[keep], pd[keep]
        prot, drug = (np.asarray(x, np.int64) for x in dp)
        pp_rel, dp_rel = n_et, n_et + 1
        # T: (head, relation, tail); the tail's message goes to the head
        head = np.concatenate([dst, n_drug + pd, drug])
        rel = np.concatenate([et, np.full(pd.shape, pp_rel),
                              np.full(drug.shape, dp_rel)])
        tail = np.concatenate([src, n_drug + ps, n_drug + prot])
        self.dirs = []
        for h, t, r in ((head, tail, rel), (tail, head, rel + self.k)):
            deg = np.bincount(h, minlength=self.n).astype(np.float64)
            s = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)
            self.dirs.append({
                "head": torch.from_numpy(h), "tail": torch.from_numpy(t),
                "rel": torch.from_numpy(r),
                "s": torch.from_numpy(s.astype(np.float32))})


# --- the model ---------------------------------------------------------------


def bf16_st(x):
    """bf16 rounding whose gradient passes unrounded."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def bf16_cast(x):
    """bf16 rounding by a cast (its gradient rounded to bf16)."""
    return x.to(torch.bfloat16).float()


def aggregate(g: Graph, dirn: dict, x, rel, rounded: bool):
    """P [N, d] of one direction: s[h] * sum over its triples of the
    tail's operand s[t] x_t * z_r.  Where ``rounded``, each drug's D-D
    operand bf16(s x) and each protein's P-P operand bf16(s (x * z_pp)),
    rounded once a node (as the port's kernels take them); the
    drug-protein operand float32."""
    h, t, r, s = dirn["head"], dirn["tail"], dirn["rel"], dirn["s"]
    n_d, k = g.n_drug, g.k
    pp_r = int(r[0]) // k * k + g.n_et  # this direction's P-P relation
    msg = (s[t][:, None] * x[t]) * rel[r]
    if rounded:
        u_dd = bf16_st(s[:n_d, None] * x[:n_d])
        u_pp = bf16_cast(s[n_d:, None] * (x[n_d:] * rel[pp_r]))
        dd = (r % k) < g.n_et
        pp = (r % k) == g.n_et
        msg = torch.where(dd[:, None], u_dd[t.clamp(max=n_d - 1)] * rel[r],
                          msg)
        msg = torch.where(pp[:, None], u_pp[(t - n_d).clamp(min=0)], msg)
    out = torch.zeros(g.n, x.shape[1]).index_add(0, h, msg)
    return s[:, None] * out


def encode(g: Graph, p: dict, rounded: bool = True):
    """H's drug rows [n_drug, gcn_dim]; ``p`` the port's parameter tree
    (its BN scale as ``bn_scale_delta``, or as ``bn_scale`` itself)."""
    enc, rel = p["encoder"], p["decoder"]["rel"]
    x = enc["ent"]
    p_in = aggregate(g, g.dirs[0], x, rel, rounded)
    p_out = aggregate(g, g.dirs[1], x, rel, rounded)
    pre = (p_in @ enc["w_in"] + p_out @ enc["w_out"]
           + (x * enc["loop_rel"]) @ enc["w_loop"]) * (1.0 / 3.0)
    scale = (enc["bn_scale"] if "bn_scale" in enc
             else 1.0 + enc["bn_scale_delta"])
    xc = pre - pre.mean(0)
    var = (xc * xc).mean(0)
    h = torch.tanh(xc * torch.rsqrt(var + EPS) * scale + enc["bn_shift"])
    return h[:g.n_drug]


def weight(g: Graph, dec: dict):
    return dec["rel"][:g.n_et] @ dec["w_rel"]


def score(g: Graph, z, dec, src, dst, et):
    """DistMult logits of (src, dst, relation) triples."""
    return torch.sum(z[src] * z[dst] * weight(g, dec)[et], -1)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def loss_of(g: Graph, z, dec, seed: int):
    """Mean BCE of the symmetric strip estimator: the cells of the upper
    block triangle of the plane padded to 128, the diagonal blocks' cells
    at the single rate and weight 1, the others standing for a cell and
    its mirror at the doubled rate and weight 2, a cell's negatives C
    counted from its draw where it holds no positive."""
    n = g.n_drug
    npad = -(-n // BLOCK) * BLOCK
    logits = (z[None] * weight(g, dec)[:, None, :]) @ z.T  # [R, n, n]
    idx = torch.arange(n)
    br, bc = idx[:, None] // BLOCK, idx[None, :] // BLOCK
    diag, keep = (br == bc)[None], (br <= bc)[None]
    u = u24(seed, torch.arange(g.n_et), npad)[:, :n, :n]
    q = g.q
    cnt = sum((u < torch.where(diag, q[:, k, None, None],
                               q[:, 4 + k, None, None])).float()
              for k in range(4))
    da = g.pages
    cnt = torch.where((da > 0) | ~keep, 0.0, cnt)
    wgt = torch.where(diag, da, torch.where(keep, 2.0 * da, 0.0))
    sp = softplus(-logits)
    return torch.sum(sp * wgt + (sp + logits) * cnt) / float(g.n_train)


def loss(g: Graph, p: dict, seed: int, rounded: bool = True):
    return loss_of(g, encode(g, p, rounded), p["decoder"], seed)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def adam_step(params: dict, state: dict, lr: float, t: int,
              b1=0.9, b2=0.999, eps=1e-8) -> None:
    """torch.optim.Adam's update of every leaf's .grad, in place."""
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    with torch.no_grad():
        for path, x in leaves(params):
            m, v = state.setdefault(path, (torch.zeros_like(x),
                                           torch.zeros_like(x)))
            m.mul_(b1).add_(x.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(x.grad, x.grad, value=1 - b2)
            x.addcdiv_(m, v.sqrt() / c2 ** 0.5 + eps, value=-lr / c1)
