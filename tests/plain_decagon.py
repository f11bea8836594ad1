"""A plain reference of Decagon (Zitnik, Agrawal and Leskovec 2018) for the
port's tests: plain ``torch`` in float32 with TF32 off, importing nothing
of either package and no kernel.

From the graph's edges alone it works out the normalisations (each D-D
relation's D^-1/2 (A + I) D^-1/2, the P-P one, the drug-protein
rowsum^-1/2 A colsum^-1/2), the count pages, the Poissonized estimator's
thresholds and its hashed cell draws (the rules the port's kernels are
defined by, copied here), and computes the encoder, the DEDICOM scores and
the mean loss, the gradients by autograd and Adam's step.

Stated precision (the port's default): the operand s_t Y_t of each D-D
relation's contraction and the P-P GCN's operand D^-1/2 X W rounded to
bf16, products and sums float32.  The D-D rounding passes the gradient
through unrounded (the kernel's float32 backward); the P-P rounding is a
cast, whose backward rounds the gradient to bf16 (as the port's does).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


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


def u24(seed: int, rel: torch.Tensor, n: int) -> torch.Tensor:
    """[len(rel), n, n] int64 draws below 2^24 of relation rel's cells
    (row, col), keyed by the low 32 bits of ``seed``."""
    t = rel.to(torch.int64)
    key = mix32(((int(seed) & M32) + mix32((t + GOLDEN) & M32)) & M32)
    idx = torch.arange(n, dtype=torch.int64)
    cell = idx[:, None] * n + idx[None, :]
    return mix32(key[:, None, None] ^ mix32(cell)[None]) >> 8


def thresholds(counts: np.ndarray, n: int) -> np.ndarray:
    """[R, 3] int64 floor(P(X >= k) 2^24), k = 1..3, X ~ Binomial(m_t,
    1 / (n^2 - m_t)), m_t the relation's directed train edges."""
    m = counts.astype(np.float64)
    p = 1.0 / np.maximum(float(n) ** 2 - m, 1.0)
    pmf = np.exp(m * np.log1p(-p))
    cdf = pmf.copy()
    qs = []
    for k in range(1, 4):
        qs.append(1.0 - cdf)
        pmf = pmf * np.where(m >= k, (m - k + 1) / k * p / (1.0 - p), 0.0)
        cdf = cdf + pmf
    q = np.clip(np.stack(qs, axis=1), 0.0, 1.0)
    return np.floor(q * (1 << 24)).astype(np.int64)


# --- the graph ---------------------------------------------------------------


class Graph:
    """The tri-graph's normalised adjacencies from its edges: ``dd``
    (src, dst, relation) [3, E] directed D-D train edges; ``pp`` (src, dst)
    [2, E] P-P train edges with the self loops; ``dp`` (protein, drug)
    [2, E], summed in (drug, protein) order."""

    def __init__(self, n_drug, n_prot, n_et, dd, pp, dp):
        self.n_drug, self.n_prot, self.n_et = n_drug, n_prot, n_et
        src, dst, et = (np.asarray(x, np.int64) for x in dd)
        self.n_train = int(src.shape[0])
        flat = torch.from_numpy((et * n_drug + dst) * n_drug + src)
        self.pages = torch.bincount(flat, minlength=n_et * n_drug * n_drug) \
            .float().reshape(n_et, n_drug, n_drug)  # [t, dst, src]
        deg = np.bincount(et * n_drug + dst, minlength=n_et * n_drug)
        self.s = torch.from_numpy((1.0 / np.sqrt(deg + 1.0)).astype(
            np.float32).reshape(n_et, n_drug))
        self.q = torch.from_numpy(thresholds(np.bincount(et, minlength=n_et),
                                             n_drug))
        ps, pd = (torch.as_tensor(np.asarray(x, np.int64)) for x in pp)
        self.pp = torch.zeros(n_prot, n_prot)
        self.pp[pd, ps] = 1.0  # (A + I)[dst, src]
        pdeg = self.pp.double().sum(1).numpy()
        self.pp_dinv = torch.from_numpy((1.0 / np.sqrt(pdeg)).astype(
            np.float32))
        dp = np.asarray(dp, np.int64)
        dp = dp[:, np.lexsort((dp[0], dp[1]))]
        prot, drug = dp
        deg_d = np.bincount(drug, minlength=n_drug).astype(np.float64)
        deg_p = np.bincount(prot, minlength=n_prot).astype(np.float64)
        self.dp_w = torch.from_numpy(
            (1.0 / np.sqrt(deg_d[drug] * deg_p[prot])).astype(np.float32))
        self.dp_prot, self.dp_drug = torch.from_numpy(prot), torch.from_numpy(
            drug)

    def to_drugs(self, x):
        """rowsum^-1/2 A colsum^-1/2 x over the drug-protein edges."""
        out = torch.zeros(self.n_drug, x.shape[1])
        return out.index_add(0, self.dp_drug, x.index_select(
            0, self.dp_prot) * self.dp_w[:, None])

    def to_proteins(self, x):
        out = torch.zeros(self.n_prot, x.shape[1])
        return out.index_add(0, self.dp_prot, x.index_select(
            0, self.dp_drug) * self.dp_w[:, None])


# --- the model ---------------------------------------------------------------


def l2norm(x):
    return x * torch.rsqrt(torch.clamp((x * x).sum(1, keepdim=True),
                                       min=1e-12))


def bf16_st(x):
    return x + (x.to(torch.bfloat16).float() - x).detach()


def dd_conv(g: Graph, y, rounded: bool):
    """sum_t s_t (A_t + I) (s_t y_t), operands bf16 where ``rounded``,
    64 relations at a time."""
    out = None
    for c0 in range(0, g.n_et, 64):
        s = g.s[c0:c0 + 64, :, None]
        u = s * y[c0:c0 + 64]
        if rounded:
            u = bf16_st(u)
        part = (s * (g.pages[c0:c0 + 64] @ u + u)).sum(0)
        out = part if out is None else out + part
    return out


def pp_conv(g: Graph, table, rounded: bool):
    dinv = g.pp_dinv[:, None]
    u = table * dinv
    if rounded:
        u = u.to(torch.bfloat16).float()
    return dinv * (g.pp @ u)


def encode(g: Graph, p: dict, dd_bf16: bool = True, pp_bf16: bool = True):
    """Drug embeddings z [n_drug, h2]; ``p`` the port's parameter tree;
    the operands of the D-D and P-P contractions rounded to bf16 where the
    flags say."""
    p1, p2 = p["layer1"], p["layer2"]
    h_drug = torch.relu(l2norm(g.to_drugs(p1["pd"]))
                        + l2norm(dd_conv(g, p1["dd"], dd_bf16)))
    h_prot = torch.relu(l2norm(pp_conv(g, p1["pp"], pp_bf16))
                        + l2norm(g.to_proteins(p1["dp"])))
    y = torch.matmul(h_drug, p2["dd"])
    return (l2norm(g.to_drugs(h_prot @ p2["pd"]))
            + l2norm(dd_conv(g, y, dd_bf16)))


def dense_logits(z, dec):
    """[R, n, n] logits, rows dst, columns src."""
    dvec = dec["local"][..., 0]
    zd = z[None] * dvec[:, None, :]
    return (zd @ dec["global"]) @ zd.transpose(1, 2)


def score(z, dec, src, dst, et):
    d = dec["local"][..., 0][et]
    return torch.sum(((z[dst] * d) @ dec["global"]) * (z[src] * d), -1)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def loss(g: Graph, p: dict, seed: int, dd_bf16: bool = True,
         pp_bf16: bool = True):
    """Mean BCE over the train edges and the Poissonized negatives of every
    cell: softplus(-L) on a positive, C (softplus(-L) + L) elsewhere."""
    logits = dense_logits(encode(g, p, dd_bf16, pp_bf16), p["decoder"])
    u = u24(seed, torch.arange(g.n_et), g.n_drug)
    cnt = sum((u < g.q[:, k, None, None]).float() for k in range(3))
    cnt = torch.where(g.pages > 0, 0.0, cnt)
    sp = softplus(-logits)
    return torch.sum(sp * g.pages + (sp + logits) * cnt) / float(g.n_train)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def adam_step(params: dict, state: dict, lr: float, t: int,
              b1=0.9, b2=0.999, eps=1e-8) -> None:
    """torch.optim.Adam's update of every leaf's .grad, in place (``state``
    holds the moments; ``t`` the step, from 1)."""
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    with torch.no_grad():
        for path, x in leaves(params):
            m, v = state.setdefault(path, (torch.zeros_like(x),
                                           torch.zeros_like(x)))
            m.mul_(b1).add_(x.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(x.grad, x.grad, value=1 - b2)
            x.addcdiv_(m, v.sqrt() / c2 ** 0.5 + eps, value=-lr / c1)
