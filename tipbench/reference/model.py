"""Plain PyTorch pieces of the TIP-class models' forward, loss, gradients
(autograd) and Adam, after the published layer equations (Xu, Sang and
Lu, arXiv:1908.06570; the NYXFLOWER/TIP reference, src/layers.py), in
float32.  Each model is a file ``tipbench/reference/models/<model>.py``
(its parameter tree, encoder, decoder), found by the configuration's
``model``; the layers it is built from are here:

  * P-P GCN, two layers: out = A_hat (x W) + b, A_hat = D^-1/2 (A+I) D^-1/2,
    identity protein features (layer 1's weight is the table), ReLU between;
  * P->D hierarchy: each drug's mean of its targets' protein embeddings,
    times W; drugs with no target get zeros;
  * two basis R-GCN layers, ReLU between: out[d] = (1 / deg[d])
    sum_t sum_{s in N_t(d)} x[s] W_t + x[d] root, W_t = sum_b att[t, b]
    basis_b, deg the in-degree over all relations;
  * the NN decoder's hiddens relu(z W1), relu(z W2).

The loss is the mean over the directed train edges of the BCE of the
positives plus the negatives the cell's estimator draws (``Estimator``):
the Poissonized dense estimators count a cell's negatives from its hashed
draw against Binomial tail thresholds; the sampled one draws a pair a
slot.  Gradients come from autograd, relation block by block.

Stated precision.  Where the traffic states bf16 operands for a product
(the dense P-P GCN's, and the dense R-GCN's on the strips: the JAX
package's default matmul precision), the reference rounds the same
operands to bf16 and accumulates in float32, at the points the traffic
names; every other product is float32 with TF32 off.  ``control`` =
"tf32" rounds the operands of every float32 product to TF32 (10 mantissa
bits, round to nearest even), the precision below the stated one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tipbench.lib.found import load_module
from tipbench.reference import draws
from tipbench.reference.graph import (
    Graph,
    negative_rates,
    pages,
    positive_keys,
    slot_layout,
)

BLOCK = 128  # the symmetric estimator's block edge (its cell plane pads to it)
REL_BLOCK = 32  # relations a block of the dense estimators


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (round to nearest even on 10 mantissa bits); the
    gradient passes to x unrounded, and the product's backward takes the
    rounded operands it saved."""
    b = x.detach().float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return x + (b.view(torch.float32) - x.detach())


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


@dataclass(frozen=True)
class Precision:
    pp_bf16: bool = False  # P-P GCN operand (dinv * x W) rounded to bf16
    rgcn_bf16: bool = False  # R-GCN M-first: att, M and x rounded to bf16
    control: str = "none"  # "tf32": every float32 product's operands

    def mm(self, a, b):
        if self.control == "tf32":
            a, b = tf32(a), tf32(b)
        return a @ b

    def ein(self, spec, a, b):
        if self.control == "tf32":
            a, b = tf32(a), tf32(b)
        return torch.einsum(spec, a, b)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class Tensors:
    """The reference graph's tensors on a device."""

    def __init__(self, g: Graph, device, need_pages: bool):
        self.g, self.dev = g, device

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        self.src, self.dst, self.et = (t(g.train[i]) for i in range(3))
        self.deg = torch.bincount(self.dst, minlength=g.n_drug).float()
        self.pp_src, self.pp_dst = t(g.pp[0]), t(g.pp[1])
        self.pp_dinv = t(g.pp_dinv.astype(np.float32))
        self.pp_w = t((g.pp_dinv[g.pp[0]] * g.pp_dinv[g.pp[1]])
                      .astype(np.float32))
        self.dp_p, self.dp_d = t(g.dp[0]), t(g.dp[1])
        self.dp_deg = torch.bincount(self.dp_d, minlength=g.n_drug).float()
        self.da = pages(g, device) if need_pages else None


def _mean(summed, deg):
    inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0),
                      torch.zeros_like(deg))
    return summed * inv[:, None]


def gcn_layer(T: Tensors, prec: Precision, h, bias):
    """A_hat h + b over the edge list (self loops included)."""
    n = T.g.n_prot
    if prec.pp_bf16:
        u = bf16(h * T.pp_dinv[:, None])
        agg = torch.zeros(n, h.shape[1], device=h.device).index_add(
            0, T.pp_dst, u.index_select(0, T.pp_src))
        return agg * T.pp_dinv[:, None] + bias
    msg = h.index_select(0, T.pp_src) * T.pp_w[:, None]
    return torch.zeros(n, h.shape[1], device=h.device).index_add(
        0, T.pp_dst, msg) + bias


def hierarchy(T: Tensors, prec: Precision, hp, weight):
    summed = torch.zeros(T.g.n_drug, hp.shape[1], device=hp.device).index_add(
        0, T.dp_d, hp.index_select(0, T.dp_p))
    return prec.mm(_mean(summed, T.dp_deg), weight)


def rgcn_edges(T: Tensors, prec: Precision, p, x):
    """One R-GCN layer over the edge list, float32."""
    n, r = T.g.n_drug, T.g.n_et
    seg = T.et * n + T.dst
    nb = torch.zeros(r * n, x.shape[1], device=x.device).index_add(
        0, seg, x.index_select(0, T.src)).reshape(r, n, -1)
    q = prec.ein("tb,tnd->bnd", p["att"], nb)
    agg = prec.ein("bnd,bde->ne", q, p["basis"])
    return _mean(agg, T.deg) + prec.mm(x, p["root"])


def rgcn_pair_mfirst(T: Tensors, prec: Precision, p1, p2, x):
    """Both R-GCN layers from M = att_cat^T DA (one contraction over the
    relations), then M_b x; the bf16 operand rounding of the stated
    precision at att, M and x."""
    r, n = T.g.n_et, T.g.n_drug
    att = torch.cat([p1["att"], p2["att"]], dim=1)
    b1 = p1["att"].shape[1]
    rnd = bf16 if prec.rgcn_bf16 else (lambda v: v)
    m = prec.mm(rnd(att).T, T.da).reshape(-1, n, n)

    def layer(p, mh, h):
        qd = prec.mm(rnd(mh), rnd(h))
        agg = prec.ein("bdf,bfe->de", qd, p["basis"])
        return _mean(agg, T.deg) + prec.mm(h, p["root"])

    h = torch.relu(layer(p1, m[:b1], x))
    return layer(p2, m[b1:], h)


def rgcn_pair(T: Tensors, prec: Precision, p1, p2, x, mfirst: bool):
    """Both R-GCN layers, ReLU between: M-first where the stated
    precision's bf16 rounding points are defined (on the strips), else
    over the edge list."""
    if mfirst:
        return rgcn_pair_mfirst(T, prec, p1, p2, x)
    return rgcn_edges(T, prec, p2, torch.relu(rgcn_edges(T, prec, p1, x)))


def model_of(name: str):
    """The module tipbench/reference/models/<name>.py: ``param_spec``,
    ``encode``, ``score`` and ``dense_logits`` of one model."""
    return load_module("reference/models", name)


def nn_hiddens(dec, z, prec: Precision):
    return (torch.relu(prec.mm(z, dec["w1_l1"])),
            torch.relu(prec.mm(z, dec["w2_l1"])))


class Estimator:
    """The loss sum of one step over the cells or slots of the cell's
    estimator: "sym" (the symmetric strips' Poissonized field: cells of the
    upper block triangle of the plane padded to 128, the diagonal blocks at
    the single rate, the others standing for a cell and its mirror at the
    doubled rate and twice the positive weight), "full" (every cell of the
    n x n plane, single rate, three draws), "sampled" (one drawn pair a
    slot of the chunk-aligned buffer)."""

    def __init__(self, kind: str, T: Tensors, chunk: int = 1024):
        self.kind, self.T = kind, T
        g = T.g
        dev = T.dev
        if kind in ("sym", "full"):
            self.q = torch.from_numpy(negative_rates(g, kind == "sym")).to(dev)
        if kind == "sampled":
            self.keys = positive_keys(g, dev)
            self.ct, self.valid = slot_layout(g, chunk, dev)
            self.chunk = chunk

    def _plane(self, t0, t1, seed):
        """(da, weight, count) [Rb, n, n] of relations t0..t1."""
        T, n = self.T, self.T.g.n_drug
        dev = T.dev
        rel = torch.arange(t0, t1, device=dev)
        idx = torch.arange(n, device=dev)
        da = T.da[t0:t1].reshape(-1, n, n)
        q = self.q[t0:t1]
        if self.kind == "full":
            u = draws.u24(seed, rel, idx, idx, n)
            cnt = sum((u < q[:, k, None, None]).float() for k in range(3))
            return da, da, torch.where(da > 0, 0.0, cnt)
        npad = -(-n // BLOCK) * BLOCK
        u = draws.u24(seed, rel, idx, idx, npad)
        br, bc = idx[:, None] // BLOCK, idx[None, :] // BLOCK
        diag, keep = (br == bc)[None], (br <= bc)[None]
        cnt = sum((u < torch.where(diag, q[:, k, None, None],
                                   q[:, 4 + k, None, None])).float()
                  for k in range(4))
        cnt = torch.where((da > 0) | ~keep, 0.0, cnt)
        wgt = torch.where(diag, da, torch.where(keep, 2.0 * da, 0.0))
        return da, wgt, cnt

    def loss_sum(self, model, z, dec, seed: int, prec: Precision,
                 scale: float):
        """The loss sum times ``scale``, its gradients added into ``z``'s
        and ``dec``'s leaves block by block (``z`` a leaf); ``model`` the
        model's module (:func:`model_of`)."""
        total = torch.zeros((), dtype=torch.float64, device=z.device)
        if self.kind == "sampled":
            part = self._sampled(model, z, dec, seed, prec) * scale
            part.backward()
            return part.detach().double()
        r = self.T.g.n_et
        for t0 in range(0, r, REL_BLOCK):
            t1 = min(t0 + REL_BLOCK, r)
            with torch.no_grad():
                _, wgt, cnt = self._plane(t0, t1, seed)
            logits = model.dense_logits(z, dec, t0, t1, prec)
            sp = softplus(-logits)
            part = torch.sum(sp * wgt + (sp + logits) * cnt) * scale
            part.backward()
            total += part.detach().double()
        return total

    def _sampled(self, model, z, dec, seed, prec):
        T, n = self.T, self.T.g.n_drug
        g = T.g

        def is_positive(rel, pair):
            key = rel * (n * n) + pair
            at = torch.searchsorted(self.keys, key.reshape(-1)).clamp(
                max=self.keys.numel() - 1)
            return (self.keys[at] == key.reshape(-1)).reshape(key.shape)

        pair = draws.sampled_pairs(seed, self.ct, self.chunk, is_positive, n)
        rel = self.ct[:, None].expand_as(pair)[self.valid]
        pair = pair[self.valid]
        neg = model.score(z, dec, pair % n, pair // n, rel, prec)
        pos = model.score(z, dec, T.src, T.dst, T.et, prec)
        if not pos.shape[0] == neg.shape[0] == g.n_train:
            raise ValueError(f"{pos.shape[0]} positives, {neg.shape[0]} "
                             f"negatives, {g.n_train} train edges")
        return torch.sum(softplus(-pos)) + torch.sum(softplus(neg))


def leaves(tree, prefix=""):
    """[(path, tensor)] in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


class Adam:
    """torch.optim.Adam's update (eps outside the bias-corrected root)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.p = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(x) for x in params]
        self.v = [torch.zeros_like(x) for x in params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.p, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)
