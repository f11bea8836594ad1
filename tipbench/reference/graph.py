"""The training graph worked out again from the raw tri-graph.

Plain numpy and torch, from the definitions and not from the program's
packing: the per-relation 90/10 split of unique drug pairs, both
directions of every kept pair; the P-P split and the GCN normalization
D^-1/2 (A + I) D^-1/2; the in-degrees; the dense count pages
DA[t, dst, src]; the Poissonized negative rates of the dense estimators;
the chunk-aligned slot layout the sampled estimator draws over.  The
split and the thresholds are frozen copies of the rules they are defined
by (tip_tpu_torch/data/packing.py: ``split_typed_edges``,
``split_pp_edges``, ``gcn_normalize``, ``_binom_tail_thresholds``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Graph:
    n_drug: int
    n_prot: int
    n_et: int
    train: np.ndarray  # [3, E] (src, dst, relation), both directions
    test: np.ndarray  # [3, E_test]
    pp: np.ndarray  # [2, E_pp] (src, dst) train P-P edges with self loops
    pp_dinv: np.ndarray  # [n_prot] float64, 1 / sqrt(degree with self loop)
    dp: np.ndarray  # [2, E_dp] (protein, drug)

    @property
    def n_train(self) -> int:
        return int(self.train.shape[1])

    def train_counts(self) -> np.ndarray:
        return np.bincount(self.train[2], minlength=self.n_et)

    def test_counts(self) -> np.ndarray:
        return np.bincount(self.test[2], minlength=self.n_et)


def _both(pairs: np.ndarray) -> np.ndarray:
    return np.concatenate([pairs, pairs[::-1]], axis=1)


def split_dd(pair_list, rate: float, seed: int):
    """(train, test) [3, E] of directed edges: a Bernoulli(rate) draw a
    unique pair, relation by relation from one generator."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for t, pairs in enumerate(pair_list):
        keep = rng.random(pairs.shape[1]) < rate
        for out, part in ((train, pairs[:, keep]), (test, pairs[:, ~keep])):
            e = _both(part.astype(np.int64))
            out.append(np.concatenate([e, np.full((1, e.shape[1]), t)]))
    return np.concatenate(train, axis=1), np.concatenate(test, axis=1)


def build(raw, rate: float, seed: int) -> Graph:
    train, test = split_dd(raw.dd_pair_list, rate, seed)
    pp = raw.pp_edge_index.astype(np.int64)
    pairs = pp[:, pp[0] > pp[1]]
    keep = np.random.default_rng(seed + 7).random(pairs.shape[1]) < rate
    loops = np.tile(np.arange(raw.n_prot, dtype=np.int64), (2, 1))
    pp_train = np.concatenate([_both(pairs[:, keep]), loops], axis=1)
    deg = np.bincount(pp_train[1], minlength=raw.n_prot).astype(np.float64)
    return Graph(n_drug=raw.n_drug, n_prot=raw.n_prot,
                 n_et=len(raw.dd_pair_list), train=train, test=test,
                 pp=pp_train, pp_dinv=1.0 / np.sqrt(deg),
                 dp=raw.dp_edge_index.astype(np.int64))


def binom_tails(m, p, kmax: int) -> np.ndarray:
    """floor(P(X >= k) 2^24), k = 1..kmax, X ~ Binomial(m, p), [R, kmax]."""
    m = np.asarray(m, np.float64)
    p = np.asarray(p, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmf = np.exp(m * np.log1p(-p))
        cdf = pmf.copy()
        qs = []
        for k in range(1, kmax + 1):
            qs.append(1.0 - cdf)
            ratio = np.where((m >= k) & (p < 1.0),
                             (m - k + 1) / k * p / np.maximum(1.0 - p, 1e-300),
                             0.0)
            pmf = pmf * ratio
            cdf = cdf + pmf
    q = np.stack(qs, axis=1)
    return np.floor(np.clip(q, 0.0, 1.0) * (1 << 24)).astype(np.int64)


def negative_rates(g: Graph, symmetric: bool) -> np.ndarray:
    """Thresholds [R, 3] of a full-page estimator, or [R, 8] (single rate
    1..4 | doubled rate 1..4) of the symmetric one: X ~ Binomial(m_t, 1 /
    (n^2 - distinct positives of t))."""
    m = g.train_counts().astype(np.float64)  # the pairs are unique
    nonpos = np.maximum(float(g.n_drug) ** 2 - m, 1.0)
    if not symmetric:
        return binom_tails(m, 1.0 / nonpos, 3)
    return np.concatenate([binom_tails(m, 1.0 / nonpos, 4),
                           binom_tails(m, np.minimum(2.0 / nonpos, 1.0), 4)],
                          axis=1)


def pages(g: Graph, device) -> torch.Tensor:
    """Count pages DA[t, dst, src] as float32 [R, n * n] on ``device``."""
    n = g.n_drug
    idx = torch.from_numpy((g.train[2] * n + g.train[1]) * n + g.train[0])
    da = torch.bincount(idx.to(device), minlength=g.n_et * n * n)
    return da.to(torch.float32).reshape(g.n_et, n * n)


def positive_keys(g: Graph, device) -> torch.Tensor:
    """Sorted keys (t * n + dst) * n + src of the train edges."""
    n = g.n_drug
    k = (g.train[2] * n + g.train[1]) * n + g.train[0]
    return torch.from_numpy(np.sort(k)).to(device)


def slot_layout(g: Graph, chunk: int, device):
    """(chunk relation [C], valid [C, chunk] bool) of the
    chunk-aligned buffer: each relation's train edges padded to whole
    chunks, at least one."""
    counts = g.train_counts()
    n_chunks = np.maximum(1, -(-counts // chunk))
    ct = np.repeat(np.arange(g.n_et), n_chunks)
    first = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    pos = np.arange(ct.shape[0] * chunk).reshape(-1, chunk)
    start = (first * chunk)[ct][:, None]
    valid = pos - start < counts[ct][:, None]
    return (torch.from_numpy(ct).to(device),
            torch.from_numpy(valid).to(device))
