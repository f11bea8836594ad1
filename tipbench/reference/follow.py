"""The reference run of a cell: the first training steps from the seed's
weights, then a full evaluation on the seed's test negatives.

It reads the raw graph, the weights and the test negatives that the
benchmark made and handed to the program as well, and nothing the program
made.  Runs relation block by block, so that it fits beside nothing else
on the card once the program's state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

from tipbench.lib.weights import tree
from tipbench.reference import draws, ranking
from tipbench.reference.graph import build
from tipbench.reference.model import (
    Adam,
    Estimator,
    Precision,
    Tensors,
    leaves,
    model_of,
)


def precision_of(traffic: dict, control: str = "none") -> Precision:
    stated = traffic["stated_precision"]
    return Precision(pp_bf16=stated["pp_gcn"] == "bfloat16_operands",
                     rgcn_bf16=stated["rgcn"] == "bfloat16_operands",
                     control=control)


def follow(model: str, raw, traffic: dict, lr: float, params0: dict,
           seed: int, steps: int, test_neg, device, control: str = "none"):
    """Readings of the reference: the per-relation metrics of an
    evaluation at the weights as made, z of the first step's forward, each
    step's loss, the first gradient (its norm a leaf, and the tensors),
    each leaf's change after ``steps``.

    ``model``: the configuration's model (reference/models/<model>.py);
    ``params0``: the weights as made, {path: tensor}; ``test_neg``: the
    negatives as made, (src, dst, relation) numpy arrays."""
    model = model_of(model)
    split = traffic["split"]
    g = build(raw, split["split_rate"], split["seed"])
    est_kind = traffic["estimator"]
    # the bf16 rounding points are defined on the M-first form
    mfirst = traffic["stated_precision"]["rgcn"] == "bfloat16_operands"
    T = Tensors(g, device, need_pages=est_kind in ("sym", "full") or mfirst)
    est = Estimator(est_kind, T, traffic.get("chunk", 1024))
    prec = precision_of(traffic, control)

    params = tree({k: v.detach().clone().to(device).requires_grad_(True)
                    for k, v in params0.items()})
    flat = leaves(params)
    out = dict(evaluate(model, params, T, g, test_neg, prec, mfirst),
               n_drug=g.n_drug, losses=[])
    opt = Adam([p for _, p in flat], lr)
    for k in range(steps):
        for _, p in flat:
            p.grad = None
        z = model.encode(params, T, prec, mfirst)
        if k == 0:
            out["z"] = z.detach().clone()
        zl = z.detach().requires_grad_(True)
        total = est.loss_sum(model, zl, params["decoder"],
                             draws.step_seed(seed, k), prec,
                             1.0 / float(g.n_train))
        z.backward(zl.grad)
        out["losses"].append(float(total))
        if k == 0:
            out["grad_norms"] = {path: float(p.grad.double().norm())
                                 for path, p in flat}
            out["grad"] = {path: p.grad.detach().cpu() for path, p in flat}
        opt.step()
    out["delta"] = {path: (p.detach() - params0[path].to(device)).cpu()
                    for path, p in flat}
    return out


def evaluate(model, params, T, g, test_neg, prec, mfirst) -> dict:
    """The scores of the test positives (sorted by their key (relation,
    dst, src)) and of the negatives (as drawn), and the per-relation
    metrics of the one against the other."""
    with torch.no_grad():
        z = model.encode(params, T, prec, mfirst)
        dec = params["decoder"]

        def scores(src, dst, et):
            t = (torch.from_numpy(x).to(T.dev) for x in (src, dst, et))
            return torch.sigmoid(model.score(z, dec, *t, prec)).cpu().numpy()

        pos = scores(g.test[0], g.test[1], g.test[2])
        neg = scores(*test_neg)
    n = g.n_drug
    keys = (g.test[2] * n + g.test[1]) * n + g.test[0]
    order = np.argsort(keys, kind="stable")
    return {"eval": ranking.per_relation(pos, neg, g.test[2], test_neg[2],
                                         g.n_et),
            "pos_keys": keys[order], "pos_scores": pos[order],
            "neg_scores": neg, "neg_rel": test_neg[2]}


def split_counts(raw, traffic: dict) -> tuple:
    """(test edges [3, E], counts a relation) of the cell's split: the
    positives the test negatives are drawn against."""
    split = traffic["split"]
    g = build(raw, split["split_rate"], split["seed"])
    return g.test, g.test_counts(), g.n_drug


def draw_test_negatives(raw, traffic: dict, seed: int, rounds: int = 4):
    """One uniform negative (src, dst) a directed test edge of each
    relation, redrawn up to ``rounds`` times while it is a test positive
    of the relation (leftovers kept).  Returns (src, dst, relation) int64
    arrays sorted by relation."""
    test, counts, n = split_counts(raw, traffic)
    rel = np.repeat(np.arange(counts.shape[0]), counts)
    pos_keys = np.sort((test[2] * n + test[1]) * n + test[0])
    rng = np.random.default_rng([seed, 0x7E57])
    pair = rng.integers(0, n * n, rel.shape[0])
    for _ in range(rounds - 1):
        key = rel * (n * n) + pair
        at = np.clip(np.searchsorted(pos_keys, key), 0, pos_keys.size - 1)
        hit = pos_keys[at] == key
        if not hit.any():
            break
        pair = np.where(hit, rng.integers(0, n * n, rel.shape[0]), pair)
    return pair % n, pair // n, rel
