"""Per-relation AUPRC, AUROC and average precision, one relation at a
time, from the definitions (as scikit-learn computes them):

* thresholds are the distinct scores, highest first; at each, TP and FP
  count the rows scoring at or above it;
* AUPRC: the trapezoid over the PR points, starting at (recall 0,
  precision 1);
* AP: the sum over thresholds of the recall step times the precision;
* AUROC: the probability that a positive outscores a negative, ties
  counting a half.

A relation without positive or without negative rows reads 0 and is not
valid.
"""

from __future__ import annotations

import numpy as np


def relation_metrics(pos: np.ndarray, neg: np.ndarray):
    if pos.size == 0 or neg.size == 0:
        return 0.0, 0.0, 0.0
    s = np.concatenate([pos, neg]).astype(np.float64)
    y = np.concatenate([np.ones(pos.size), np.zeros(neg.size)])
    order = np.argsort(-s, kind="stable")
    s, y = s[order], y[order]
    last = np.flatnonzero(np.diff(s) != 0)
    ends = np.concatenate([last, [s.size - 1]])
    tp = np.cumsum(y)[ends]
    fp = (ends + 1) - tp
    p_all, n_all = float(pos.size), float(neg.size)
    recall = tp / p_all
    precision = tp / (tp + fp)
    r_prev = np.concatenate([[0.0], recall[:-1]])
    p_prev = np.concatenate([[1.0], precision[:-1]])
    auprc = float(np.sum((recall - r_prev) * 0.5 * (precision + p_prev)))
    ap = float(np.sum((recall - r_prev) * precision))
    g_tp = np.diff(np.concatenate([[0.0], tp]))
    g_fp = np.diff(np.concatenate([[0.0], fp]))
    auroc = float(np.sum(g_tp * ((n_all - fp) + 0.5 * g_fp)) / (p_all * n_all))
    return auprc, auroc, ap


def per_relation(pos, neg, pos_rel, neg_rel, n_et: int) -> dict:
    """{"auprc", "auroc", "ap": [n_et] float64, "valid": [n_et] bool}."""
    out = {k: np.zeros(n_et) for k in ("auprc", "auroc", "ap")}
    valid = np.zeros(n_et, bool)
    po, no = np.argsort(pos_rel, kind="stable"), np.argsort(neg_rel,
                                                             kind="stable")
    pb = np.searchsorted(pos_rel[po], np.arange(n_et + 1))
    nb = np.searchsorted(neg_rel[no], np.arange(n_et + 1))
    for t in range(n_et):
        p = pos[po[pb[t]:pb[t + 1]]]
        q = neg[no[nb[t]:nb[t + 1]]]
        valid[t] = p.size > 0 and q.size > 0
        out["auprc"][t], out["auroc"][t], out["ap"][t] = relation_metrics(p, q)
    out["valid"] = valid
    return out
