"""Per-relation AUPRC / AUROC / AP on tensors, all relations at once
(port of tip_tpu/metrics/ranking.py:45,155).

  1. Sort rows by (type asc, score desc): the JAX package's two-key stable
     sort becomes two stable ``torch.sort``s (score first, then type).
  2. Tie groups (equal score within a type) give sklearn's distinct
     thresholds, so the metrics are exact under ties.
  3. Per-group cumulative TP/FP give the PR and ROC points: AUPRC is the
     trapezoid over PR points including the (recall 0, precision 1)
     endpoint, AP the step sum dR * P, AUROC the tie-averaged rank
     statistic.

Counts accumulate in float64 (the JAX package's float32 cumsum loses
integer exactness past 2^24 rows); per-type sums are cumsums read at the
type boundaries.
"""

from __future__ import annotations

import torch


def _fwd_max(x):
    return torch.cummax(x, dim=0).values


def _rev_min(x):
    return torch.flip(torch.cummin(torch.flip(x, (0,)), dim=0).values, (0,))


def grouped_ranking_metrics(pos_score, neg_score, edge_type, n_et: int):
    """Per-relation (auprc, auroc, ap) [n_et] float32 plus 'valid' [n_et]
    bool (False where a relation lacks positive or negative rows)."""
    s = torch.cat([pos_score, neg_score]).float()
    y = torch.cat([torch.ones_like(pos_score), torch.zeros_like(neg_score)]
                  ).double()
    t = torch.cat([edge_type, edge_type]).long()
    dev = s.device
    m = s.shape[0]

    order = torch.sort(s, descending=True, stable=True).indices
    order = order[torch.sort(t[order], stable=True).indices]
    t, s, y = t[order], s[order], y[order]

    idx = torch.arange(m, device=dev)
    idx_f = idx.double()
    first = torch.ones(1, dtype=torch.bool, device=dev)
    is_type_start = torch.cat([first, t[1:] != t[:-1]])
    is_group_start = is_type_start | torch.cat([first, s[1:] != s[:-1]])
    is_group_end = torch.cat([is_group_start[1:], first])
    is_type_end = torch.cat([is_type_start[1:], first])
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)

    cum_tp = torch.cumsum(y, 0)
    excl_tp = cum_tp - y
    off_tp = _fwd_max(torch.where(is_type_start, excl_tp, zero))
    tp = cum_tp - off_tp
    start_idx = _fwd_max(torch.where(is_type_start, idx, 0))
    fp = (idx - start_idx).double() + 1.0 - tp

    npos_e = _rev_min(torch.where(is_type_end, cum_tp, inf)) - off_tp
    ntot_e = (_rev_min(torch.where(is_type_end, idx_f, inf))
              - start_idx.double() + 1.0)
    nneg_e = ntot_e - npos_e

    g_tp = (_rev_min(torch.where(is_group_end, cum_tp, inf))
            - _fwd_max(torch.where(is_group_start, excl_tp, zero)))
    g_start_idx = _fwd_max(torch.where(is_group_start, idx, 0))
    g_cnt = (_rev_min(torch.where(is_group_end, idx_f, inf))
             - g_start_idx.double() + 1.0)
    g_fp = g_cnt - g_tp

    def safe(a, b):
        return torch.where(b > 0, a / torch.clamp(b, min=1.0), zero)

    recall = safe(tp, npos_e)
    precision = safe(tp, tp + fp)
    tp_prev, fp_prev = tp - g_tp, fp - g_fp
    recall_prev = safe(tp_prev, npos_e)
    precision_prev = torch.where(tp_prev + fp_prev > 0,
                                 safe(tp_prev, tp_prev + fp_prev),
                                 torch.ones_like(tp))
    d_recall = recall - recall_prev
    end = is_group_end.double()
    auprc_c = end * d_recall * 0.5 * (precision + precision_prev)
    ap_c = end * d_recall * precision
    auroc_c = end * g_tp * ((nneg_e - fp) + 0.5 * g_fp)

    bounds = torch.searchsorted(t, torch.arange(n_et + 1, device=dev))
    ntot = (bounds[1:] - bounds[:-1]).double()

    def seg(c):
        cs0 = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                         torch.cumsum(c, 0)])
        v = cs0[bounds]
        return v[1:] - v[:-1]

    npos = seg(y)
    nneg = ntot - npos
    valid = (npos > 0) & (nneg > 0)

    def out(v):
        return torch.where(valid, v, zero).float()

    return {
        "auprc": out(seg(auprc_c)),
        "auroc": out(safe(seg(auroc_c), npos * nneg)),
        "ap": out(seg(ap_c)),
        "valid": valid,
    }


def macro_average(metrics, denominator: str = "valid"):
    """Macro-mean of the per-relation metrics over the valid relations
    (``denominator='valid'``) or over all n_et (``'n_et'``)."""
    if denominator == "n_et":
        n = metrics["valid"].shape[0]
    else:
        n = torch.clamp(metrics["valid"].sum(), min=1)
    return {k: v.sum() / n for k, v in metrics.items() if k != "valid"}
