"""Per-relation result reporting and Decagon cross-checks.

A port of tip_tpu/analysis/report.py (numpy only), the equivalent of the
reference's analysis layer (reference: analysis/top10.py,
analysis/evaluation.ipynb): named per-side-effect metric tables, best/worst
rankings, and the rank positions of the side effects Decagon's paper reports
as easiest/hardest.  Consumes the per-relation dict produced by
``train`` / ``train_variant`` (their ``per_relation``) directly — no
pickled score dumps.  ``write_report`` is the CLIs' ``--report``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from tip_tpu_torch.data.decagon import DEFAULT_DATA_DIR

# Side effects Decagon's paper lists as best/worst predicted
# (reference: analysis/top10.py:43-46).
DECAGON_BEST_ORG_ID = [26780, 7078, 9193, 206504, 32633, 38019, 36337, 16034,
                       1258666, 156369]
DECAGON_WORST_ORG_ID = [19080, 15967, 42963, 22658, 23530, 11991, 22346, 27497,
                        33774, 2871]


def load_side_effect_names(
    et_ids: Sequence[int], data_dir: str = DEFAULT_DATA_DIR
) -> List[str]:
    """Human-readable side-effect name per compact relation id."""
    with open(os.path.join(data_dir, "index_map", "combo_map.pkl"), "rb") as f:
        combo_map = pickle.load(f)  # original UMLS id -> dense 0..1316
    with open(os.path.join(data_dir, "index_map", "combo-name-map.pkl"), "rb") as f:
        name_map = pickle.load(f)  # original UMLS id -> name
    inv_combo = {v: k for k, v in combo_map.items()}
    return [name_map.get(inv_combo.get(int(t), -1), f"type_{int(t)}") for t in et_ids]


def per_relation_table(
    per_rel: Dict[str, np.ndarray],
    et_ids: Sequence[int],
    names: Optional[List[str]] = None,
) -> List[dict]:
    """Rows of {relation id, name, auprc, auroc, ap} for valid relations."""
    valid = np.asarray(per_rel["valid"])
    rows = []
    for i in range(len(et_ids)):
        if not valid[i]:
            continue
        rows.append({
            "et": int(et_ids[i]),
            "name": names[i] if names else f"type_{int(et_ids[i])}",
            "auprc": round(float(per_rel["auprc"][i]), 4),
            "auroc": round(float(per_rel["auroc"][i]), 4),
            "ap": round(float(per_rel["ap"][i]), 4),
        })
    return rows


def top_bottom(rows: List[dict], k: int = 10, key: str = "auprc"):
    """(best_k, worst_k) rows by metric (reference: analysis/top10.py:57-62)."""
    ranked = sorted(rows, key=lambda r: r[key], reverse=True)
    return ranked[:k], ranked[-k:][::-1]


def decagon_rank_comparison(
    per_rel: Dict[str, np.ndarray],
    et_ids: Sequence[int],
    data_dir: str = DEFAULT_DATA_DIR,
    key: str = "auprc",
) -> dict:
    """Where Decagon's reported best/worst side effects rank in OUR results.

    Returns rank positions (0 = our best) for each of Decagon's best/worst
    lists that appear in the trained relation set
    (reference: analysis/top10.py:48-50, 64-66).
    """
    with open(os.path.join(data_dir, "index_map", "combo_map.pkl"), "rb") as f:
        combo_map = pickle.load(f)
    et_pos = {int(t): i for i, t in enumerate(et_ids)}
    metric = np.asarray(per_rel[key])
    order = np.argsort(-metric)  # 0 = best
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(len(order))

    def ranks(org_ids):
        out = {}
        for org in org_ids:
            dense = combo_map.get(org)
            if dense is None or int(dense) not in et_pos:
                continue
            out[org] = int(rank_of[et_pos[int(dense)]])
        return out

    return {
        "n_relations": len(et_ids),
        "decagon_best_ranks": ranks(DECAGON_BEST_ORG_ID),
        "decagon_worst_ranks": ranks(DECAGON_WORST_ORG_ID),
    }


def save_report(path: str, rows: List[dict], summary: Optional[dict] = None) -> None:
    """Write the per-relation table (+summary) as JSON; .csv also supported."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".csv"):
        import csv

        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    else:
        with open(path, "w") as f:
            json.dump({"summary": summary or {}, "per_relation": rows}, f, indent=1)


def write_report(path: str, result: dict, et_ids: Sequence[int],
                 data_dir: str = DEFAULT_DATA_DIR,
                 rank_comparison: bool = True) -> None:
    """The CLIs' ``--report``: the named per-relation table of
    ``result["per_relation"]`` and the final metrics, plus the ranks of
    Decagon's best and worst side effects with ``rank_comparison``;
    ``type_{id}`` names and the final metrics alone where ``data_dir`` has
    no name maps.  The names and ranks come from ``data_dir``, the
    directory the relations were loaded from; the JAX package's training
    CLI reads them from its default directory whatever ``--data-dir`` says
    (tip_tpu/train/__main__.py:111-113)."""
    summary = dict(result["final"])
    try:
        names = load_side_effect_names(et_ids, data_dir)
        if rank_comparison:
            summary.update(decagon_rank_comparison(
                result["per_relation"], et_ids, data_dir))
    except OSError:  # no name maps in data_dir
        names, summary = None, dict(result["final"])
    rows = per_relation_table(result["per_relation"], et_ids, names)
    save_report(path, rows, summary)
    print(f"per-relation report -> {path}")
