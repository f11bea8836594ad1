"""The numbers that decide ``correct``: what the timed path produced in the
first training steps and the evaluation after them, against the plain
reference's readings of the same steps from the same weights, draws and
test negatives.

* ``z_gap``: max |z - z_ref| / max |z_ref| of the encoder's output in the
  first step's forward.
* ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| of the first
  steps.
* ``grad_gap``: the worst leaf's | |g| - |g_ref| | over the larger of
  |g_ref| and the median leaf's |g_ref|, g the first step's gradient as
  Adam holds it after one step (its first moment / (1 - beta1)).
* ``update_gap``: the median leaf's gap of norms (as ``grad_gap`` takes
  them) of each leaf's change over the first steps.  Left out, by a rule
  on the reference's first gradient: leaves under a thousandth of the
  median leaf's norm, and within a leaf the elements under a thousandth of
  the leaf's root mean square; Adam moves those by round-off alone (its
  step normalises each element, so a gradient that is rounding noise
  makes a full-sized step of random size).  The median and not the worst
  leaf, which swings from seed to seed with the few elements near that
  floor (PERF.md §2 gives both).
* ``score_gap``: the largest |score - score_ref| of the sigmoid scores
  the program's full evaluation at the weights as made gives the test
  positives and negatives (its encoder and decoder); inf where its test
  edges differ from the reference's split.
* ``rank_gap``: the largest gap of a relation's AUPRC, AUROC or AP between
  what that evaluation returned and the reference's ranking metrics of the
  program's own scores: its ranking, judged on its inputs.  The metrics
  of the two evaluations are not compared directly: a rank swapped
  between two scores that rounding leaves within 1e-7 moves a relation's
  AP by up to 1/positives, so that gap swings from seed to seed; it is
  recorded (``readings``).

A non-finite number fails.  Each limit sits in the cell's file under
``tipbench/limits/``.
"""

from __future__ import annotations

import math

import numpy as np

from tipbench.reference import ranking

NUMBERS = ("z_gap", "loss_gap", "grad_gap", "update_gap", "score_gap",
           "rank_gap")
MOVED_FLOOR = 1e-3  # of the median leaf's reference gradient
ELEMENT_FLOOR = 1e-3  # of the leaf's root mean square reference gradient
METRICS = ("auprc", "auroc", "ap")


def leaf_gaps(got: dict, want: dict, keep=None) -> list:
    """Each kept leaf's | |x| - |x_ref| | / max(|x_ref|, median |x_ref|)."""
    paths = [p for p in want if keep is None or keep(p)]
    if not paths or set(got) != set(want):
        return [float("inf")]
    med = float(np.median([want[p] for p in paths]))
    return [abs(got[p] - want[p]) / max(want[p], med) for p in paths]


def _moved(ref: dict):
    g = ref["grad_norms"]
    floor = MOVED_FLOOR * float(np.median(list(g.values())))
    return lambda p: g[p] >= floor


def numbers(prog: dict, ref: dict) -> dict:
    z, zr = prog["z"].double(), ref["z"].double().to(prog["z"].device)
    out = {"z_gap": float((z - zr).abs().max() / zr.abs().max())}
    if len(prog["losses"]) != len(ref["losses"]):
        out["loss_gap"] = float("inf")
    else:
        out["loss_gap"] = max(abs(a - b) / abs(b)
                              for a, b in zip(prog["losses"], ref["losses"]))
    out["grad_gap"] = max(leaf_gaps(prog["grad_norms"], ref["grad_norms"]))
    out["update_gap"] = float(np.median(leaf_gaps(*change_norms(prog, ref))))
    same = np.array_equal(prog["pos_keys"], ref["pos_keys"])
    out["score_gap"] = max(
        float(np.max(np.abs(prog[k].astype(np.float64) - ref[k]),
                     initial=0.0)) for k in ("pos_scores", "neg_scores")
    ) if same else float("inf")
    out["rank_gap"] = relation_gap(prog["eval"], ranking_of(prog, ref)) \
        if same else float("inf")
    return out


def ranking_of(prog: dict, ref: dict) -> dict:
    """The reference's per-relation metrics of the program's scores."""
    n2 = ref["n_drug"] ** 2
    return ranking.per_relation(prog["pos_scores"], prog["neg_scores"],
                                prog["pos_keys"] // n2, ref["neg_rel"],
                                len(ref["eval"]["valid"]))


def change_norms(prog: dict, ref: dict) -> tuple:
    """({leaf: |change|} of the program, of the reference) over the moved
    leaves and, within each, the elements whose reference first gradient
    is at least ELEMENT_FLOOR of the leaf's root mean square."""
    moved = _moved(ref)
    got, want = {}, {}
    for path, g in ref["grad"].items():
        if not moved(path):
            continue
        g = g.double()
        keep = g.abs() >= ELEMENT_FLOOR * g.pow(2).mean().sqrt()
        want[path] = float(ref["delta"][path].double()[keep].norm())
        if path in prog["delta"]:
            got[path] = float(prog["delta"][path].double()[keep].norm())
    return got, want


def readings(prog: dict, ref: dict) -> dict:
    """What the record keeps beside the numbers: the leaf each gap of
    norms is worst at and its gap, the median leaf's gradient gap, the
    worst single relation's metric gap, the macro gap of each metric."""
    def worst(got, want):
        gaps = leaf_gaps(got, want)
        paths = sorted(want)
        i = int(np.argmax(gaps))
        return (paths[i] if len(gaps) == len(paths) else None), gaps[i]

    gp, gw = worst(prog["grad_norms"], ref["grad_norms"])
    up, uw = worst(*change_norms(prog, ref))
    rel = {k: relation_gap(prog["eval"], ref["eval"], (k,)) for k in METRICS}
    mac = {k: macro_gap(prog["eval"], ref["eval"], (k,)) for k in METRICS}
    return {"grad_worst_leaf": gp,
            "grad_median": float(np.median(leaf_gaps(prog["grad_norms"],
                                                     ref["grad_norms"]))),
            "update_worst_leaf": up, "update_worst": uw,
            "eval_relation": rel, "eval_macro": mac}


def _valid_same(got, want) -> bool:
    return np.array_equal(np.asarray(got["valid"], bool), want["valid"])


def macro_gap(got: dict, want: dict, metrics=METRICS) -> float:
    if not _valid_same(got, want):
        return float("inf")
    v = want["valid"]
    return max(abs(float(np.mean(np.asarray(got[k], np.float64)[v]))
                   - float(np.mean(want[k][v]))) for k in metrics)


def relation_gap(got: dict, want: dict, metrics=METRICS) -> float:
    if not _valid_same(got, want):
        return float("inf")
    v = want["valid"]
    return max(float(np.max(np.abs(np.asarray(got[k], np.float64)[v]
                                   - want[k][v]), initial=0.0))
               for k in metrics)


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over every number; the cell's
    limits file names each."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
