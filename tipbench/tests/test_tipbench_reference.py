"""The plain reference against the program on the CPU at a tiny graph: a
whole run of each cell (z, the losses, the gradients, the update, the
evaluation), and the reference's graph, draws and ranking metrics against
the program's own, piece by piece."""

from unittest import mock

import numpy as np
import pytest
import torch

from tipbench import run
from tipbench.lib.generator import make_raw
from tipbench.reference import draws, graph as rgraph, ranking
from tipbench.tests import tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]
# CPU float32 against float32: rounding order only
CPU_TOL = {"z_gap": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4,
           "update_gap": 1e-4, "score_gap": 1e-5, "rank_gap": 1e-6}


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "CACHE_DIR", str(tmp_path / "cache"))


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_program(workload):
    with tiny.layout_of(workload):
        out = run.run(tiny.files(workload), seed=2**31 + 11, seconds=0,
                      trace=False, device="cpu")
    values = {k: c["value"] for k, c in out["checks"].items()}
    assert out["correct"], values
    for k, value in values.items():
        assert value <= CPU_TOL[k], (k, value)


def test_the_train_group_reaches_the_loss():
    """A traffic file's "train" group is passed to the model's loss: with
    remat the encoder is recomputed in the backward, and the run is
    still correct."""
    from tip_tpu_torch.train.model import TIP

    files = tiny.files("tip_cat.decagon_strips")
    files["traffic"]["train"] = {"remat": True}
    seen = []
    loss = TIP.loss

    def spy(self, *args, **kwargs):
        seen.append(kwargs.get("remat"))
        return loss(self, *args, **kwargs)

    with mock.patch.object(TIP, "loss", spy):
        out = run.run(files, seed=2**31 + 13, seconds=0, trace=False,
                      device="cpu")
    assert seen and all(seen), seen
    assert out["correct"], out["checks"]


def test_graph_matches_the_program_packing():
    from tip_tpu_torch.data.packing import (
        build_trigraph,
        poisson_neg_thresholds,
        poisson_neg_thresholds_sym,
    )

    raw = make_raw(tiny.TINY_GRAPH)
    data = build_trigraph(raw, 0.9, 1111)
    g = rgraph.build(raw, 0.9, 1111)

    def keys(e, et):
        return np.sort((et * 10**6 + e[1]) * 10**3 + e[0])

    assert np.array_equal(keys(g.train[:2], g.train[2]),
                          keys(data.dd_train.edge_index.astype(np.int64),
                               data.dd_train.edge_type))
    assert np.array_equal(keys(g.test[:2], g.test[2]),
                          keys(data.dd_test.edge_index.astype(np.int64),
                               data.dd_test.edge_type))
    assert np.array_equal(rgraph.negative_rates(g, True),
                          poisson_neg_thresholds_sym(data.dd_train, g.n_drug))
    assert np.array_equal(rgraph.negative_rates(g, False),
                          poisson_neg_thresholds(data.dd_train, g.n_drug))
    mine = sorted(zip(g.pp[1], g.pp[0],
                      (g.pp_dinv[g.pp[0]] * g.pp_dinv[g.pp[1]])
                      .astype(np.float32)))
    theirs = sorted(zip(data.pp_norm_index[1], data.pp_norm_index[0],
                        data.pp_norm_weight))
    assert mine == theirs


def test_draws_match_the_program():
    from tip_tpu_torch.ops.dense_bce_sym import u24_field
    from tip_tpu_torch.ops.sampler import (
        resolve_borrow,
        typed_negative_sampling_plain,
    )
    from tip_tpu_torch.sampling import bitmap_tensor
    from tip_tpu_torch.data.packing import build_trigraph
    from tip_tpu_torch.train.loop import step_seed

    seed = 2**31 + 3
    assert draws.step_seed(seed, 5) == step_seed(seed, 5)
    rel, idx = torch.arange(4), torch.arange(37)
    assert torch.equal(draws.u24(123456, rel, idx, idx, 40),
                       u24_field(123456, rel, idx, idx, 40))

    raw = make_raw(tiny.TINY_GRAPH)
    data = build_trigraph(raw, 0.9, 1111)
    g = rgraph.build(raw, 0.9, 1111)
    chunk, n = 64, g.n_drug
    ct, _ = rgraph.slot_layout(g, chunk, "cpu")
    bitmap = bitmap_tensor(data.dd_train_bitmap)
    theirs = resolve_borrow(typed_negative_sampling_plain(
        77, ct.int(), bitmap, n, chunk))
    keys = rgraph.positive_keys(g, "cpu")

    def is_positive(r, pair):
        key = (r * (n * n) + pair).reshape(-1)
        at = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
        return (keys[at] == key).reshape(pair.shape)

    mine = draws.sampled_pairs(77, ct, chunk, is_positive, n)
    assert torch.equal(mine, theirs.long())


def test_ranking_matches_the_program():
    from tip_tpu_torch.metrics import grouped_ranking_metrics

    rng = np.random.default_rng(5)
    n_et = 6
    pos_rel = rng.integers(0, n_et, 300)
    neg_rel = rng.integers(0, n_et, 280)
    # coarse scores: many ties within and across the labels
    pos = np.round(rng.random(300), 2).astype(np.float32)
    neg = np.round(rng.random(280) * 0.8, 2).astype(np.float32)
    mine = ranking.per_relation(pos, neg, pos_rel, neg_rel, n_et)
    for t in range(n_et):
        p, q = pos[pos_rel == t], neg[neg_rel == t]
        s = torch.from_numpy(np.concatenate([p, q]))
        lab = np.concatenate([np.ones(p.size), np.zeros(q.size)])
        ref = _sklearn_like(s.numpy(), lab)
        assert np.allclose([mine["auprc"][t], mine["auroc"][t], mine["ap"][t]],
                           ref, atol=1e-12)
    # and against the program, which takes one negative a positive, on
    # the same relation
    k = min(pos.size, neg.size)
    rel = pos_rel[:k]
    got = grouped_ranking_metrics(torch.from_numpy(pos[:k]),
                                  torch.from_numpy(neg[:k]),
                                  torch.from_numpy(rel), n_et)
    ref = ranking.per_relation(pos[:k], neg[:k], rel, rel, n_et)
    for m in ("auprc", "auroc", "ap"):
        assert np.allclose(got[m].numpy(), ref[m], atol=1e-6), m
    assert np.array_equal(got["valid"].numpy(), ref["valid"])


def _sklearn_like(s, y):
    """AUPRC (trapezoid from (0, 1)), AUROC (pairs, ties a half), AP, by
    brute force."""
    pos, neg = s[y == 1], s[y == 0]
    auroc = np.mean((pos[:, None] > neg[None]) + 0.5 * (pos[:, None]
                                                         == neg[None]))
    th = np.unique(s)[::-1]
    r_prev, p_prev, auprc, ap = 0.0, 1.0, 0.0, 0.0
    for t in th:
        tp = np.sum(pos >= t)
        fp = np.sum(neg >= t)
        r, p = tp / pos.size, tp / (tp + fp)
        auprc += (r - r_prev) * 0.5 * (p + p_prev)
        ap += (r - r_prev) * p
        r_prev, p_prev = r, p
    return [auprc, auroc, ap]
