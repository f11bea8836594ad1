"""The port's slice end to end against the JAX package on the CPU: TIP.loss
and its gradients, an Adam trajectory, evaluation and the ranking metrics,
the negative sampler, and the CLI."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from sklearn import metrics as skm

from tip_tpu.config import ModelConfig as JModelConfig
from tip_tpu.data import build_trigraph as j_build, synthetic_trigraph as j_raw
from tip_tpu.metrics import grouped_ranking_metrics as j_metrics
from tip_tpu.metrics import macro_average as j_macro
from tip_tpu.train.model import TIP as JTIP
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
from tip_tpu.train.model import make_test_arrays as j_test_arrays
from tip_tpu_torch import convert
from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.metrics import grouped_ranking_metrics, macro_average
from tip_tpu_torch.sampling import bitmap_tensor, typed_negative_sampling
from tip_tpu_torch.sampling.negative import collides
from tip_tpu_torch.train.loop import train
from tip_tpu_torch.train.model import TIP, make_graph_arrays, make_test_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_KW = dict(n_drug=150, n_prot=64, n_et=5, pairs_per_et=120, n_pp_pairs=200,
              n_dp=120, seed=3)
# TIP-cat at narrow widths (d = 8 also has a CUDA instantiation)
NARROW = dict(prot_drug_dim=8, n_embed=16, n_hid1=16, n_hid2=8, num_base=8,
              pp_hid1=16, pp_hid2=8)


@pytest.fixture(scope="module")
def setup():
    jdata = j_build(j_raw(**RAW_KW), split_rate=0.9, seed=5)
    tdata = build_trigraph(synthetic_trigraph(**RAW_KW), split_rate=0.9, seed=5)
    jcfg = JModelConfig(mode="cat", **NARROW)
    cfg = ModelConfig(mode="cat", **NARROW)
    jgraph, jgs = j_graph_arrays(jdata, dense_dtype="bfloat16")
    jmodel = JTIP.for_data(jcfg, jdata, jgs, backend="pallas")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0)))
    graph, gs = make_graph_arrays(tdata, device="cpu", dense_dtype="bfloat16")
    model = TIP.for_data(cfg, tdata, gs, device="cpu")
    return jdata, tdata, jgraph, jmodel, graph, model, params


def _grads(params):
    return convert.params_to_numpy(jax.tree.map(
        lambda p: p.grad, params, is_leaf=lambda v: isinstance(v, torch.Tensor)))


def test_tip_loss_and_grads_match_jax_u24_zero(setup):
    """The whole slice: encoder + fused BCE.  JAX's Pallas kernel in
    interpret mode draws u24 = 0; the port's plain BCE gets the same zero
    field.  bf16 re-rounding of activations can flip an ulp between the
    packages, hence loss rtol 1e-3 and grads atol 2e-2 of their largest."""
    _, _, jgraph, jmodel, graph, model, params = setup
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jgraph, jax.random.key(9))))(
                jax.tree.map(jnp.asarray, params))
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=9, u24=torch.zeros((), dtype=torch.int64))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    jg = jax.tree.map(np.asarray, jg)
    tg = _grads(tp)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(tg),
                            jax.tree.leaves(jg)):
        np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max(),
                                   err_msg=str(path))


def test_tip_remat_loss_and_grads_match_jax_u24_zero(setup):
    """remat (the encoder recomputed in the backward: jax.checkpoint in the
    JAX package, torch.utils.checkpoint in the port) in the deterministic
    mode above, at its tolerances."""
    _, _, jgraph, jmodel, graph, model, params = setup
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jgraph, jax.random.key(9), remat=True)))(
                jax.tree.map(jnp.asarray, params))
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=9, u24=torch.zeros((), dtype=torch.int64),
                      remat=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    for g, w in zip(jax.tree.leaves(_grads(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max())


def test_adam_trajectory_matches_optax(setup):
    """Three Adam steps with the negative thresholds zeroed (positives only,
    so the field cannot differ): per-step losses within rtol 1e-3."""
    jdata, _, jgraph, jmodel, graph, model, params = setup
    jgraph = dict(jgraph, dd_neg_q8=jnp.zeros_like(jgraph["dd_neg_q8"]))
    graph = dict(graph, dd_neg_q8=torch.zeros_like(graph["dd_neg_q8"]))
    jx = JTIP(cfg=jmodel.cfg, gs=jmodel.gs, backend="xla")
    opt = optax.adam(0.01)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)

    @jax.jit
    def step(p, state, k):
        lv, g = jax.value_and_grad(lambda p: jx.loss(p, jgraph, k))(p)
        upd, state = opt.update(g, state, p)
        return optax.apply_updates(p, upd), state, lv

    jlosses = []
    for k in range(3):
        jp, state, lv = step(jp, state, jax.random.key(k))
        jlosses.append(float(lv))
    tp = convert.params_from_jax(params, requires_grad=True)
    topt = torch.optim.Adam(convert.leaves(tp), lr=0.01, eps=1e-8)
    tlosses = []
    for k in range(3):
        topt.zero_grad()
        loss = model.loss(tp, graph, seed=k)
        loss.backward()
        topt.step()
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert tlosses[2] < tlosses[0]


def test_evaluate_matches_jax_given_same_negatives(setup):
    jdata, tdata, jgraph, jmodel, graph, model, params = setup
    jtest = j_test_arrays(jdata)
    jneg = jax.jit(jmodel.sample_test_negatives)(jax.random.key(2), jtest)
    jper, javg = jax.jit(jmodel.evaluate)(jax.tree.map(jnp.asarray, params),
                                          jgraph, jtest, jneg)
    test = make_test_arrays(tdata, device="cpu")
    neg = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
           for k, v in jneg.items()}
    per, avg = model.evaluate(convert.params_from_jax(params), graph, test, neg)
    for k in ("auprc", "auroc", "ap"):
        np.testing.assert_allclose(per[k].numpy(), np.asarray(jper[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(avg[k]), float(javg[k]), atol=1e-5)
    assert np.array_equal(per["valid"].numpy(), np.asarray(jper["valid"]))


@pytest.mark.parametrize("tied", [False, True])
def test_ranking_metrics_match_jax_and_sklearn(tied):
    rng = np.random.default_rng(0 if tied else 1)
    n_et = 7
    counts = rng.integers(5, 60, n_et)
    pos, neg, et = [], [], []
    for t, c in enumerate(counts):
        p, n = rng.normal(size=c) + 0.5, rng.normal(size=c)
        if tied:  # ties, including positive/negative collisions
            p, n = np.round(p * 4) / 4, np.round(n * 4) / 4
        pos.append(1 / (1 + np.exp(-p)))
        neg.append(1 / (1 + np.exp(-n)))
        et.append(np.full(c, t, np.int32))
    pos = np.concatenate(pos).astype(np.float32)
    neg = np.concatenate(neg).astype(np.float32)
    et = np.concatenate(et)
    got = grouped_ranking_metrics(torch.from_numpy(pos), torch.from_numpy(neg),
                                  torch.from_numpy(et), n_et + 1)
    want = jax.jit(j_metrics, static_argnums=3)(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(et), n_et + 1)
    for k in ("auprc", "auroc", "ap"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
    assert not bool(got["valid"][n_et])  # empty relation masked
    for t in range(n_et):
        m = et == t
        y = np.r_[np.ones(m.sum()), np.zeros(m.sum())]
        s = np.r_[pos[m], neg[m]]
        prec, rec, _ = skm.precision_recall_curve(y, s)
        np.testing.assert_allclose(float(got["auprc"][t]), skm.auc(rec, prec),
                                   atol=1e-5)
        np.testing.assert_allclose(float(got["auroc"][t]),
                                   skm.roc_auc_score(y, s), atol=1e-5)
        np.testing.assert_allclose(float(got["ap"][t]),
                                   skm.average_precision_score(y, s), atol=1e-5)
    for den in ("valid", "n_et"):
        a, b = macro_average(got, den), j_macro(want, den)
        for k in a:
            np.testing.assert_allclose(float(a[k]), float(b[k]), atol=1e-5)


def test_negative_sampling_avoids_positives_and_is_uniform(setup):
    _, tdata, *_ = setup
    n = tdata.n_drug
    test = make_test_arrays(tdata, device="cpu")
    train_bm = bitmap_tensor(tdata.dd_train_bitmap)
    et = torch.from_numpy(tdata.dd_train.edge_type.astype(np.int64))
    et = et.repeat(40)
    src, dst = typed_negative_sampling(torch.Generator().manual_seed(0), et,
                                       train_bm, n)
    pair = dst * n + src
    # 4 rounds leave a collision with probability density^4 per edge: none
    assert not bool(collides(pair, et, train_bm, n).any())
    assert int(src.min()) >= 0 and int(src.max()) < n
    # marginals: 10 bins of node ids, chi-square with 9 dof
    for ids in (src, dst):
        c = torch.bincount(ids * 10 // n, minlength=10).double()
        e = ids.numel() / 10
        assert float(((c - e) ** 2 / e).sum()) < 40.0
    # test negatives avoid the test positives
    model = setup[5]
    neg = model.sample_test_negatives(torch.Generator().manual_seed(1), test)
    assert neg["src"].shape == test["src"].shape
    assert not bool(collides(neg["dst"] * n + neg["src"], test["et"],
                             test["bitmap"], n).any())


def test_train_cpu_runs_and_reports(setup):
    _, tdata, *_ = setup
    logs = []
    cfg = ModelConfig(mode="cat", **NARROW)
    _, res = train(cfg, TrainConfig(epochs=3, sync_every=2, eval_every=2),
                   tdata, log=logs.append, device="cpu")
    assert [h["epoch"] for h in res["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert "auprc" in res["history"][1]
    for k in ("auprc", "auroc", "ap"):
        assert 0.0 <= res["final"][k] <= 1.0


def test_cuda_default_raises_without_gpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tdata, *_ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(ModelConfig(mode="cat", **NARROW), TrainConfig(epochs=1), tdata)
    out = subprocess.run(
        [sys.executable, "-m", "tip_tpu_torch.train", "--synthetic",
         "--epochs", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and "--cpu" in out.stderr


def test_cli_synthetic_cpu(tmp_path):
    out_json = tmp_path / "m.json"
    out = subprocess.run(
        [sys.executable, "-m", "tip_tpu_torch.train", "--synthetic", "--cpu",
         "--epochs", "2", "--out", str(out_json)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    records = [json.loads(x) for x in lines if x.startswith("{")]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert records[-1]["spans"]["forward"]["count"] == 2
    assert lines[-1].startswith("On test set: auprc:")
    final = json.loads(out_json.read_text())["final"]
    assert 0.0 <= final["auroc"] <= 1.0
