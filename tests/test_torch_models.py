"""The port's model variants (tip_tpu_torch/models) against tip_tpu.models on
the CPU: DDModel with both decoders on the strips (+ pages) and on the
chunked layout, PDModel and PPModel, the routing and what raises, the
runner and the CLI.

Both packages get the same raw graph (the port's packing is bit-identical)
and the same parameters through convert.py.  JAX runs its
``backend="pallas"`` path in interpret mode, the port its plain versions.
The random bits are shared as in tests/test_torch_model.py and
tests/test_torch_chunked.py: JAX's interpret-mode dense kernels draw
u24 = 0, the port's dense BCEs get an explicit zero field; JAX's sampler
streams jax.random.bits(key) >> 8 into its kernel, the port's sampler
takes the same draws.  Tolerances: the strips re-round activations to bf16
(loss rtol 1e-3, grads 2e-2 of their max, z one bf16 ulp of its max, as
test_torch_model.py); the chunked layout is float32 throughout (loss rtol
1e-5, grads atol 2e-4, z atol 1e-4, as test_torch_chunked.py).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import build_trigraph as j_build, synthetic_trigraph as j_raw
from tip_tpu.models import DDConfig as JDDConfig, DDModel as JDDModel
from tip_tpu.models import PDConfig as JPDConfig, PDModel as JPDModel
from tip_tpu.models import PPConfig as JPPConfig, PPModel as JPPModel
from tip_tpu.models.dd import make_dd_graph_arrays as j_dd_arrays
from tip_tpu.models.pd import make_pd_graph_arrays as j_pd_arrays
from tip_tpu.models.pp import make_pp_graph_arrays as j_pp_arrays
from tip_tpu.train.model import make_test_arrays as j_test_arrays
from tip_tpu_torch import convert
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.models import DDConfig, DDModel, PDConfig, PDModel
from tip_tpu_torch.models import PPConfig, PPModel
from tip_tpu_torch.models import runner
from tip_tpu_torch.models.dd import make_dd_graph_arrays
from tip_tpu_torch.models.pd import make_pd_graph_arrays
from tip_tpu_torch.models.pp import make_pp_graph_arrays
from tip_tpu_torch.train.model import make_test_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_KW = dict(n_drug=60, n_prot=80, n_et=5, pairs_per_et=80, n_pp_pairs=300,
              n_dp=120, seed=13)
DD_WIDTHS = dict(n_embed=8, n_hid1=8, n_hid2=8, num_base=4,
                 nn_decoder_l1_dim=8)
CHUNK = 32
ZERO = torch.zeros((), dtype=torch.int64)


@pytest.fixture(scope="module")
def datas():
    jdata = j_build(j_raw(**RAW_KW), split_rate=0.85, seed=13)
    tdata = build_trigraph(synthetic_trigraph(**RAW_KW), split_rate=0.85,
                           seed=13)
    return jdata, tdata


def _tree(params):
    return jax.tree.map(jnp.asarray, params)


def _grads(params):
    return convert.params_to_numpy(jax.tree.map(
        lambda p: p.grad, params, is_leaf=lambda v: isinstance(v, torch.Tensor)))


def _dd_pair(datas, decoder, dense):
    """(jax model, jax graph, port model, port graph, params)."""
    jdata, tdata = datas
    dtype = "bfloat16" if dense else None
    jgraph, jgs = j_dd_arrays(jdata, chunk=CHUNK, dense_dtype=dtype,
                              planes=True)
    jmodel = JDDModel.for_data(JDDConfig(decoder=decoder, **DD_WIDTHS), jgs,
                               backend="pallas")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(1)))
    graph, gs = make_dd_graph_arrays(tdata, "cpu", chunk=CHUNK,
                                     dense_dtype=dtype, decoder=decoder)
    model = DDModel.for_data(DDConfig(decoder=decoder, **DD_WIDTHS), gs, "cpu")
    return jmodel, jgraph, model, graph, params


@pytest.mark.parametrize("decoder", ["distmult", "nn"])
@pytest.mark.parametrize("dense", [True, False], ids=["strips", "chunked"])
def test_dd_encode_loss_and_grads_match_jax(datas, decoder, dense):
    jmodel, jgraph, model, graph, params = _dd_pair(datas, decoder, dense)
    assert model.gs.dd_layout == (
        {"distmult": "strips", "nn": "strips_pages"}[decoder] if dense
        else "chunked")
    key = jax.random.key(9)
    with pltpu.force_tpu_interpret_mode():
        jz = np.asarray(jax.jit(jmodel.encode)(_tree(params), jgraph))
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jgraph, key)))(_tree(params))
    z = model.encode(convert.params_from_jax(params), graph).numpy()
    gs = model.gs
    if dense:
        u24 = ZERO
    else:
        u24 = torch.from_numpy(np.asarray(jax.random.bits(
            key, (gs.dd_n_chunks, 1, gs.dd_chunk), jnp.uint32) >> 8
        ).astype(np.int32))
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=9, u24=u24)
    loss.backward()
    if dense:
        np.testing.assert_allclose(z, jz, rtol=1e-5,
                                   atol=2.0**-8 * np.abs(jz).max())
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    else:
        np.testing.assert_allclose(z, jz, atol=1e-4)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(_grads(tp)),
                            jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        atol = 2e-2 * np.abs(w).max() if dense else 2e-4
        np.testing.assert_allclose(g, w, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("decoder", ["distmult", "nn"])
def test_dd_evaluate_matches_jax_given_same_negatives(datas, decoder):
    jdata, tdata = datas
    jmodel, jgraph, model, graph, params = _dd_pair(datas, decoder, False)
    jtest = j_test_arrays(jdata)
    jneg = jax.jit(jmodel.sample_test_negatives)(jax.random.key(2), jtest)
    with pltpu.force_tpu_interpret_mode():
        jper, javg = jax.jit(jmodel.evaluate)(_tree(params), jgraph, jtest,
                                              jneg)
    neg = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
           for k, v in jneg.items()}
    per, avg = model.evaluate(convert.params_from_jax(params), graph,
                              make_test_arrays(tdata, "cpu"), neg)
    for k in ("auprc", "auroc", "ap"):
        np.testing.assert_allclose(per[k].numpy(), np.asarray(jper[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(avg[k]), float(javg[k]), atol=1e-5)


def _shared_negatives(n_nodes, count, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_nodes, (2, count)).astype(np.int64)


def test_pd_encode_scores_and_evaluate_match_jax(datas):
    jdata, tdata = datas
    jgraph, jtest = j_pd_arrays(jdata)
    cfg = dict(embed_dim=8, target_dim=6, l1_dim=4)
    jmodel = JPDModel.for_data(JPDConfig(**cfg), jdata)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(3)))
    graph, test = make_pd_graph_arrays(tdata, "cpu")
    model = PDModel.for_data(PDConfig(**cfg), tdata, "cpu")
    assert np.array_equal(graph["pair_bitmap"].numpy().view(np.uint32),
                          np.asarray(jgraph["pair_bitmap"]))
    tp = convert.params_from_jax(params)
    jz = np.asarray(jax.jit(jmodel.encode)(_tree(params), jgraph))
    np.testing.assert_allclose(model.encode(tp, graph).numpy(), jz, rtol=1e-5,
                               atol=1e-6)
    ns, nd = _shared_negatives(tdata.n_drug, test["src"].shape[0], 4)
    jneg = {"src": jnp.asarray(ns, jnp.int32), "dst": jnp.asarray(nd, jnp.int32)}
    neg = {"src": torch.from_numpy(ns), "dst": torch.from_numpy(nd)}
    jper, javg = jax.jit(jmodel.evaluate)(_tree(params), jgraph, jtest, jneg)
    per, avg = model.evaluate(tp, graph, test, neg)
    for k in ("auprc", "auroc", "ap"):
        np.testing.assert_allclose(per[k].numpy(), np.asarray(jper[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(avg[k]), float(javg[k]), atol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_pp_encode_scores_and_evaluate_match_jax(datas, layout):
    jdata, tdata = datas
    jgraph, jtest = j_pp_arrays(jdata)
    jmodel = JPPModel.for_data(JPPConfig(hid1=8, hid2=6), jdata)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(5)))
    graph, test = make_pp_graph_arrays(tdata, "cpu")
    model = PPModel.for_data(PPConfig(hid1=8, hid2=6), tdata, "cpu")
    assert model.layout == "dense" and "pp_a1" in jgraph and "pp_a1" in graph
    if layout == "coo":  # the graph PP-GAE builds where (A+I) cannot be
        jgraph = {k: v for k, v in jgraph.items() if k not in ("pp_a1",
                                                               "pp_dinv")}
        model = dataclasses.replace(model, layout="coo")
        graph = dict(graph, pp_norm_index=torch.from_numpy(
            tdata.pp_norm_index.astype(np.int64)),
            pp_norm_weight=torch.from_numpy(tdata.pp_norm_weight))
    tp = convert.params_from_jax(params)
    jz = np.asarray(jax.jit(jmodel.encode)(_tree(params), jgraph))
    z = model.encode(tp, graph).numpy()
    # the dense path rounds its operands to bf16 in both packages
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5 * np.abs(jz).max())
    ns, nd = _shared_negatives(tdata.n_prot, test["src"].shape[0], 6)
    jneg = {"src": jnp.asarray(ns, jnp.int32), "dst": jnp.asarray(nd, jnp.int32)}
    neg = {"src": torch.from_numpy(ns), "dst": torch.from_numpy(nd)}
    jper, javg = jax.jit(jmodel.evaluate)(_tree(params), jgraph, jtest, jneg)
    per, avg = model.evaluate(tp, graph, test, neg)
    for k in ("auprc", "auroc", "ap"):
        np.testing.assert_allclose(float(avg[k]), float(javg[k]), atol=1e-5)


def test_dd_routing_and_raises(datas):
    _, tdata = datas
    strips = make_dd_graph_arrays(tdata, "cpu", decoder="distmult",
                                  dense_dtype="bfloat16")
    pages = make_dd_graph_arrays(tdata, "cpu", decoder="nn",
                                 dense_dtype="bfloat16")
    chunked = make_dd_graph_arrays(tdata, "cpu", chunk=CHUNK, decoder="nn")
    # each layout ships only what its route reads
    assert set(strips[0]) == {"dd_deg", "dd_adj_sym", "dd_neg_q8"}
    assert set(pages[0]) == {"dd_deg", "dd_adj_sym", "dd_adj_u8", "dd_neg_q"}
    assert pages[0]["dd_adj_u8"].dtype == torch.uint8
    assert pages[1].dd_layout == "strips_pages"
    assert {"dd_src2d", "dd_bitmap"} <= set(chunked[0])
    assert "dd_adj_sym" not in chunked[0]
    f32 = make_dd_graph_arrays(tdata, "cpu", dense_dtype="float32")
    assert f32[1].dd_layout == "pages"
    assert set(f32[0]) == {"dd_deg", "dd_adj_t", "dd_neg_q"}
    # DR-NN's pages layout: B3 reads the encoder's pages, no uint8 copy
    f32_nn = make_dd_graph_arrays(tdata, "cpu", dense_dtype="float32",
                                  decoder="nn")
    assert f32_nn[1].dd_layout == "pages"
    assert set(f32_nn[0]) == {"dd_deg", "dd_adj_t", "dd_neg_q"}
    DDModel.for_data(DDConfig(decoder="nn"), f32_nn[1], "cpu")
    # sampled DR-NN strips ship no pages: layout 'strips', no DR-DF route
    nn_sampled = make_dd_graph_arrays(tdata, "cpu", chunk=CHUNK,
                                      dense_dtype="bfloat16", decoder="nn",
                                      sampled=True)
    assert nn_sampled[1].dd_layout == "strips"
    assert not {"dd_adj_t", "dd_adj_u8"} & set(nn_sampled[0])
    DDModel.for_data(DDConfig(decoder="nn", negatives="sampled"),
                     nn_sampled[1], "cpu")
    with pytest.raises(ValueError, match="no route"):
        DDModel.for_data(DDConfig(negatives="sampled"), nn_sampled[1], "cpu")
    # a graph packed for the Poissonized route refuses sampled negatives
    with pytest.raises(ValueError, match="sampled=True"):
        DDModel.for_data(DDConfig(negatives="sampled"), strips[1], "cpu")
    with pytest.raises(ValueError, match="sampled=True"):
        DDModel.for_data(DDConfig(decoder="nn", negatives="sampled"),
                         pages[1], "cpu")
    with pytest.raises(ValueError, match="negatives='poisson'"):
        DDModel.for_data(DDConfig(decoder="nn", negatives="poisson"),
                         chunked[1], "cpu")
    with pytest.raises(ValueError, match="no route"):
        DDModel.for_data(DDConfig(decoder="nn"), strips[1], "cpu")
    with pytest.raises(ValueError, match="no route"):
        DDModel.for_data(DDConfig(), pages[1], "cpu")
    DDModel.for_data(DDConfig(negatives="sampled"), chunked[1], "cpu")


def test_dd_float32_page_graph_raises_naming_b2(datas):
    """Counts past bf16's exact range send the JAX package to float32 full
    pages: DR-DF takes them (kernel B2) and DR-NN too, its fused dense BCE
    (kernel B3) reading the float32 pages themselves, as the JAX package's
    does.  DR-NN's encode, loss and gradients there match tip_tpu's DDModel
    (u24 = 0 in both; float32 throughout: z and loss rtol 1e-5, grads 1e-4
    of their max), and the runner trains it."""
    jdata, tdata = datas
    tr = tdata.dd_train
    s, d = tr.edge_index[:, 0]
    extra = np.array([[s, d], [d, s]] * 257, np.int32).T
    heavy = dataclasses.replace(tdata, dd_train=type(tr)(
        np.concatenate([extra, tr.edge_index], axis=1),
        np.concatenate([np.zeros(extra.shape[1], np.int32), tr.edge_type]),
        tr.range_list + np.where(np.arange(tr.n_et)[:, None] == 0,
                                 [0, extra.shape[1]], extra.shape[1])))
    jheavy = dataclasses.replace(jdata, dd_train=heavy.dd_train)
    model, graph, _ = runner.build_variant("dr-df", heavy, "cpu")
    assert model.gs.dd_layout == "pages"
    assert graph["dd_adj_t"].dtype == torch.float32
    assert float(graph["dd_adj_t"].max()) > 256.0

    jgraph, jgs = j_dd_arrays(jheavy, chunk=CHUNK, dense_dtype="float32",
                              planes=True)
    jmodel = JDDModel.for_data(JDDConfig(decoder="nn", **DD_WIDTHS), jgs,
                               backend="pallas")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(1)))
    graph, gs = make_dd_graph_arrays(heavy, "cpu", chunk=CHUNK,
                                     dense_dtype="float32", decoder="nn")
    assert gs.dd_layout == "pages" and set(graph) == {"dd_deg", "dd_adj_t",
                                                      "dd_neg_q"}
    model = DDModel.for_data(DDConfig(decoder="nn", **DD_WIDTHS), gs, "cpu")
    key = jax.random.key(9)
    with pltpu.force_tpu_interpret_mode():
        jz = np.asarray(jax.jit(jmodel.encode)(_tree(params), jgraph))
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jgraph, key)))(_tree(params))
    z = model.encode(convert.params_from_jax(params), graph).numpy()
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5 * np.abs(jz).max())
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=9, u24=ZERO)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(_grads(tp)),
                            jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))

    model, graph, test = runner.build_variant("dr-nn", heavy, "cpu")
    assert model.gs.dd_layout == "pages" and "dd_adj_u8" not in graph
    _, res = runner.train_variant(model, graph, test, epochs=3, lr=0.05,
                                  seed=3, log=None)
    losses = [h["loss"] for h in res["history"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("variant", runner.VARIANTS)
def test_train_variant_on_cpu(datas, variant):
    _, tdata = datas
    model, graph, test = runner.build_variant(variant, tdata, "cpu")
    if variant.startswith("dr"):
        assert model.gs.dd_layout in ("strips", "strips_pages")
    _, res = runner.train_variant(model, graph, test, epochs=12, lr=0.05,
                                  seed=3, log=None)
    losses = [h["loss"] for h in res["history"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert 0.0 <= res["final"]["auroc"] <= 1.0


@pytest.mark.parametrize("decoder", ["distmult", "nn"])
def test_train_variant_chunked_on_cpu(datas, decoder):
    _, tdata = datas
    graph, gs = make_dd_graph_arrays(tdata, "cpu", chunk=CHUNK,
                                     decoder=decoder)
    model = DDModel.for_data(DDConfig(decoder=decoder, **DD_WIDTHS), gs, "cpu")
    _, res = runner.train_variant(model, graph, make_test_arrays(tdata, "cpu"),
                                  epochs=12, lr=0.05, seed=3, log=None)
    losses = [h["loss"] for h in res["history"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert res["per_relation"]["auroc"].shape == (tdata.n_et,)


def test_build_variant_needs_a_gpu_unless_asked_for_the_cpu(datas):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.build_variant("pp-gae", datas[1])


def test_cli_dr_nn_synthetic_cpu(tmp_path):
    out_json = tmp_path / "m.json"
    out = subprocess.run(
        [sys.executable, "-m", "tip_tpu_torch.models", "--variant", "dr-nn",
         "--synthetic", "--cpu", "--epochs", "2", "--out", str(out_json)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    records = [json.loads(x) for x in lines if x.startswith("{")]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert records[-1]["spans"]["forward"]["count"] == 2
    assert lines[-1].startswith("On test set: auprc:")
    res = json.loads(out_json.read_text())
    assert res["variant"] == "dr-nn" and 0.0 <= res["final"]["auroc"] <= 1.0
