"""The port's chunked beyond-dense slice against the JAX package on the
CPU: the encoder (kernels B5, B4), TIP.loss with sampled negatives
(kernels B10, B8) and its gradients, a few Adam steps and the eval, and
how graphs are routed between the layouts.

One small graph is forced onto the chunked layout (dense_dtype None, small
chunks and windows, as tests/test_pallas.py does); JAX runs its
``backend="pallas"`` path in interpret mode, the port its plain versions.
Tolerances are test_pallas.py's backend-parity ones: z atol 1e-4, loss rtol
1e-5, gradients atol 2e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.config import ModelConfig as JModelConfig
from tip_tpu.data import build_trigraph as j_build, synthetic_trigraph as j_raw
from tip_tpu.train.model import TIP as JTIP
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
from tip_tpu.train.model import preferred_dense_dtype as j_preferred
from tip_tpu_torch import convert
from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.data import TypedEdges, build_trigraph, synthetic_trigraph
from tip_tpu_torch.sampling.negative import bitmap_stride_bits
from tip_tpu_torch.train import loop, model as tmodel
from tip_tpu_torch.train.model import TIP, make_graph_arrays, make_test_arrays

RAW_KW = dict(n_drug=40, n_prot=70, n_et=5, pairs_per_et=50, seed=4)
SMALL = dict(dd_chunk=32, pp_window=64, pp_chunk=32)
WIDTHS = dict(mode="cat", prot_drug_dim=6, n_embed=10, n_hid1=8, n_hid2=6,
              num_base=4, pp_hid1=8, pp_hid2=6)


@pytest.fixture(scope="module")
def setup():
    jdata = j_build(j_raw(**RAW_KW), split_rate=0.9, seed=4)
    tdata = build_trigraph(synthetic_trigraph(**RAW_KW), split_rate=0.9, seed=4)
    jgraph, jgs = j_graph_arrays(jdata, **SMALL)
    jmodel = JTIP.for_data(JModelConfig(**WIDTHS), jdata, jgs, backend="pallas")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0)))
    graph, gs = make_graph_arrays(tdata, "cpu", **SMALL)
    model = TIP.for_data(ModelConfig(**WIDTHS), tdata, gs, device="cpu")
    return jdata, tdata, jgraph, jmodel, graph, model, params


def test_graph_is_chunked(setup):
    *_, graph, model, _ = setup
    assert (model.gs.dd_layout, model.gs.pp_layout) == ("chunked", "windowed")
    assert "dd_adj_sym" not in graph and "pp_a1" not in graph
    assert {"dd_src2d", "dd_bitmap", "ppw_src"} <= set(graph)


def test_encoder_matches_jax_pallas(setup):
    _, _, jgraph, jmodel, graph, model, params = setup
    with pltpu.force_tpu_interpret_mode():
        jz = np.asarray(jmodel.encode(jax.tree.map(jnp.asarray, params),
                                      jgraph))
    z = model.encode(convert.params_from_jax(params), graph)
    np.testing.assert_allclose(z.numpy(), jz, atol=1e-4)


def test_loss_and_grads_match_jax_pallas_under_the_same_bits(setup):
    """JAX's sampler streams jax.random.bits(key) >> 8 into its kernel on
    the CPU; the port's loss takes the same draws through ``u24``."""
    _, _, jgraph, jmodel, graph, model, params = setup
    key = jax.random.key(9)
    gs = model.gs
    u24 = np.asarray(jax.random.bits(key, (gs.dd_n_chunks, 1, gs.dd_chunk),
                                     jnp.uint32) >> 8).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = jax.value_and_grad(lambda p: jmodel.loss(p, jgraph, key))(
            jax.tree.map(jnp.asarray, params))
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=9, u24=torch.from_numpy(u24))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    tg = convert.params_to_numpy(jax.tree.map(
        lambda p: p.grad, tp, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(tg),
                            jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(g, w, atol=2e-4, err_msg=str(path))


def test_adam_steps_and_evaluate_on_cpu(setup):
    _, tdata, _, _, graph, model, params = setup
    tp = convert.params_from_jax(params, requires_grad=True)
    opt = torch.optim.Adam(convert.leaves(tp), lr=0.01)
    losses = []
    for k in range(4):
        opt.zero_grad()
        loss = model.loss(tp, graph, seed=loop.step_seed(0, k))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    test = make_test_arrays(tdata, device="cpu")
    neg = model.sample_test_negatives(torch.Generator().manual_seed(1), test)
    per, avg = model.evaluate(tp, graph, test, neg)
    assert per["auroc"].shape == (tdata.n_et,)
    for k in ("auprc", "auroc", "ap"):
        assert 0.0 <= float(avg[k]) <= 1.0


def test_strips_with_windowed_pp_match_jax_pallas(setup):
    """pp_dense=False beside the strips: the windowed P-P kernel feeds the
    M-first R-GCN pair (layer 2 re-rounds layer 1's output to bf16: one
    bf16 ulp of the largest magnitude, as tests/test_torch_layers.py)."""
    jdata, tdata, _, jmodel, _, _, params = setup
    jgraph, jgs = j_graph_arrays(jdata, dense_dtype="bfloat16", pp_dense=False,
                                 **SMALL)
    jm = JTIP.for_data(jmodel.cfg, jdata, jgs, backend="pallas")
    graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16",
                                  pp_dense=False, **SMALL)
    assert "ppw_src" in graph and "pp_a1" not in graph and "dd_adj_sym" in graph
    assert (gs.dd_layout, gs.pp_layout) == ("strips", "windowed")
    with pltpu.force_tpu_interpret_mode():
        jz = np.asarray(jm.encode(jax.tree.map(jnp.asarray, params), jgraph))
    z = TIP.for_data(ModelConfig(**WIDTHS), tdata, gs, "cpu").encode(
        convert.params_from_jax(params), graph).numpy()
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=2.0**-8 * np.abs(jz).max())


def test_train_routes_a_graph_beyond_the_dense_budget_to_chunked(
        setup, monkeypatch):
    _, tdata, *_ = setup
    seen = []

    def spy(*args, **kw):
        out = make_graph_arrays(*args, **kw)
        seen.append(out[1].dd_layout)
        return out

    monkeypatch.setattr(tmodel, "dense_rgcn_feasible", lambda *a: False)
    monkeypatch.setattr(loop, "make_graph_arrays", spy)
    assert tmodel.preferred_dense_dtype(tdata) is None
    _, res = loop.train(ModelConfig(**WIDTHS), TrainConfig(epochs=2), tdata,
                        log=lambda s: None, device="cpu")
    assert seen == ["chunked"]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert 0.0 <= res["final"]["auroc"] <= 1.0


def test_float32_page_graph_raises_naming_b2(setup):
    """Counts beyond bf16's exact range (> 256 copies of one edge) send the
    JAX package to the float32 full pages, and train() takes them too: the
    fused dense BCE over the pages, kernel B2."""
    jdata, tdata, *_ = setup
    tr = tdata.dd_train
    s, d = tr.edge_index[:, 0]
    extra = np.array([[s, d], [d, s]] * 257, np.int32).T
    ei = np.concatenate([extra, tr.edge_index], axis=1)
    et = np.concatenate([np.zeros(extra.shape[1], np.int32), tr.edge_type])
    ranges = tr.range_list.copy()
    ranges[0, 1] += extra.shape[1]
    ranges[1:] += extra.shape[1]
    heavy = dataclasses.replace(tdata, dd_train=TypedEdges(ei, et, ranges))
    jheavy = dataclasses.replace(jdata, dd_train=heavy.dd_train)
    assert j_preferred(jheavy) == "float32"
    assert tmodel.preferred_dense_dtype(heavy) == "float32"
    graph, gs = make_graph_arrays(heavy, "cpu", dense_dtype="float32")
    assert gs.dd_layout == "pages" and graph["dd_adj_t"].dtype == torch.float32
    assert float(graph["dd_adj_t"].max()) > 256.0
    _, res = loop.train(ModelConfig(**WIDTHS), TrainConfig(epochs=1), heavy,
                        log=lambda s: None, device="cpu")
    assert all(np.isfinite(h["loss"]) for h in res["history"])


def test_negatives_options_per_layout(setup):
    _, tdata, _, _, _, model, _ = setup
    with pytest.raises(ValueError, match="negatives='poisson'"):
        TIP.for_data(ModelConfig(negatives="poisson", **WIDTHS), tdata,
                     model.gs, "cpu")
    TIP.for_data(ModelConfig(negatives="sampled", **WIDTHS), tdata, model.gs,
                 "cpu")
    _, strips = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16")
    # sampled negatives read the chunk buffers, which a graph packed for the
    # Poissonized route does not ship
    with pytest.raises(ValueError, match="sampled=True"):
        TIP.for_data(ModelConfig(negatives="sampled", **WIDTHS), tdata, strips,
                     "cpu")
    _, sampled = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16",
                                   sampled=True, **SMALL)
    assert (sampled.dd_layout, sampled.dd_sampled) == ("strips", True)
    TIP.for_data(ModelConfig(negatives="sampled", **WIDTHS), tdata, sampled,
                 "cpu")
    _, pages = make_graph_arrays(tdata, "cpu", dense_dtype="float32")
    assert pages.dd_layout == "pages"
    TIP.for_data(ModelConfig(negatives="poisson", **WIDTHS), tdata, pages,
                 "cpu")


def test_int32_key_space_check(setup):
    _, tdata, _, _, _, model, _ = setup
    n_et = 2**31 // bitmap_stride_bits(tdata.n_drug) + 1
    with pytest.raises(ValueError, match="int32"):
        TIP.for_data(ModelConfig(**WIDTHS),
                     dataclasses.replace(tdata, n_et=n_et), model.gs, "cpu")
