"""TIP with the NN decoder (tip_tpu_torch/train/model.py) against the JAX
package's TIP-NN on the CPU, on the three D-D layouts: the strips, the
float32 pages and the chunked layout.

The JAX package's TIP takes the sampled route for the NN decoder on every
layout (its fused dense BCEs are DistMult-only): B10 draws one negative a
slot and B9 scores the positives over the chunk buffers and the negatives
over the draws.  Both packages get the same raw graph and the same
parameters (convert.py); JAX runs ``backend="pallas"`` in interpret mode,
where its sampler streams jax.random.bits(key) >> 8 into its kernel, and
the port's sampler takes the same draws through ``u24``.  Tolerances are
those of the files that hold each layout: the strips re-round activations
to bf16 (z one bf16 ulp of its max, loss rtol 1e-3, grads 2e-2 of their
max; tests/test_torch_model.py), the float32 pages and the chunked layout
are float32 throughout (loss rtol 1e-5, grads 1e-4 of their max on the
pages, tests/test_torch_pages.py; z atol 1e-4, grads atol 2e-4 chunked,
tests/test_torch_chunked.py).  The eval's metrics agree to atol 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.config import ModelConfig as JModelConfig
from tip_tpu.data import build_trigraph as j_build, synthetic_trigraph as j_raw
from tip_tpu.train.model import TIP as JTIP
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
from tip_tpu.train.model import make_test_arrays as j_test_arrays
from tip_tpu_torch import convert, kernels
from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.train import loop
from tip_tpu_torch.train.model import (
    POISSON_NEEDS_DENSE,
    TIP,
    make_graph_arrays,
    make_test_arrays,
)

RAW_KW = dict(n_drug=150, n_prot=64, n_et=5, pairs_per_et=120, n_pp_pairs=200,
              n_dp=120, seed=3)
WIDTHS = dict(prot_drug_dim=8, n_embed=16, n_hid1=16, n_hid2=8, num_base=8,
              pp_hid1=16, pp_hid2=8, decoder="nn")
SMALL = dict(dd_chunk=32, pp_window=64, pp_chunk=32)
LAYOUTS = {"strips": "bfloat16", "pages": "float32", "chunked": None}
CHUNKS = {"dd_src2d", "dd_dst2d", "dd_valid", "dd_chunk_type", "dd_bitmap"}


@pytest.fixture(scope="module")
def datas():
    jdata = j_build(j_raw(**RAW_KW), split_rate=0.9, seed=5)
    tdata = build_trigraph(synthetic_trigraph(**RAW_KW), split_rate=0.9, seed=5)
    return jdata, tdata


@pytest.fixture(scope="module")
def params(datas):
    jgraph, jgs = j_graph_arrays(datas[0], **SMALL)
    jmodel = JTIP.for_data(JModelConfig(**WIDTHS), datas[0], jgs,
                           backend="pallas")
    return jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0)))


def _pair(datas, layout):
    """(jax model, jax graph, port model, port graph) of TIP-NN."""
    jdata, tdata = datas
    dense_dtype = LAYOUTS[layout]
    jgraph, jgs = j_graph_arrays(jdata, dense_dtype=dense_dtype, **SMALL)
    jmodel = JTIP.for_data(JModelConfig(**WIDTHS), jdata, jgs, backend="pallas")
    graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype=dense_dtype,
                                  decoder="nn", **SMALL)
    model = TIP.for_data(ModelConfig(**WIDTHS), tdata, gs, "cpu")
    assert gs.dd_layout == layout
    return jmodel, jgraph, model, graph


def _tree(p):
    return jax.tree.map(jnp.asarray, p)


def _bits(key, gs):
    return torch.from_numpy(np.asarray(jax.random.bits(
        key, (gs.dd_n_chunks, 1, gs.dd_chunk), jnp.uint32) >> 8
    ).astype(np.int32))


def _grads(tp):
    return convert.params_to_numpy(jax.tree.map(
        lambda p: p.grad, tp, is_leaf=lambda v: isinstance(v, torch.Tensor)))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tip_nn_encode_loss_and_grads_match_jax(datas, params, layout):
    jmodel, jgraph, model, graph = _pair(datas, layout)
    key = jax.random.key(9)
    with pltpu.force_tpu_interpret_mode():
        jz = np.asarray(jax.jit(jmodel.encode)(_tree(params), jgraph))
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jgraph, key)))(_tree(params))
    z = model.encode(convert.params_from_jax(params), graph).numpy()
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=9, u24=_bits(key, model.gs))
    loss.backward()
    if layout == "strips":
        ztol, ltol, gtol = 2.0**-8 * np.abs(jz).max(), 1e-3, 2e-2
    elif layout == "pages":
        ztol, ltol, gtol = 1e-5 * np.abs(jz).max(), 1e-5, 1e-4
    else:
        ztol, ltol, gtol = 1e-4, 1e-5, None
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=ztol)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=ltol)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(_grads(tp)),
                            jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        atol = 2e-4 if gtol is None else gtol * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("layout", ["pages", "chunked"])
def test_tip_nn_adam_steps_match_optax(datas, params, layout):
    """Three Adam steps under the same sampler bits per step: the losses of
    the two packages within the layout's loss tolerance (float32)."""
    jmodel, jgraph, model, graph = _pair(datas, layout)
    opt = optax.adam(0.01)
    jp = _tree(params)
    state = opt.init(jp)

    @jax.jit
    def step(p, state, key):
        lv, g = jax.value_and_grad(lambda p: jmodel.loss(p, jgraph, key))(p)
        upd, state = opt.update(g, state, p)
        return optax.apply_updates(p, upd), state, lv

    jlosses = []
    with pltpu.force_tpu_interpret_mode():
        for k in range(3):
            jp, state, lv = step(jp, state, jax.random.key(k))
            jlosses.append(float(lv))
    tp = convert.params_from_jax(params, requires_grad=True)
    topt = torch.optim.Adam(convert.leaves(tp), lr=0.01, eps=1e-8)
    tlosses = []
    for k in range(3):
        topt.zero_grad()
        loss = model.loss(tp, graph, seed=k,
                          u24=_bits(jax.random.key(k), model.gs))
        loss.backward()
        topt.step()
        tlosses.append(loss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[2] < tlosses[0]


@pytest.mark.parametrize("layout", ["pages", "chunked"])
def test_tip_nn_evaluate_matches_jax(datas, params, layout):
    """The eval scores the test edges flat (nn_decoder_apply, no kernel)
    from the encoder's z; given the same test negatives, per-relation and
    macro metrics agree."""
    jmodel, jgraph, model, graph = _pair(datas, layout)
    jtest = j_test_arrays(datas[0])
    jneg = jax.jit(jmodel.sample_test_negatives)(jax.random.key(2), jtest)
    with pltpu.force_tpu_interpret_mode():
        jper, javg = jax.jit(jmodel.evaluate)(_tree(params), jgraph, jtest,
                                              jneg)
    neg = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
           for k, v in jneg.items()}
    per, avg = model.evaluate(convert.params_from_jax(params), graph,
                              make_test_arrays(datas[1], "cpu"), neg)
    for k in ("auprc", "auroc", "ap"):
        np.testing.assert_allclose(per[k].numpy(), np.asarray(jper[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(avg[k]), float(javg[k]), atol=1e-5)


def test_tip_nn_params_round_trip_from_jax(params):
    """The NN decoder's four leaves come over from the JAX pytree, leaf for
    leaf, and match the port's own init in keys and shapes."""
    back = convert.params_to_numpy(convert.params_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(params["decoder"]) == {"w1_l1", "w2_l1", "w1_l2", "w2_l2"}


def test_tip_nn_init_matches_jax_layout(datas, params):
    _, tdata = datas
    _, gs = make_graph_arrays(tdata, "cpu", decoder="nn", **SMALL)
    mine = TIP.for_data(ModelConfig(**WIDTHS), tdata, gs, "cpu").init(
        torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    assert jax.tree.map(lambda t: tuple(t.shape), mine,
                        is_leaf=lambda v: isinstance(v, torch.Tensor)) == shapes


def test_what_tip_nn_graphs_ship(datas):
    """The encoder's layout, the chunk buffers and the bitmap: no
    Poissonized thresholds and no pages beyond what the encoder reads."""
    _, tdata = datas
    dd_keys = {"dd_adj_sym", "dd_adj_t", "dd_adj_u8", "dd_neg_q", "dd_neg_q8"}

    def ship(dense_dtype):
        graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype=dense_dtype,
                                      decoder="nn", **SMALL)
        return set(graph), gs

    strips, gs = ship("bfloat16")
    assert (gs.dd_layout, gs.dd_sampled, gs.dd_decoder) == ("strips", True, "nn")
    assert CHUNKS <= strips and strips & dd_keys == {"dd_adj_sym"}
    pages, gs = ship("float32")
    assert gs.dd_layout == "pages" and pages & dd_keys == {"dd_adj_t"}
    assert CHUNKS <= pages
    chunked, gs = ship(None)
    assert gs.dd_layout == "chunked" and CHUNKS <= chunked
    assert not chunked & dd_keys


def test_tip_nn_negatives_options_and_raises(datas):
    _, tdata = datas
    _, nn_strips = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16",
                                     decoder="nn", **SMALL)
    _, strips = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16")
    for negatives in ("auto", "sampled"):
        TIP.for_data(ModelConfig(negatives=negatives, **WIDTHS), tdata,
                     nn_strips, "cpu")
    # the JAX package's message: the fused dense BCE is DistMult-only
    with pytest.raises(ValueError, match="negatives='poisson' was pinned"):
        TIP.for_data(ModelConfig(negatives="poisson", **WIDTHS), tdata,
                     nn_strips, "cpu")
    assert "distmult decoder" in POISSON_NEEDS_DENSE
    # a graph packed for the Poissonized route ships no chunk buffers
    with pytest.raises(ValueError, match="decoder='nn'"):
        TIP.for_data(ModelConfig(**WIDTHS), tdata, strips, "cpu")
    # DistMult's sampled positives read pages an NN graph does not ship
    with pytest.raises(ValueError, match="decoder='distmult'"):
        TIP.for_data(ModelConfig(negatives="sampled"), tdata, nn_strips, "cpu")
    with pytest.raises(ValueError, match="unknown decoder"):
        make_graph_arrays(tdata, "cpu", decoder="mlp")


def test_train_and_cli_take_the_nn_decoder(datas, monkeypatch):
    """train() packs with the model's decoder on the layout
    preferred_dense_dtype picks; the CLI's --decoder nn trains and
    evaluates on the CPU, and without --cpu needs a GPU."""
    from tip_tpu_torch.train import __main__ as cli

    _, tdata = datas
    seen = []

    def spy(*args, **kw):
        out = make_graph_arrays(*args, **kw)
        seen.append((out[1].dd_layout, kw.get("decoder")))
        return out

    monkeypatch.setattr(loop, "make_graph_arrays", spy)
    kernels.reset_launch_counts()
    _, res = loop.train(ModelConfig(**WIDTHS), TrainConfig(epochs=3), tdata,
                        log=lambda s: None, device="cpu")
    assert seen == [("strips", "nn")]
    losses = [h["loss"] for h in res["history"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert res["per_relation"]["auroc"].shape == (tdata.n_et,)
    assert not any(kernels.LAUNCHES.values())  # CPU tensors: plain versions
    seen.clear()
    cli.main(["--synthetic", "--cpu", "--decoder", "nn", "--epochs", "1"])
    assert [d for _, d in seen] == ["nn"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--synthetic", "--decoder", "nn", "--epochs", "1"])
