"""The port's full-page D-D layout and the sampled-negative route on the
dense layouts against the JAX package on the CPU.

The layout: the M-first R-GCN pair over the full pages
(``dense_rgcn_pair_apply``), the fused dense BCE over them (kernel B2,
tests/test_torch_dense_bce.py holds the module), TIP-cat, DR-DF and DR-NN
on float32 pages, the bf16 pages a graph falls back to where its strips
cannot be built, and how ``preferred_dense_dtype`` picks them.  The route:
``negatives="sampled"`` on the strips and on the pages, whose positives
``distmult_dense_pos_bce_sum`` scores over the full pages.

Both packages get the same raw graph and the same parameters (convert.py).
JAX runs its ``backend="pallas"`` path in interpret mode, where the dense
kernels draw u24 = 0; the port's dense BCEs get an explicit zero field.
JAX's sampler streams jax.random.bits(key) >> 8 into its kernel; the port's
takes the same draws.  Tolerances: float32 pages are float32 throughout
(loss rtol 1e-5, grads atol 1e-4 of their largest); the strips and bf16
pages re-round activations to bf16, so one bf16 ulp may flip between the
packages (loss rtol 1e-3, grads atol 2e-2 of their largest, as
tests/test_torch_model.py).
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
from tip_tpu.data.packing import pad_dense_adj
from tip_tpu.models import DDConfig as JDDConfig, DDModel as JDDModel
from tip_tpu.models.dd import make_dd_graph_arrays as j_dd_arrays
from tip_tpu.nn.decoders import distmult_dense_pos_bce_sum as j_pos_bce
from tip_tpu.nn.rgcn import dense_rgcn_pair_apply as j_pair
from tip_tpu.train.model import TIP as JTIP
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
from tip_tpu.train.model import preferred_dense_dtype as j_preferred
from tip_tpu_torch import convert
from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.data import TypedEdges, build_trigraph, synthetic_trigraph
from tip_tpu_torch.data.packing import dense_relation_adj
from tip_tpu_torch.models import DDConfig, DDModel, runner
from tip_tpu_torch.models.dd import make_dd_graph_arrays
from tip_tpu_torch.nn.decoders import distmult_dense_pos_bce_sum
from tip_tpu_torch.nn.rgcn import dense_rgcn_pair_apply
from tip_tpu_torch.train import loop, model as tmodel
from tip_tpu_torch.train.model import TIP, make_graph_arrays, pages_tensor

RAW_KW = dict(n_drug=150, n_prot=64, n_et=5, pairs_per_et=120, n_pp_pairs=200,
              n_dp=120, seed=3)
NARROW = dict(prot_drug_dim=8, n_embed=16, n_hid1=16, n_hid2=8, num_base=8,
              pp_hid1=16, pp_hid2=8)
DD_WIDTHS = dict(n_embed=8, n_hid1=8, n_hid2=8, num_base=4,
                 nn_decoder_l1_dim=8)
SMALL = dict(dd_chunk=32, pp_window=64, pp_chunk=32)
ZERO = torch.zeros((), dtype=torch.int64)


@pytest.fixture(scope="module")
def datas():
    jdata = j_build(j_raw(**RAW_KW), split_rate=0.9, seed=5)
    tdata = build_trigraph(synthetic_trigraph(**RAW_KW), split_rate=0.9, seed=5)
    return jdata, tdata


def _tree(params):
    return jax.tree.map(jnp.asarray, params)


def _grads(params):
    return convert.params_to_numpy(jax.tree.map(
        lambda p: p.grad, params, is_leaf=lambda v: isinstance(v, torch.Tensor)))


def _assert_close(loss, grads, jloss, jg, exact):
    """loss and the gradient tree of the port against JAX's."""
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5 if exact else 1e-3)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grads),
                            jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        tol = (1e-4 if exact else 2e-2) * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, err_msg=str(path))


def _asymmetric(data):
    """The graph less one directed edge of relation 0: its page is no
    longer symmetric, so the strips cannot be built."""
    tr = data.dd_train
    src, dst = tr.edge_index
    keep = ~((tr.edge_type == 0) & (src == src[0]) & (dst == dst[0]))
    counts = np.bincount(tr.edge_type[keep], minlength=data.n_et)
    ends = np.cumsum(counts)
    ranges = np.stack([ends - counts, ends], 1).astype(tr.range_list.dtype)
    return dataclasses.replace(data, dd_train=type(tr)(
        tr.edge_index[:, keep], tr.edge_type[keep], ranges))


def _heavy(data, copies=257):
    """The graph with ``copies`` more of one pair in relation 0: a count past
    bf16's (and uint8's) exact range."""
    tr = data.dd_train
    s, d = tr.edge_index[:, 0]
    extra = np.array([[s, d], [d, s]] * copies, np.int32).T
    ranges = tr.range_list.copy()
    ranges[0, 1] += extra.shape[1]
    ranges[1:] += extra.shape[1]
    return dataclasses.replace(data, dd_train=TypedEdges(
        np.concatenate([extra, tr.edge_index], axis=1),
        np.concatenate([np.zeros(extra.shape[1], np.int32), tr.edge_type]),
        ranges))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_rgcn_pair_matches_jax(datas, dtype):
    """Both R-GCN layers over the full pages: float32 pages multiply
    float32 operands, bf16 pages bf16-rounded ones, in both packages."""
    _, tdata = datas
    da = dense_relation_adj(tdata.dd_train, tdata.n_drug)
    rng = np.random.default_rng(1)
    r, n = tdata.n_et, tdata.n_drug
    p1 = {"att": rng.standard_normal((r, 4)), "basis":
          rng.standard_normal((4, 12, 10)) * 0.3,
          "root": rng.standard_normal((12, 10)) * 0.3}
    p2 = {"att": rng.standard_normal((r, 3)), "basis":
          rng.standard_normal((3, 10, 8)) * 0.3,
          "root": rng.standard_normal((10, 8)) * 0.3,
          "bias": rng.standard_normal(8)}
    p1, p2 = ({k: v.astype(np.float32) for k, v in p.items()} for p in (p1, p2))
    x = rng.standard_normal((n, 12)).astype(np.float32)
    deg = np.maximum(da.sum((0, 2)), 1).astype(np.float32)
    jpages = jnp.asarray(pad_dense_adj(da.astype(np.float32))).astype(dtype)
    want = np.asarray(j_pair(_tree(p1), _tree(p2), jnp.asarray(x), jpages,
                             jnp.asarray(deg)))
    t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}  # noqa: E731
    got = dense_rgcn_pair_apply(t(p1), t(p2), torch.from_numpy(x),
                                pages_tensor(da, dtype),
                                torch.from_numpy(deg)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:  # layer 2 re-rounds layer 1's output: one bf16 ulp of the largest
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=2.0**-8 * np.abs(want).max())


@pytest.mark.parametrize("kernel_dtype", ["float32", "bfloat16"])
def test_distmult_dense_pos_bce_matches_jax(datas, kernel_dtype):
    """The positives' BCE over the full pages, value and gradients, over
    more relations than one block of 128 (a clamped last block)."""
    _, tdata = datas
    da = dense_relation_adj(tdata.dd_train, tdata.n_drug)
    da = np.concatenate([da] * 27)  # 135 relations
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((da.shape[0], 8)) * 0.3).astype(np.float32)
    z = (rng.standard_normal((tdata.n_drug, 8)) * 0.5).astype(np.float32)
    jpages = jnp.asarray(pad_dense_adj(da.astype(np.float32)))
    jval, (jdw, jdz) = jax.value_and_grad(
        lambda wz: j_pos_bce(wz[0], wz[1], jpages, kernel_dtype))(
            (jnp.asarray(w), jnp.asarray(z)))
    wt = torch.tensor(w, requires_grad=True)
    zt = torch.tensor(z, requires_grad=True)
    val = distmult_dense_pos_bce_sum(wt, zt, pages_tensor(da, "float32"),
                                     kernel_dtype)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    # bf16 operands: JAX differentiates the bf16 products in bf16, the port
    # in float32, so the gradients agree to bf16's precision only
    rel = 1e-5 if kernel_dtype == "float32" else 2e-2
    for got, want in ((wt.grad, jdw), (zt.grad, jdz)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=rel * np.abs(want).max())


def _tip_pair(datas, dense_dtype, negatives="auto", asymmetric=False):
    """(jax model, jax graph, port model, port graph, params) of TIP-cat."""
    jdata, tdata = datas
    if asymmetric:
        jdata, tdata = _asymmetric(jdata), _asymmetric(tdata)
    jgraph, jgs = j_graph_arrays(jdata, dense_dtype=dense_dtype, **SMALL)
    jmodel = JTIP.for_data(JModelConfig(negatives=negatives, **NARROW), jdata,
                           jgs, backend="pallas")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0)))
    graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype=dense_dtype,
                                  sampled=negatives == "sampled", **SMALL)
    model = TIP.for_data(ModelConfig(negatives=negatives, **NARROW), tdata, gs,
                         "cpu")
    return jmodel, jgraph, model, graph, params


def _sampler_bits(key, gs):
    return torch.from_numpy(np.asarray(jax.random.bits(
        key, (gs.dd_n_chunks, 1, gs.dd_chunk), jnp.uint32) >> 8
    ).astype(np.int32))


@pytest.mark.parametrize("case", ["float32_pages", "bf16_fallback",
                                  "sampled_strips", "sampled_pages"])
def test_tip_loss_and_grads_match_jax(datas, case):
    dense_dtype = "float32" if case.endswith("pages") else "bfloat16"
    negatives = "sampled" if case.startswith("sampled") else "auto"
    jmodel, jgraph, model, graph, params = _tip_pair(
        datas, dense_dtype, negatives, asymmetric=case == "bf16_fallback")
    assert model.gs.dd_layout == ("strips" if case == "sampled_strips"
                                  else "pages")
    assert ("dd_adj_sym" in jgraph) == (model.gs.dd_layout == "strips")
    key = jax.random.key(9)
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jgraph, key)))(_tree(params))
    u24 = _sampler_bits(key, model.gs) if negatives == "sampled" else ZERO
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=9, u24=u24)
    loss.backward()
    _assert_close(loss.item(), _grads(tp), jloss, jg,
                  exact=dense_dtype == "float32")


@pytest.mark.parametrize("decoder", ["distmult", "nn"])
def test_dd_on_float32_pages_matches_jax(datas, decoder):
    jdata, tdata = datas
    jgraph, jgs = j_dd_arrays(jdata, chunk=32, dense_dtype="float32",
                              planes=True)
    jmodel = JDDModel.for_data(JDDConfig(decoder=decoder, **DD_WIDTHS), jgs,
                               backend="pallas")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(1)))
    graph, gs = make_dd_graph_arrays(tdata, "cpu", chunk=32,
                                     dense_dtype="float32", decoder=decoder)
    model = DDModel.for_data(DDConfig(decoder=decoder, **DD_WIDTHS), gs, "cpu")
    assert gs.dd_layout == "pages" and graph["dd_adj_t"].dtype == torch.float32
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
    _assert_close(loss.item(), _grads(tp), jloss, jg, exact=True)


def test_dr_df_sampled_on_strips_matches_jax(datas):
    jdata, tdata = datas
    jgraph, jgs = j_dd_arrays(jdata, chunk=32, dense_dtype="bfloat16",
                              planes=True)
    jmodel = JDDModel.for_data(JDDConfig(negatives="sampled", **DD_WIDTHS),
                               jgs, backend="pallas")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(1)))
    graph, gs = make_dd_graph_arrays(tdata, "cpu", chunk=32,
                                     dense_dtype="bfloat16", sampled=True)
    model = DDModel.for_data(DDConfig(negatives="sampled", **DD_WIDTHS), gs,
                             "cpu")
    assert gs.dd_layout == "strips" and gs.dd_sampled
    key = jax.random.key(4)
    with pltpu.force_tpu_interpret_mode():
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jgraph, key)))(_tree(params))
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=4, u24=_sampler_bits(key, gs))
    loss.backward()
    _assert_close(loss.item(), _grads(tp), jloss, jg, exact=False)


@pytest.mark.parametrize("precision", ["default", "bfloat16", "float32",
                                       "highest"])
@pytest.mark.parametrize("kernel_dtype", ["float32", "bfloat16"])
def test_preferred_dense_dtype_precision_gate_matches_jax(
        datas, kernel_dtype, precision):
    """float32 kernels with float32 matmuls pinned take the float32 pages;
    otherwise bf16 pages (the strips) are preferred, and a count past 256
    sends a float32 kernel to the float32 pages."""
    jdata, tdata = datas
    for jd, td in ((jdata, tdata), (_heavy(jdata), _heavy(tdata))):
        with jax.default_matmul_precision(precision):
            want = j_preferred(jd, kernel_dtype)
        got = tmodel.preferred_dense_dtype(td, kernel_dtype, precision)
        assert got == want, (kernel_dtype, precision)
    pinned = kernel_dtype == "float32" and precision in ("float32", "highest")
    assert (tmodel.preferred_dense_dtype(tdata, kernel_dtype, precision)
            == ("float32" if pinned else "bfloat16"))


def test_train_and_build_variant_take_the_float32_pages_when_pinned(
        datas, monkeypatch):
    _, tdata = datas
    seen = []

    def spy(*args, **kw):
        out = make_graph_arrays(*args, **kw)
        seen.append((out[1].dd_layout, str(out[0]["dd_adj_t"].dtype)))
        return out

    monkeypatch.setattr(loop, "make_graph_arrays", spy)
    _, res = loop.train(ModelConfig(**NARROW), TrainConfig(epochs=2), tdata,
                        log=lambda s: None, device="cpu",
                        matmul_precision="highest")
    assert seen == [("pages", "torch.float32")]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    for variant in ("dr-df", "dr-nn"):
        model, graph, _ = runner.build_variant(variant, tdata, "cpu",
                                               matmul_precision="float32")
        assert model.gs.dd_layout == "pages"
        assert graph["dd_adj_t"].dtype == torch.float32


@pytest.mark.parametrize("cli", ["train", "models"])
def test_clis_read_the_matmul_precision_variable(monkeypatch, cli):
    """$JAX_DEFAULT_MATMUL_PRECISION=highest, which pins the JAX package's
    CLIs to float32 matmuls, sends the port's CLIs to the float32 pages."""
    from tip_tpu_torch.models import __main__ as models_cli
    from tip_tpu_torch.train import __main__ as train_cli

    seen = []
    mod, name = (loop, "make_graph_arrays") if cli == "train" else (
        runner, "make_dd_graph_arrays")
    real = getattr(mod, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[1].dd_layout)
        return out

    monkeypatch.setattr(mod, name, spy)
    monkeypatch.setenv("JAX_DEFAULT_MATMUL_PRECISION", "highest")
    argv = ["--synthetic", "--cpu", "--epochs", "1"]
    if cli == "train":
        train_cli.main(argv)
    else:
        models_cli.main(["--variant", "dr-df"] + argv)
    assert seen == ["pages"]


def test_what_each_dense_graph_ships(datas):
    _, tdata = datas
    ship = lambda **kw: set(make_graph_arrays(tdata, "cpu", **kw)[0])  # noqa: E731
    dd = lambda **kw: set(make_dd_graph_arrays(tdata, "cpu", **kw)[0])  # noqa: E731
    chunks = {"dd_src2d", "dd_dst2d", "dd_valid", "dd_chunk_type", "dd_bitmap"}
    assert {"dd_adj_t", "dd_neg_q"} <= ship(dense_dtype="float32")
    assert not chunks & ship(dense_dtype="float32")
    sampled = ship(dense_dtype="bfloat16", sampled=True)
    assert chunks | {"dd_adj_sym", "dd_adj_t"} <= sampled
    assert not {"dd_neg_q8", "dd_neg_q"} & sampled
    # DR-NN's B3 reads the float32 pages themselves: no uint8 copy
    assert dd(dense_dtype="float32", decoder="nn") == {
        "dd_deg", "dd_adj_t", "dd_neg_q"}
    assert dd(dense_dtype="float32", decoder="nn", sampled=True) == (
        {"dd_deg", "dd_adj_t"} | chunks)


def test_the_raises_that_remain(datas):
    _, tdata = datas
    heavy = _heavy(tdata)
    # a count past 255 rides DR-NN's float32 pages (kernel B3 reads them)
    graph, gs = make_dd_graph_arrays(heavy, "cpu", dense_dtype="float32",
                                     decoder="nn")
    assert gs.dd_layout == "pages" and float(graph["dd_adj_t"].max()) > 255
    # a graph packed for one negatives route refuses the other
    _, strips = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16")
    _, sampled = make_graph_arrays(tdata, "cpu", dense_dtype="float32",
                                   sampled=True)
    with pytest.raises(ValueError, match="sampled=True"):
        TIP.for_data(ModelConfig(negatives="sampled"), tdata, strips, "cpu")
    with pytest.raises(ValueError, match="sampled=False"):
        TIP.for_data(ModelConfig(), tdata, sampled, "cpu")
    with pytest.raises(ValueError, match="sampled=False"):
        DDModel.for_data(DDConfig(negatives="poisson"), sampled, "cpu")
    with pytest.raises(ValueError, match="dense_dtype"):
        make_graph_arrays(tdata, "cpu", dense_dtype="float16")
    # TIP's NN decoder takes the sampled route: Poissonized negatives raise
    # the JAX package's message, and a graph packed for the Poissonized
    # route (no chunk buffers) is refused
    _, nn_pages = make_graph_arrays(tdata, "cpu", dense_dtype="float32",
                                    decoder="nn")
    with pytest.raises(ValueError, match="negatives='poisson' was pinned"):
        TIP.for_data(ModelConfig(decoder="nn", negatives="poisson"), tdata,
                     nn_pages, "cpu")
    with pytest.raises(ValueError, match="decoder='nn'"):
        TIP.for_data(ModelConfig(decoder="nn"), tdata, strips, "cpu")
    TIP.for_data(ModelConfig(decoder="nn"), tdata, nn_pages, "cpu")
