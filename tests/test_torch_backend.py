"""The port's ``backend="xla"`` route against the JAX package's, on the CPU.

Each op's XLA branch (the flat typed neighbour sum, the R-GCN layers, the
padded decoders, the three dense BCE fallbacks, the COO P-P GCN) takes the
same seeded numpy inputs in both packages; the whole model's encode and
loss under ``backend="xla"`` are held against the JAX package's on the
strips, the float32 pages and the chunked layout.  Where the draws differ
by design (threefry in JAX, the port's hash or generator) the comparison
is made deterministic: the dense BCEs with their thresholds at 0 (no
negatives), the chunked loss with the port's own negatives scored in JAX.
Tolerances: float32 in another summation order, rtol 1e-5 (atol 1e-5 of
the largest magnitude for values near zero); the dense BCE gradients 1e-4
relative, as tests/test_torch_dense_bce*.py hold the plain versions.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tip_tpu.config import ModelConfig as JModelConfig
from tip_tpu.data import build_trigraph as j_build, synthetic_trigraph as j_raw
from tip_tpu.nn.decoders import distmult_apply_padded as j_distmult_padded
from tip_tpu.nn.decoders import nn_decoder_apply_padded as j_nn_padded
from tip_tpu.nn.encoders import pp_encoder_apply as j_pp_encoder_apply
from tip_tpu.nn.rgcn import rgcn_apply as j_rgcn_apply
from tip_tpu.nn.rgcn import rgcn_apply_padded as j_rgcn_apply_padded
from tip_tpu.ops import typed_neighbor_sum as j_typed_neighbor_sum
from tip_tpu.ops.pallas_dense_bce import dense_bce_sum_xla as j_bce_xla
from tip_tpu.ops.pallas_dense_bce_nn import dense_bce_nn_sum_xla as j_bce_nn_xla
from tip_tpu.ops.pallas_dense_bce_sym import dense_bce_sym_sum_xla as j_sym_xla
from tip_tpu.train.model import TIP as JTIP
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
from tip_tpu_torch import convert
from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.data.packing import (
    cast_dense_adj,
    dense_relation_adj,
    sym_strip_pack,
)
from tip_tpu_torch.nn.decoders import (
    distmult_apply_padded,
    nn_decoder_apply_padded,
)
from tip_tpu_torch.nn.encoders import pp_encoder_apply
from tip_tpu_torch.nn.rgcn import rgcn_apply, rgcn_apply_padded
from tip_tpu_torch.ops.dense_bce import dense_bce_sum, dense_bce_sum_xla
from tip_tpu_torch.ops.dense_bce_nn import dense_bce_nn_sum_xla
from tip_tpu_torch.ops.dense_bce_sym import dense_bce_sym_sum_xla
from tip_tpu_torch.ops.segment import typed_neighbor_sum
from tip_tpu_torch.sampling import typed_negative_sampling_chunked
from tip_tpu_torch.sampling.negative import collides
from tip_tpu_torch.train.model import TIP, make_graph_arrays, resolve_backend

RAW = dict(n_drug=150, n_prot=64, n_et=5, pairs_per_et=120, n_pp_pairs=200,
           n_dp=120, seed=3)
PACK = dict(dd_chunk=32, pp_window=64, pp_chunk=32)
NARROW = dict(prot_drug_dim=8, n_embed=16, n_hid1=16, n_hid2=8, num_base=8,
              pp_hid1=16, pp_hid2=8)


@pytest.fixture(scope="module")
def both():
    return (j_build(j_raw(**RAW), split_rate=0.9, seed=3),
            build_trigraph(synthetic_trigraph(**RAW), split_rate=0.9, seed=3))


@pytest.fixture(scope="module")
def chunked(both):
    jd, td = both
    jg, _ = j_graph_arrays(jd, **PACK)
    tg, tgs = make_graph_arrays(td, "cpu", dense_dtype=None, **PACK)
    return jg, tg, tgs


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _rgcn_params(rng, d_in, d_out, n_et, n_base):
    return {"att": rng.normal(size=(n_et, n_base)).astype(np.float32),
            "basis": rng.normal(size=(n_base, d_in, d_out)).astype(np.float32),
            "root": rng.normal(size=(d_in, d_out)).astype(np.float32),
            "bias": rng.normal(size=(d_out,)).astype(np.float32)}


def _tree(p, torch_leaves: bool):
    return (convert.params_from_jax(p) if torch_leaves
            else jax.tree.map(jnp.asarray, p))


def test_typed_neighbor_sum_and_rgcn_apply_match_jax(both):
    td = both[1]
    rng = np.random.default_rng(0)
    src, dst = td.dd_train.edge_index.astype(np.int64)
    et = td.dd_train.edge_type.astype(np.int64)
    order = np.lexsort((dst, et))  # (type, dst)-sorted, as the JAX op wants
    src, dst, et = src[order], dst[order], et[order]
    n, n_et = td.n_drug, td.n_et
    x = rng.normal(size=(n, 6)).astype(np.float32)
    want = j_typed_neighbor_sum(jnp.asarray(x), jnp.asarray(src),
                                jnp.asarray(dst), jnp.asarray(et), n, n_et)
    t = [torch.from_numpy(a) for a in (x, src, dst, et)]
    _close(typed_neighbor_sum(*t, n, n_et), want)
    params = _rgcn_params(rng, 6, 5, n_et, 3)
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    want = j_rgcn_apply(_tree(params, False), jnp.asarray(x), jnp.asarray(src),
                        jnp.asarray(dst), jnp.asarray(et), jnp.asarray(deg),
                        n, n_et)
    got = rgcn_apply(_tree(params, True), t[0], t[1], t[2], t[3],
                     torch.from_numpy(deg), n, n_et)
    _close(got, want)


def test_rgcn_apply_padded_xla_matches_jax_and_the_kernel_route(both,
                                                                chunked):
    jg, tg, tgs = chunked
    rng = np.random.default_rng(1)
    n, n_et = tgs.n_drug, tgs.n_et
    x = rng.normal(size=(n, 7)).astype(np.float32)
    params = _rgcn_params(rng, 7, 4, n_et, 3)
    dd = ("dd_src2d", "dd_dst2d", "dd_chunk_type", "dd_deg")
    want = j_rgcn_apply_padded(_tree(params, False), jnp.asarray(x),
                               *(jg[k] for k in dd), n, n_et, backend="xla")
    tp = _tree(params, True)
    xt = torch.from_numpy(x)
    got = rgcn_apply_padded(tp, xt, *(tg[k] for k in dd), n, n_et,
                            backend="xla")
    _close(got, want)
    _close(rgcn_apply_padded(tp, xt, *(tg[k] for k in dd), n, n_et,
                             backend="pallas"), want)
    with pytest.raises(ValueError, match="unknown backend"):
        rgcn_apply_padded(tp, xt, *(tg[k] for k in dd), n, n_et,
                          backend="tpu")


@pytest.mark.parametrize("decoder", ["distmult", "nn"])
def test_padded_decoders_xla_match_jax(chunked, decoder):
    jg, tg, tgs = chunked
    rng = np.random.default_rng(2)
    n, n_et = tgs.n_drug, tgs.n_et
    z = rng.normal(size=(n, 8)).astype(np.float32)
    if decoder == "distmult":
        params = {"weight": rng.normal(size=(n_et, 8)).astype(np.float32)}
        j_fn, t_fn = j_distmult_padded, distmult_apply_padded
    else:
        params = {k: rng.normal(size=s).astype(np.float32) for k, s in (
            ("w1_l1", (8, 5)), ("w2_l1", (8, 5)), ("w1_l2", (n_et, 5)),
            ("w2_l2", (n_et, 5)))}
        j_fn, t_fn = j_nn_padded, nn_decoder_apply_padded
    bufs = ("dd_src2d", "dd_dst2d", "dd_chunk_type")
    want = j_fn(_tree(params, False), jnp.asarray(z), *(jg[k] for k in bufs),
                sigmoid=False, backend="xla")
    tp, zt = _tree(params, True), torch.from_numpy(z)
    got = t_fn(tp, zt, *(tg[k] for k in bufs), sigmoid=False, backend="xla")
    _close(got, want)  # every slot, the pads' clamped garbage too
    kernel = t_fn(tp, zt, *(tg[k] for k in bufs), sigmoid=False,
                  backend="pallas")
    real = tg["dd_valid"] > 0
    _close(got[real], kernel[real].detach().numpy())


def _dense_inputs(td, rng):
    da = dense_relation_adj(td.dd_train, td.n_drug)
    n, n_et = td.n_drug, td.n_et
    return (da, rng.normal(size=(n_et, 8)).astype(np.float32) * 0.3,
            rng.normal(size=(n, 8)).astype(np.float32) * 0.3)


def _grads(fn, *args):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    loss = fn(*ts)
    loss.backward()
    return loss.item(), [t.grad.numpy() for t in ts]


def test_dense_bce_sym_xla_matches_jax(both):
    td = both[1]
    rng = np.random.default_rng(3)
    da, w, z = _dense_inputs(td, rng)
    strips = sym_strip_pack(da)
    q8 = np.zeros((td.n_et, 8), np.int32)
    want, wg = jax.value_and_grad(
        lambda w_, z_: j_sym_xla(w_, z_, jnp.asarray(strips), jnp.asarray(q8),
                                 jax.random.key(0)), argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(z))
    got, gg = _grads(lambda w_, z_: dense_bce_sym_sum_xla(
        w_, z_, torch.from_numpy(strips), torch.from_numpy(q8), 7), w, z)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    for a, b in zip(gg, wg):
        _close(a, b, rtol=1e-4)


def test_dense_bce_xla_matches_jax_and_the_kernel_route(both):
    td = both[1]
    rng = np.random.default_rng(4)
    da, w, z = _dense_inputs(td, rng)
    pages = cast_dense_adj(da, "float32")
    q = np.zeros((td.n_et, 3), np.int32)
    want, wg = jax.value_and_grad(
        lambda w_, z_: j_bce_xla(w_, z_, jnp.asarray(pages), jnp.asarray(q),
                                 jax.random.key(0)), argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(z))
    args = (torch.from_numpy(pages), torch.from_numpy(q), 7)
    got, gg = _grads(lambda w_, z_: dense_bce_sum_xla(w_, z_, *args), w, z)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    for a, b in zip(gg, wg):
        _close(a, b, rtol=1e-4)
    # live thresholds: the xla route is the plain version, the same field
    q_live = np.full((td.n_et, 3), 1 << 22, np.int32)
    args = (torch.from_numpy(pages), torch.from_numpy(q_live), 7)
    a = dense_bce_sum_xla(torch.from_numpy(w), torch.from_numpy(z), *args)
    b = dense_bce_sum(torch.from_numpy(w), torch.from_numpy(z), *args)
    assert a.item() == b.item()


def test_dense_bce_nn_xla_matches_jax(both):
    td = both[1]
    rng = np.random.default_rng(5)
    da = dense_relation_adj(td.dd_train, td.n_drug)
    pages = cast_dense_adj(da, "uint8")
    n, n_et = td.n_drug, td.n_et
    w1, w2 = (rng.normal(size=(n_et, 16)).astype(np.float32) * 0.3
              for _ in range(2))
    h1, h2 = (np.abs(rng.normal(size=(n, 16))).astype(np.float32) * 0.3
              for _ in range(2))
    q = np.zeros((n_et, 3), np.int32)
    want, wg = jax.value_and_grad(
        lambda *a: j_bce_nn_xla(*a, jnp.asarray(pages), jnp.asarray(q),
                                jax.random.key(0)), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (w1, w2, h1, h2)))
    got, gg = _grads(lambda *a: dense_bce_nn_sum_xla(
        *a, torch.from_numpy(pages), torch.from_numpy(q), 7), w1, w2, h1, h2)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    for a, b in zip(gg, wg):
        _close(a, b, rtol=1e-4)


def test_coo_pp_encoder_matches_jax(both, chunked):
    td = both[1]
    jg = chunked[0]
    tg = chunked[1]
    rng = np.random.default_rng(6)
    params = {"conv1": {"weight": rng.normal(size=(td.n_prot, 6)).astype(
                  np.float32), "bias": rng.normal(size=(6,)).astype(np.float32)},
              "conv2": {"weight": rng.normal(size=(6, 4)).astype(np.float32),
                        "bias": rng.normal(size=(4,)).astype(np.float32)}}
    want = j_pp_encoder_apply(_tree(params, False), None, jg["pp_norm_index"],
                              jg["pp_norm_weight"], td.n_prot)
    got = pp_encoder_apply(_tree(params, True), None, tg["pp_norm_index"],
                           tg["pp_norm_weight"], td.n_prot)
    _close(got, want)


def _models(both, dense_dtype):
    jd, td = both
    jg, jgs = j_graph_arrays(jd, dense_dtype=dense_dtype, pp_dense=False,
                             **PACK)
    jm = JTIP.for_data(JModelConfig(**NARROW), jd, jgs, backend="xla")
    tg, tgs = make_graph_arrays(td, "cpu", dense_dtype=dense_dtype,
                                pp_dense=False, **PACK)
    tm = TIP.for_data(ModelConfig(**NARROW), td, tgs, device="cpu",
                      backend="xla")
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jm, jg, tm, tg, params


@pytest.mark.parametrize("layout,dense_dtype", [
    ("strips", "bfloat16"), ("pages", "float32")])
def test_tip_xla_encode_and_loss_match_jax_on_dense_layouts(both, layout,
                                                            dense_dtype):
    """Thresholds zeroed: the fused loss (the xla dense BCE) is the
    positives' alone in both packages.  Gradients: 1e-4 of each leaf's
    largest on the float32 pages; on the strips tests/test_torch_model.py's
    2e-2 (bf16 re-rounding of activations can flip an ulp between the
    packages)."""
    jm, jg, tm, tg, params = _models(both, dense_dtype)
    assert tm.gs.dd_layout == layout and tm.backend == "xla"
    q = "dd_neg_q8" if layout == "strips" else "dd_neg_q"
    jg = dict(jg, **{q: jnp.zeros_like(jg[q])})
    tg = dict(tg, **{q: torch.zeros_like(tg[q])})
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.params_from_jax(params, requires_grad=True)
    _close(tm.encode(tp, tg), jm.encode(jp, jg))
    want, wg = jax.value_and_grad(
        lambda p: jm.loss(p, jg, jax.random.key(1)))(jp)
    loss = tm.loss(tp, tg, seed=1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    scale = 2e-2 if layout == "strips" else 1e-4
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(wg),
                            convert.leaves(tp)):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=scale * np.abs(np.asarray(a)).max(),
                                   err_msg=str(path))


def test_tip_xla_chunked_matches_jax_under_the_same_negatives(both):
    """The chunked route: z (the COO P-P GCN, the segment-sum R-GCN), the
    positives' scores, and the loss of the port's own xla negatives (the
    flat sampler, rounds 4) scored by the JAX package's xla decoder."""
    jm, jg, tm, tg, params = _models(both, None)
    gs = tm.gs
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.params_from_jax(params)
    with torch.no_grad():
        z = tm.encode(tp, tg)
        loss = tm.loss(tp, tg, seed=9)
        src2d, dst2d = typed_negative_sampling_chunked(
            9, tg["dd_chunk_type"], tg["dd_bitmap"], gs.n_drug, gs.n_et,
            gs.dd_chunk, backend="xla")
    jz = jm.encode(jp, jg)
    _close(z, jz)
    pos = jm.score_padded(jp, jz, jg["dd_src2d"], jg["dd_dst2d"],
                          jg["dd_chunk_type"], sigmoid=False)
    neg = jm.score_padded(jp, jz, jnp.asarray(src2d.numpy()),
                          jnp.asarray(dst2d.numpy()), jg["dd_chunk_type"],
                          sigmoid=False)
    valid = jg["dd_valid"]
    want = (jnp.sum(jax.nn.softplus(-pos) * valid)
            + jnp.sum(jax.nn.softplus(neg) * valid)) / gs.dd_n_valid
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    got = tm.score_padded(tp, z, tg["dd_src2d"], tg["dd_dst2d"],
                          tg["dd_chunk_type"], sigmoid=False)
    _close(got, pos)


def test_xla_sampler_is_the_flat_sampler_of_the_step_seed(chunked):
    _, tg, gs = chunked
    ct, bm = tg["dd_chunk_type"], tg["dd_bitmap"]
    a = typed_negative_sampling_chunked(5, ct, bm, gs.n_drug, gs.n_et,
                                        gs.dd_chunk, backend="xla")
    b = typed_negative_sampling_chunked(5, ct, bm, gs.n_drug, gs.n_et,
                                        gs.dd_chunk, backend="xla")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (gs.dd_n_chunks, gs.dd_chunk)
    et = torch.repeat_interleave(ct.long(), gs.dd_chunk)
    pair = a[1].reshape(-1) * gs.n_drug + a[0].reshape(-1)
    # leftovers after 4 rounds are rare at this density
    assert collides(pair, et, bm, gs.n_drug).float().mean() < 0.01
    with pytest.raises(ValueError, match="kernel B10"):
        typed_negative_sampling_chunked(
            5, ct, bm, gs.n_drug, gs.n_et, gs.dd_chunk, backend="xla",
            u24=torch.zeros((gs.dd_n_chunks, 1, gs.dd_chunk),
                            dtype=torch.int32))


def test_auto_resolves_to_pallas_on_every_device(both):
    # resolve_backend takes no device: the answer is the same for the CPU
    # and the card, and never 'xla' unless named
    assert resolve_backend("auto") == "pallas"
    assert resolve_backend("xla") == "xla"
    assert resolve_backend("pallas") == "pallas"
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("tpu")
    td = both[1]
    tg, tgs = make_graph_arrays(td, "cpu", dense_dtype=None, **PACK)
    assert TIP.for_data(ModelConfig(**NARROW), td, tgs,
                        device="cpu").backend == "pallas"
    from tip_tpu_torch.models.runner import build_variant

    model, _, _ = build_variant("dr-nn", td, "cpu")
    assert model.backend == "pallas"
    model, _, _ = build_variant("dr-nn", td, "cpu", backend="xla")
    assert model.backend == "xla"


def test_pallas_and_xla_models_give_the_same_z_on_cpu(both):
    td = both[1]
    tg, tgs = make_graph_arrays(td, "cpu", dense_dtype=None, **PACK)
    cfg = ModelConfig(**NARROW)
    pm = TIP.for_data(cfg, td, tgs, device="cpu", backend="pallas")
    xm = dataclasses.replace(pm, backend="xla")
    params = pm.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        zp, zx = pm.encode(params, tg), xm.encode(params, tg)
    np.testing.assert_allclose(zp.numpy(), zx.numpy(), atol=1e-5)


def test_both_clis_parse_backend(monkeypatch):
    import tip_tpu_torch.models.__main__ as models_cli
    import tip_tpu_torch.models.runner as runner
    import tip_tpu_torch.train.__main__ as train_cli
    import tip_tpu_torch.train.loop as loop

    seen = {}

    def fake_train(cfg, tcfg, data, **kw):
        seen["train"] = kw["backend"]
        return None, {"final": {}, "history": []}

    def fake_build(variant, data, device, **kw):
        seen["models"] = kw["backend"]
        return None, None, None

    monkeypatch.setattr(loop, "train", fake_train)
    monkeypatch.setattr(runner, "build_variant", fake_build)
    monkeypatch.setattr(runner, "train_variant",
                        lambda *a, **k: (None, {"final": {}, "history": []}))
    train_cli.main(["--synthetic", "--cpu", "--backend", "xla"])
    models_cli.main(["--variant", "dr-nn", "--synthetic", "--cpu",
                     "--backend", "xla"])
    assert seen == {"train": "xla", "models": "xla"}
    train_cli.main(["--synthetic", "--cpu"])
    assert seen["train"] == "auto"
    with pytest.raises(SystemExit):
        train_cli.main(["--synthetic", "--cpu", "--backend", "tpu"])
