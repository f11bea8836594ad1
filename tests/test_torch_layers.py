"""The port's layers (tip_tpu_torch/nn) against the JAX package's on the CPU.

Same inputs and parameters in both: parameters come from the JAX init
through tip_tpu_torch/convert.py, inputs from numpy.  The dense products
of both packages round their operands to bf16 and accumulate in float32,
so forward outputs agree to float32 summation order (rtol 1e-5) and
gradients to rtol 1e-4.  Where an activation computed inside a function is
rounded to bf16 again (the second R-GCN layer's input, the encoder's
layers), a float32 difference of one ulp can move that element by one bf16
ulp (2^-8 relative); the gradients through those roundings flip the same
way.  Those outputs are held at rtol 1e-5 / 1e-4 plus an atol of one bf16
ulp of the largest magnitude (BF16_ULP * max|want|).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tip_tpu.config import ModelConfig as JModelConfig
from tip_tpu.data import build_trigraph, synthetic_trigraph
from tip_tpu.data.packing import dense_pp_parts, dense_relation_adj, sym_strip_pack
from tip_tpu.nn import encoders as jenc
from tip_tpu.nn.gcn import gcn_conv_apply_dense as j_gcn, gcn_conv_init
from tip_tpu.nn.hierarchy import hierarchy_conv_apply as j_hier, hierarchy_conv_init
from tip_tpu.nn.rgcn import dense_rgcn_pair_apply_sym as j_pair, rgcn_init
from tip_tpu.train.model import make_graph_arrays
from tip_tpu_torch import convert
from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.nn import encoders as tenc
from tip_tpu_torch.nn.gcn import gcn_conv_apply_dense as t_gcn
from tip_tpu_torch.nn.hierarchy import hierarchy_conv_apply as t_hier
from tip_tpu_torch.nn.rgcn import dense_rgcn_pair_apply_sym as t_pair
from tip_tpu_torch.train.model import GraphStatic

BF16_ULP = 2.0**-8


@pytest.fixture(scope="module")
def data():
    raw = synthetic_trigraph(n_drug=150, n_prot=64, n_et=5, pairs_per_et=120,
                             n_pp_pairs=200, n_dp=120, seed=3)
    return build_trigraph(raw, split_rate=0.9, seed=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_vjp(f, params, x, ct):
    """f's output and the gradients of <f, ct> w.r.t. (params, x)."""
    def fwd_bwd(params, x, ct):
        out, vjp = jax.vjp(f, params, x)
        return out, vjp(ct)

    out, (gp, gx) = jax.jit(fwd_bwd)(params, x, jnp.asarray(ct))
    return np.asarray(out), _np(gp), np.asarray(gx)


def _torch_vjp(f, params_np, x, ct):
    params = convert.params_from_jax(params_np, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = f(params, xt)
    (out * torch.from_numpy(ct)).sum().backward()
    gp = convert.params_to_numpy(jax.tree.map(
        lambda p: p.grad, params, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    gx = None if xt.grad is None else xt.grad.numpy()
    return out.detach().numpy(), gp, gx


def _close_tree(got, want, rtol, atol_frac=0.0):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        w = flat_w[path]
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_frac * np.abs(w).max(),
                                   err_msg=str(path))


def test_convert_round_trip_exact():
    params = jax.jit(jenc.fm_encoder_init, static_argnums=(1, 2, 3, 4))(
        jax.random.key(0), JModelConfig.tip_cat(), 20, 30, 4)
    tree = _np(params)
    back = convert.params_to_numpy(convert.params_from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_gcn_dense_forward_and_grads(data):
    a1, dinv = dense_pp_parts(data.pp_norm_index, data.n_prot)
    params = _np(gcn_conv_init(jax.random.key(1), 24, 16))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((data.n_prot, 24)).astype(np.float32)
    ct = rng.standard_normal((data.n_prot, 16)).astype(np.float32)
    jout, jgp, jgx = _jax_vjp(
        lambda p, x: j_gcn(p, x, jnp.asarray(a1), jnp.asarray(dinv)),
        params, x, ct)
    tout, tgp, tgx = _torch_vjp(
        lambda p, x: t_gcn(p, x, torch.from_numpy(a1), torch.from_numpy(dinv)),
        params, x, ct)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    _close_tree(tgp, jgp, rtol=1e-4, atol_frac=1e-6)
    np.testing.assert_allclose(tgx, jgx, rtol=1e-4, atol=1e-6)


def test_hierarchy_forward_and_grads(data):
    params = _np(hierarchy_conv_init(jax.random.key(2), 16, 16))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((data.n_prot, 16)).astype(np.float32)
    ct = rng.standard_normal((data.n_drug, 16)).astype(np.float32)
    src, dst = data.dp_edge_index
    deg = data.dp_drug_deg
    jout, jgp, jgx = _jax_vjp(
        lambda p, x: j_hier(p, x, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(deg), data.n_drug),
        params, x, ct)
    tout, tgp, tgx = _torch_vjp(
        lambda p, x: t_hier(p, x, torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(deg), data.n_drug),
        params, x, ct)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    _close_tree(tgp, jgp, rtol=1e-4, atol_frac=1e-6)
    np.testing.assert_allclose(tgx, jgx, rtol=1e-4, atol=1e-6)


def test_rgcn_pair_sym_forward_and_grads(data):
    strips = sym_strip_pack(dense_relation_adj(data.dd_train, data.n_drug))
    k1, k2 = jax.random.split(jax.random.key(3))
    params = _np({"r1": rgcn_init(k1, 64, 32, data.n_et, 8, after_relu=False),
                  "r2": rgcn_init(k2, 32, 16, data.n_et, 8, after_relu=True)})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((data.n_drug, 64)).astype(np.float32)
    ct = rng.standard_normal((data.n_drug, 16)).astype(np.float32)
    deg = data.dd_train_deg
    jout, jgp, jgx = _jax_vjp(
        lambda p, x: j_pair(p["r1"], p["r2"], x, jnp.asarray(strips),
                            jnp.asarray(deg)),
        params, x, ct)
    tout, tgp, tgx = _torch_vjp(
        lambda p, x: t_pair(p["r1"], p["r2"], x, torch.from_numpy(strips),
                            torch.from_numpy(deg)),
        params, x, ct)
    # layer 2 re-rounds layer 1's output to bf16 (see module docstring)
    np.testing.assert_allclose(tout, jout, rtol=1e-5,
                               atol=BF16_ULP * np.abs(jout).max())
    _close_tree(tgp, jgp, rtol=1e-4, atol_frac=BF16_ULP)
    np.testing.assert_allclose(tgx, jgx, rtol=1e-4,
                               atol=BF16_ULP * np.abs(jgx).max())


@pytest.mark.parametrize("mode", ["cat", "add"])
def test_fm_encoder_forward_and_grads(data, mode):
    jcfg = JModelConfig.tip_cat() if mode == "cat" else JModelConfig.tip_add()
    # narrow widths: the layers are the same at any width
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "n_hid1": 16, "n_hid2": 8,
                             "num_base": 8, "pp_hid1": 16, "pp_hid2": 8})
    cfg = ModelConfig(**jcfg.__dict__)
    jgraph, jgs = make_graph_arrays(data, dense_dtype="bfloat16")
    assert "dd_adj_sym" in jgraph and "pp_a1" in jgraph
    params = _np(jax.jit(jenc.fm_encoder_init, static_argnums=(1, 2, 3, 4))(
        jax.random.key(4), jcfg, data.n_drug, data.n_prot, data.n_et))
    tgraph = {k: torch.from_numpy(np.array(jgraph[k])) for k in (
        "dd_deg", "dd_adj_sym", "pp_a1", "pp_dinv", "dp_src", "dp_dst",
        "dp_deg")}
    gs = GraphStatic(data.n_drug, data.n_prot, data.n_et,
                     data.dd_train.n_edges)
    ct = np.random.default_rng(4).standard_normal(
        (data.n_drug, cfg.n_hid2)).astype(np.float32)
    unused = np.zeros(1, np.float32)
    jout, jgp, _ = _jax_vjp(
        lambda p, _: jenc.fm_encoder_apply(p, jgraph, jcfg, jgs),
        params, unused, ct)
    tout, tgp, _ = _torch_vjp(
        lambda p, _: tenc.fm_encoder_apply(p, tgraph, cfg, gs),
        params, unused, ct)
    np.testing.assert_allclose(tout, jout, rtol=1e-5,
                               atol=BF16_ULP * np.abs(jout).max())
    _close_tree(tgp, jgp, rtol=1e-4, atol_frac=BF16_ULP)
