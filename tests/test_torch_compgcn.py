"""CompGCN on the port (tip_tpu_torch/models/compgcn.py, kernel B16 and B1's
wide instance) against the plain reference tests/plain_compgcn.py on a
small seeded tri-graph at the published widths 100 -> 200: z, the loss,
every leaf's gradient and three Adam steps, at the stated precision (the
bf16 operands of the D-D and P-P messages).  Then B16's plain version against a
dense per-relation float64 product, B1's plain version at d = 200 against
a float64 sum, the in/out relabelling, BN's scale stored as its offset
from 1, and the layout ``build_variant`` picks.

The kernels themselves are held to their plain versions on the card by the
tests marked ``card`` (they skip themselves here): ``python -m pytest
tests/test_torch_compgcn.py -m card --noconftest -q``; chip_smoke.py checks
them at Decagon shape.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import plain_compgcn as ref  # tests/ is on sys.path under pytest
from tip_tpu_torch import trace
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.data.packing import sym_strip_pack
from tip_tpu_torch.models import runner
from tip_tpu_torch.models.compgcn import (
    CompGCNConfig,
    CompGCNModel,
    make_compgcn_graph_arrays,
)
from tip_tpu_torch.ops import dense_bce_sym as b1
from tip_tpu_torch.ops import rel_scaled as b16
from tip_tpu_torch.ops.matmul import set_matmul_precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 7  # the loss's step seed: its low 32 bits key the field


@pytest.fixture(scope="module")
def data():
    raw = synthetic_trigraph(n_drug=40, n_prot=300, n_et=6, pairs_per_et=60,
                             n_pp_pairs=600, n_dp=80, seed=5)
    return build_trigraph(raw, 0.9, 1111)


def plain_graph(data):
    dd = data.dd_train
    return ref.Graph(data.n_drug, data.n_prot, data.n_et,
                     (dd.edge_index[0], dd.edge_index[1], dd.edge_type),
                     data.pp_norm_index, data.dp_edge_index)


def build(data, seed=11):
    set_matmul_precision()
    graph, gs = make_compgcn_graph_arrays(data, "cpu")
    model = CompGCNModel.for_data(CompGCNConfig(), gs, "cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    # a trained-looking BN: the zero offsets would hide its gradients' paths
    gen = torch.Generator().manual_seed(seed + 1)
    for k in ("bn_scale_delta", "bn_shift"):
        params["encoder"][k] = 0.1 * torch.randn(200, generator=gen)
    return model, graph, params


def clone(params, grad=True):
    if isinstance(params, dict):
        return {k: clone(v, grad) for k, v in params.items()}
    return params.detach().clone().requires_grad_(grad)


def rel_gap(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def test_port_against_the_plain_reference(data):
    model, graph, params = build(data)
    assert model.gs.dd_layout == "strips" and model.gs.pp_layout == "dense"
    assert graph["dd_adj_sym"].dtype == torch.int8
    g = plain_graph(data)
    mine, theirs = clone(params), clone(params)
    z = model.encode(mine, graph)
    z_ref = ref.encode(g, theirs, True)
    # the same operands rounded at the same points; the messages' float32
    # sums in another order (B16 by relation, then the plain reference edge
    # by edge), through BN and tanh: float32 round-off
    assert rel_gap(z, z_ref) < 2e-6
    lp = model.loss(mine, graph, SEED)
    lr_ = ref.loss(g, theirs, SEED, True)
    # one z, the same cells and draws; the cells' float32 sum in another
    # order
    assert abs(lp.item() - lr_.item()) < 2e-6 * abs(lr_.item())
    lp.backward()
    lr_.backward()
    for (path, a), (_, b) in zip(ref.leaves(mine), ref.leaves(theirs)):
        # the backward's float32 sums in another order; P-P's operand
        # gradient rounded to bf16 on both sides at the same point
        assert rel_gap(a.grad, b.grad) < 2e-5, path


def test_a_pp_side_past_the_dense_budget_is_refused(data, monkeypatch):
    monkeypatch.setattr("tip_tpu_torch.models.compgcn.dense_pp_feasible",
                        lambda n: False)
    with pytest.raises(ValueError, match="dense budget"):
        make_compgcn_graph_arrays(data, "cpu")


def test_three_adam_steps_against_the_plain_reference(data):
    model, graph, params = build(data)
    g = plain_graph(data)
    mine, theirs = clone(params), clone(params)
    opt = torch.optim.Adam([x for _, x in ref.leaves(mine)], lr=0.001,
                           betas=(0.9, 0.999), eps=1e-8)
    state = {}
    for k in range(3):
        opt.zero_grad(set_to_none=True)
        for _, x in ref.leaves(theirs):
            x.grad = None
        a = model.loss(mine, graph, SEED + k)
        b = ref.loss(g, theirs, SEED + k)
        # the weights differ by the earlier steps' round-off, which Adam
        # moves by up to a step where a gradient element is round-off
        assert abs(a.item() - b.item()) < 1e-5 * abs(b.item()), k
        a.backward()
        b.backward()
        opt.step()
        ref.adam_step(theirs, state, lr=0.001, t=k + 1)
    with torch.no_grad():
        z = model.encode(mine, graph)
        src, dst, et = (torch.from_numpy(x.astype(np.int64)) for x in (
            data.dd_test.edge_index[0], data.dd_test.edge_index[1],
            data.dd_test.edge_type))
        s = model.score(mine, z, src, dst, et, sigmoid=False)
        s_ref = ref.score(g, ref.encode(g, theirs), theirs["decoder"], src,
                          dst, et)
        assert rel_gap(s, s_ref) < 1e-4


def test_the_port_leaves_are_the_references(data):
    model, _, params = build(data)
    gs = model.gs
    n, k = gs.n_drug + gs.n_prot, gs.n_et + 2
    assert [(p, tuple(x.shape)) for p, x in ref.leaves(params)] == [
        ("decoder/rel", (2 * k, 100)), ("decoder/w_rel", (100, 200)),
        ("encoder/bn_scale_delta", (200,)), ("encoder/bn_shift", (200,)),
        ("encoder/ent", (n, 100)), ("encoder/loop_rel", (1, 100)),
        ("encoder/w_in", (100, 200)), ("encoder/w_loop", (100, 200)),
        ("encoder/w_out", (100, 200))]
    fresh = model.init(torch.Generator().manual_seed(3))
    assert torch.all(fresh["encoder"]["bn_scale_delta"] == 0)
    std = float(fresh["encoder"]["ent"].std())
    assert abs(std - (2.0 / (n + 100)) ** 0.5) < 0.05 * std  # xavier normal


def test_spans_of_a_step(data):
    model, graph, params = build(data)
    params = clone(params)
    before = trace.totals()
    model.loss(params, graph, SEED).backward()
    spans = trace.totals(since=before)
    assert spans["kg_conv"]["count"] == 1
    assert spans["rel_scaled"]["count"] == 2  # the call and its backward
    assert spans["dense_bce_sym"]["count"] == 1
    assert spans["encode"]["count"] == 1 and spans["loss"]["count"] == 1


def test_build_variant_picks_the_strips(data):
    model, graph, test = runner.build_variant("compgcn", data, "cpu")
    assert isinstance(model, CompGCNModel)
    assert model.gs.dd_layout == "strips" and model.cfg == CompGCNConfig()
    assert "dd_adj_sym" in graph and "dd_neg_q8" in graph
    assert "dd_adj_t" not in graph and "pp_a" in graph
    assert graph["pp_a"].dtype == torch.int8
    assert int(graph["pp_a"].diagonal().abs().sum()) == 0  # no self loops
    with pytest.raises(ValueError, match="int8 strips"):
        runner.build_variant("compgcn", data, "cpu",
                             matmul_precision="highest")


def test_in_out_relabelling(data):
    """Without drug-protein triples every head degree is the same in both
    directions, so swapping W_I with W_O and z_r with z_{r+K} gives the same
    encoder output, and the same loss at the same decoder rows."""
    nodp = dataclasses.replace(
        data, dp_edge_index=np.zeros((2, 0), data.dp_edge_index.dtype),
        dp_drug_deg=np.zeros_like(data.dp_drug_deg))
    model, graph, params = build(nodp)
    k = model.gs.n_et + 2
    swapped = clone(params, grad=False)
    enc, rel = swapped["encoder"], params["decoder"]["rel"]
    enc["w_in"], enc["w_out"] = params["encoder"]["w_out"].clone(), \
        params["encoder"]["w_in"].clone()
    swapped["decoder"]["rel"] = torch.cat([rel[k:], rel[:k]]).clone()
    with torch.no_grad():
        z = model.encode(params, graph)
        zs = model.encode(swapped, graph)
        assert rel_gap(zs, z) < 1e-6
        a = model._loss_sum(params, graph, z, SEED, None)
        b = model._loss_sum(params, graph, zs, SEED, None)
        assert abs(a.item() - b.item()) < 1e-6 * abs(a.item())


def test_bn_offset_is_a_scale_started_at_one(data):
    """Adam's step depends on the gradient alone: the offset from 1 and a
    scale leaf started at 1 follow the same trajectory over three steps."""
    model, graph, params = build(data)
    params["encoder"]["bn_scale_delta"] = torch.zeros(200)
    g = plain_graph(data)
    mine = clone(params)
    theirs = clone(params)
    theirs["encoder"]["bn_scale"] = torch.ones(200, requires_grad=True)
    del theirs["encoder"]["bn_scale_delta"]
    opt = torch.optim.Adam([x for _, x in ref.leaves(mine)], lr=0.001)
    state = {}
    for k in range(3):
        opt.zero_grad(set_to_none=True)
        for _, x in ref.leaves(theirs):
            x.grad = None
        model.loss(mine, graph, SEED + k).backward()
        ref.loss(g, theirs, SEED + k).backward()
        assert rel_gap(mine["encoder"]["bn_scale_delta"].grad,
                       theirs["encoder"]["bn_scale"].grad) < 2e-5
        opt.step()
        ref.adam_step(theirs, state, lr=0.001, t=k + 1)
        got = 1.0 + mine["encoder"]["bn_scale_delta"].detach()
        want = theirs["encoder"]["bn_scale"].detach()
        # 1 + delta rounds once where the scale's update rounds once: one
        # float32 unit of 1 apart at most
        assert float((got - want).abs().max()) <= 2.0**-23, k


# --- B16's plain version -------------------------------------------------------


def sym_pages(r, n, seed, p=0.05, top=5):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, top + 1, (r, n, n)) * (rng.random((r, n, n)) < p)
    a = np.triu(a)
    return (a + np.transpose(np.triu(a, 1), (0, 2, 1))).astype(np.int64)


@pytest.mark.parametrize("n", [40, 129, 300])
def test_b16_plain_against_a_dense_product(n):
    """The strips unpack to the pages (diagonal block, tail and the tail's
    mirror); forward, dU and dz against the float64 per-relation product
    of the same pages, within float32 round-off of the sums of |terms|."""
    r, d = 5, 24
    pages = sym_pages(r, n, n)
    strips = torch.from_numpy(sym_strip_pack(pages))
    assert torch.equal(b16.strip_pages(strips, n), torch.from_numpy(
        pages).float())
    gen = torch.Generator().manual_seed(n)
    u = torch.randn(n, d, generator=gen)
    z = torch.randn(r, d, generator=gen)
    g = torch.randn(n, d, generator=gen)
    ub = b16.bf16_value(u)
    A = torch.from_numpy(pages).double()
    want = ((A @ ub.double()) * z.double()[:, None]).sum(0)
    bound = 2.0**-20 * ((A @ ub.double().abs()) * z.double().abs()[:, None]).sum(0)
    out = b16.rel_scaled_plain(strips, ub, z)
    assert torch.all((out.double() - want).abs() <= bound + 1e-30)
    du, dz = b16.rel_scaled_grad_plain(strips, ub, z, g)
    p = A @ g.double()
    pa = A @ g.double().abs()
    assert torch.all((du.double() - (p * z.double()[:, None]).sum(0)).abs()
                     <= 2.0**-20 * (pa * z.double().abs()[:, None]).sum(0))
    assert torch.all((dz.double() - (p * ub.double()[None]).sum(1)).abs()
                     <= 2.0**-20 * (pa * ub.double().abs()[None]).sum(1))


def test_b16_autograd_is_the_plain_gradient():
    n, r, d = 129, 4, 16
    pages = sym_pages(r, n, 1)
    strips = torch.from_numpy(sym_strip_pack(pages))
    gen = torch.Generator().manual_seed(2)
    u = torch.randn(n, d, generator=gen, requires_grad=True)
    z = torch.randn(r, d, generator=gen, requires_grad=True)
    g = torch.randn(n, d, generator=gen)
    out = b16.rel_scaled(strips, u, z)
    out.backward(g)
    du, dz = b16.rel_scaled_grad_plain(strips, b16.bf16_value(u.detach()),
                                       z.detach(), g)
    assert torch.equal(u.grad, du) and torch.equal(z.grad, dz)
    # the operand is rounded once to bf16: U and bf16(U) give one result
    assert torch.equal(out, b16.rel_scaled(strips, b16.bf16_value(u), z))


def test_b16_refuses_what_it_cannot_take():
    strips = torch.zeros((3, 128, 128), dtype=torch.int8)
    with pytest.raises(ValueError):
        b16.rel_scaled(strips.float(), torch.zeros(5, 8), torch.zeros(3, 8))
    with pytest.raises(ValueError):
        b16.rel_scaled(strips, torch.zeros(5, 8), torch.zeros(2, 8))
    with pytest.raises(ValueError):
        b16.rel_scaled(strips, torch.zeros(200, 8), torch.zeros(3, 8))


# --- B1's plain version at d = 200 ----------------------------------------------


def test_b1_plain_at_d200_against_a_float64_sum():
    """The plain version at the wide width against the float64 sum of the
    same cells and counts; dw and dz against their float64 sums, element
    by element within 2^-20 of the sums of |terms| (float32 products and
    sums of at most n d terms)."""
    r, n, d = 3, 150, 200
    pages = sym_pages(r, n, 4, p=0.03, top=3)
    strips = torch.from_numpy(sym_strip_pack(pages))
    gen = torch.Generator().manual_seed(9)
    w = torch.randn(r, d, generator=gen) / d**0.5
    z = torch.randn(n, d, generator=gen) / d**0.25
    q8 = torch.from_numpy(ref.thresholds_sym(
        (pages.sum((1, 2))), n).astype(np.int32))
    seed = 123457
    loss, dw, dz = b1.dense_bce_sym_plain(w, z, strips, q8, seed, True)
    g = ref.Graph.__new__(ref.Graph)
    g.n_drug, g.n_et, g.n_train = n, r, 1.0
    g.pages = torch.from_numpy(pages).float()
    g.q = q8.long()
    zd, wd = z.double().requires_grad_(True), w.double().requires_grad_(True)
    want = ref.loss_of(g, zd, {"rel": wd, "w_rel": torch.eye(
        d, dtype=torch.float64)}, seed)
    want.backward()
    assert abs(loss.item() - want.item()) < 1e-6 * abs(want.item())
    assert rel_gap(dw, wd.grad) < 1e-5
    assert rel_gap(dz, zd.grad) < 1e-5


def test_b1_wide_widths_are_taken_by_the_kernel_checks():
    w = torch.zeros(2, 200)
    z = torch.zeros(129, 200)
    pages = torch.zeros((2, 128, 384), dtype=torch.int8)
    q8 = torch.zeros((2, 8), dtype=torch.int32)
    assert b1._check_cuda_args(w, z, pages, q8)[2] == 200
    with pytest.raises(ValueError, match="feature width"):
        b1._check_cuda_args(torch.zeros(2, 24), torch.zeros(129, 24), pages,
                            q8)
    with pytest.raises(ValueError, match="feature width"):
        b1._check_cuda_args(torch.zeros(2, 240), torch.zeros(129, 240), pages,
                            q8)
    assert b1.wide_chunks(1097, 645, 6, 132) == 275


def test_cli_compgcn_synthetic_cpu(tmp_path):
    out_json = tmp_path / "m.json"
    out = subprocess.run(
        [sys.executable, "-m", "tip_tpu_torch.models", "--variant",
         "compgcn", "--synthetic", "--cpu", "--epochs", "2", "--lr", "0.001",
         "--out", str(out_json)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    records = [json.loads(x) for x in out.stdout.strip().splitlines()
               if x.startswith("{")]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert records[-1]["spans"]["kg_conv"]["count"] == 2 + 1
    res = json.loads(out_json.read_text())
    assert res["variant"] == "compgcn" and 0.0 <= res["final"]["auroc"] <= 1.0


# --- on the card -------------------------------------------------------------


def card_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_matmul_precision()
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n", [40, 129, 300, 645])
@pytest.mark.parametrize("d", [8, 40, 200])
def test_on_the_card_b16_against_its_plain_version(n, d):
    """Forward, dU and dz against the plain version, element by element
    within 2^-21 of the float64 sums of |terms| (both float32 sums of
    exact products, in other orders)."""
    dev = card_device()
    r = 7
    pages = sym_pages(r, n, n + d)
    strips = torch.from_numpy(sym_strip_pack(pages)).to(dev)
    gen = torch.Generator().manual_seed(n * d)
    ub = b16.bf16_value(torch.randn(n, d, generator=gen)).to(dev)
    z = torch.randn(r, d, generator=gen).to(dev)
    g = (torch.randn(n, d, generator=gen) * torch.exp2(torch.randint(
        -8, 9, (n, d), generator=gen).float())).to(dev)
    A = torch.from_numpy(pages).double().to(dev)
    out = b16.rel_scaled_cuda(strips, ub, z)
    want = b16.rel_scaled_plain(strips, ub, z).double()
    bound = 2.0**-21 * ((A @ ub.double().abs()) * z.double().abs()[:, None]).sum(0)
    assert torch.all((out.double() - want).abs() <= 2 * bound)
    du, dz = b16.rel_scaled_grad_cuda(strips, ub, z, g)
    du_p, dz_p = b16.rel_scaled_grad_plain(strips, ub, z, g)
    pa = A @ g.double().abs()
    assert torch.all((du.double() - du_p.double()).abs()
                     <= 2 * 2.0**-21 * (pa * z.double().abs()[:, None]).sum(0))
    assert torch.all((dz.double() - dz_p.double()).abs()
                     <= 2 * 2.0**-21 * (pa * ub.double().abs()[None]).sum(1))
    again = b16.rel_scaled_grad_cuda(strips, ub, z, g)
    assert torch.equal(du, again[0]) and torch.equal(dz, again[1])


@pytest.mark.card
@pytest.mark.parametrize("n", [40, 129, 300, 645])
@pytest.mark.parametrize("d", [40, 100, 200])
def test_on_the_card_b1_wide_against_its_plain_version(n, d):
    """The wide instance's loss, dw and dz against the plain version (the
    same cells and draws; float32 sums in other orders), and two runs
    bit-equal."""
    dev = card_device()
    r = 5
    pages = sym_pages(r, n, n + d, p=0.03, top=3)
    strips = torch.from_numpy(sym_strip_pack(pages)).to(dev)
    gen = torch.Generator().manual_seed(n + d)
    w = (torch.randn(r, d, generator=gen) / d**0.5).to(dev)
    z = (torch.randn(n, d, generator=gen) / d**0.25).to(dev)
    q8 = torch.from_numpy(ref.thresholds_sym(pages.sum((1, 2)), n).astype(
        np.int32)).to(dev)
    loss, dw, dz = b1.dense_bce_sym_cuda(w, z, strips, q8, 77, True)
    lp, dwp, dzp = b1.dense_bce_sym_plain(w, z, strips, q8, 77, True)
    assert abs(loss.item() - lp.item()) < 1e-5 * abs(lp.item())
    assert rel_gap(dw, dwp) < 1e-5 and rel_gap(dz, dzp) < 1e-5
    assert b1.dense_bce_sym_cuda(w, z, strips, q8, 77, False).item() == \
        loss.item()
    again = b1.dense_bce_sym_cuda(w, z, strips, q8, 77, True)
    assert torch.equal(dw, again[1]) and torch.equal(dz, again[2])
