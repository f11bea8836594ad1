"""Decagon on the port (tip_tpu_torch/models/decagon.py, kernels B13 and B14)
against the plain reference tests/plain_decagon.py on a small seeded
tri-graph, on the uint8 pages ('strips_pages') at the stated precision (the
bf16 operands of the D-D and P-P contractions) and with float32 matmuls
pinned (the D-D operand float32; the P-P GCN keeps B12's bf16 operand on
every dense layout), and with the P-P side on its float32 COO edges: z,
the loss, every leaf's gradient, one Adam step's update and the DEDICOM
scores.  Then the two kernels' plain versions against float64 oracles.

The kernels themselves are held to their plain versions and a float64
oracle on the card by the tests marked ``card`` (they skip themselves
here): ``python -m pytest tests/test_torch_decagon.py -m card --noconftest
-q``; chip_smoke.py checks them at Decagon shape.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import plain_decagon as ref  # tests/ is on sys.path under pytest
from tip_tpu_torch import trace
from tip_tpu_torch.convert import leaves
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.models import runner
from tip_tpu_torch.models.decagon import (
    DecagonConfig,
    DecagonModel,
    make_decagon_graph_arrays,
)
from tip_tpu_torch.ops import dense_bce_dedicom as b13
from tip_tpu_torch.ops import rel_aggregate as b14
from tip_tpu_torch.ops.matmul import set_matmul_precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 5  # the loss's step seed: its low 32 bits key the field
DIMS = dict(n_hid1=16, n_hid2=8)


@pytest.fixture(scope="module")
def data():
    raw = synthetic_trigraph(n_drug=40, n_prot=60, n_et=5, pairs_per_et=60,
                             n_pp_pairs=150, n_dp=50, seed=3)
    return build_trigraph(raw, 0.9, 1111)


def plain_graph(data):
    dd = data.dd_train
    return ref.Graph(data.n_drug, data.n_prot, data.n_et,
                     (dd.edge_index[0], dd.edge_index[1], dd.edge_type),
                     data.pp_norm_index, data.dp_edge_index)


def build(data, precision="bfloat16"):
    set_matmul_precision()
    graph, gs = make_decagon_graph_arrays(data, "cpu")
    model = DecagonModel.for_data(DecagonConfig(**DIMS), gs, "cpu",
                                  rel_precision=precision)
    params = model.init(torch.Generator().manual_seed(11))
    return model, graph, params


def clone(params, grad=True):
    if isinstance(params, dict):
        return {k: clone(v, grad) for k, v in params.items()}
    return params.detach().clone().requires_grad_(grad)


def rel_gap(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("precision,pp", [("bfloat16", "dense"),
                                          ("float32", "dense"),
                                          ("bfloat16", "coo")])
def test_port_against_the_plain_reference(data, precision, pp, monkeypatch):
    if pp == "coo":  # a P-P side past the dense budget: float32 COO edges
        monkeypatch.setattr("tip_tpu_torch.data.packing.dense_pp_feasible",
                            lambda n: False)
    model, graph, params = build(data, precision)
    assert model.gs.dd_layout == "strips_pages"
    assert graph["dd_adj_u8"].dtype == torch.uint8
    assert "dd_adj_sym" not in graph and "dd_adj_t" not in graph
    assert model.gs.pp_layout == pp
    g = plain_graph(data)
    flags = dict(dd_bf16=precision == "bfloat16", pp_bf16=pp == "dense")
    mine, theirs = clone(params), clone(params)

    z = model.encode(mine, graph)
    z_ref = ref.encode(g, theirs, **flags)
    # the same operands rounded at the same points and the same sums in
    # the same order (the reference mirrors the plain versions' order, so
    # no bf16 rounding of layer 2's operand can flip): float32 round-off
    assert rel_gap(z, z_ref) < 1e-6
    loss = model.loss(mine, graph, SEED)
    loss_ref = ref.loss(g, theirs, SEED, **flags)
    # one z, the same cells and draws; the cells' float32 sum in another
    # order (B13's plain version by relation chunks, the reference whole)
    assert abs(loss.item() - loss_ref.item()) < 1e-6 * abs(loss_ref.item())
    loss.backward()
    loss_ref.backward()
    for (path, a), (_, b) in zip(leaves_named(mine), leaves_named(theirs)):
        # the backward's float32 sums in another order (readings up to
        # 5e-7 of the leaf's largest element); P-P's gradient is rounded to
        # bf16 on both sides at the same point
        assert rel_gap(a.grad, b.grad) < 1e-5, path

    # one Adam step from the same gradients
    before = {p: x.detach().clone() for p, x in leaves_named(mine)}
    opt = torch.optim.Adam([x for _, x in leaves_named(mine)], lr=0.001,
                           betas=(0.9, 0.999), eps=1e-8)
    opt.step()
    ref.adam_step(theirs, {}, lr=0.001, t=1)
    for (path, a), (_, b) in zip(leaves_named(mine), leaves_named(theirs)):
        da, db = a.detach() - before[path], b.detach() - before[path]
        g_ref = b.grad
        # Adam moves an element whose gradient is round-off by a full step
        # of random sign: compare where the gradient stands out of it
        keep = g_ref.abs() >= 1e-3 * g_ref.pow(2).mean().sqrt()
        assert rel_gap(da[keep], db[keep]) < 1e-3, path

    with torch.no_grad():
        z = model.encode(mine, graph)
        z_ref = ref.encode(g, theirs, **flags)
        src, dst, et = (torch.from_numpy(x.astype(np.int64)) for x in (
            data.dd_test.edge_index[0], data.dd_test.edge_index[1],
            data.dd_test.edge_type))
        s = model.score(mine, z, src, dst, et, sigmoid=False)
        s_ref = ref.score(z_ref, theirs["decoder"], src, dst, et)
        # the same weights after one step: the updates' float32 round-off,
        # carried through two d x d products and a dot
        assert rel_gap(s, s_ref) < 1e-5
        dense = ref.dense_logits(z_ref, theirs["decoder"])
        assert rel_gap(s, dense[et, dst, src]) < 1e-5


def leaves_named(params):
    return ref.leaves(params)


def test_the_port_leaves_are_the_references(data):
    model, _, params = build(data)
    assert [p for p, _ in ref.leaves(params)] == [
        "decoder/global", "decoder/local", "layer1/dd", "layer1/dp",
        "layer1/pd", "layer1/pp", "layer2/dd", "layer2/pd"]
    assert [x.shape for x in leaves(params)] == [x.shape for _, x in
                                                 ref.leaves(params)]
    gs = model.gs
    assert params["layer1"]["dd"].shape == (gs.n_et, gs.n_drug, 16)
    assert params["decoder"]["local"].shape == (gs.n_et, 8, 1)


def test_spans_of_a_step(data):
    model, graph, params = build(data)
    params = clone(params)
    before = trace.totals()
    model.loss(params, graph, SEED).backward()
    spans = trace.totals(since=before)
    assert spans["rel_conv"]["count"] == 2  # once a layer
    assert spans["dedicom_bce"]["count"] == 2  # forward and backward
    assert spans["rel_aggregate"]["count"] == 2  # each layer's backward
    assert spans["encode"]["count"] == 1 and spans["loss"]["count"] == 1


def random_pages(r, n, seed, p=0.1):
    """Symmetric 0/1 uint8 count pages [r, n, n] with an empty diagonal."""
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((r, n, n), generator=g) < p
    a = (a | a.transpose(1, 2)) & ~torch.eye(n, dtype=torch.bool)
    return a.to(torch.uint8)


def scales(pages):
    return (pages.double().sum(2) + 1).rsqrt().float()


def b14_oracle(pages, s, y, exact=False):
    """float64 sum_t s_t (A_t + I) u_t, u_t = bf16(s_t y_t) (exact: the
    float32 s_t y_t)."""
    u = s[:, :, None] * y
    u = (u if exact else u.to(torch.bfloat16)).double()
    sd = s.double()[:, :, None]
    return (sd * (pages.double() @ u + u)).sum(0)


@pytest.mark.parametrize("exact", [False, True])
def test_b14_plain_against_a_float64_oracle(exact):
    r, n, d = 9, 77, 24
    pages = random_pages(r, n, 1)
    s = scales(pages)
    y = torch.randn(r, n, d, generator=torch.Generator().manual_seed(2))
    y.requires_grad_(True)
    out = b14.rel_aggregate(pages, s, y, exact=exact)
    want = b14_oracle(pages, s, y.detach(), exact)
    # float32 sums of at most n + 1 products a relation and r relations,
    # each product exact (bf16) or one rounding (float32): within (n + r)
    # 2^-24 sum |terms|
    bound = (n + r) * 2.0**-24 * b14_oracle(pages, s, y.detach().abs(), exact)
    assert torch.all((out.double() - want).abs() <= bound)
    if exact:  # the operand unrounded: a bf16-operand result lies outside
        rounded = b14_oracle(pages, s, y.detach())
        assert not torch.all((rounded - want).abs() <= bound)
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(3))
    (out * g).sum().backward()
    # the gradient of the float32 product: s_t (A_t + I)^T (s_t g), float32
    # sums of at most n + 1 terms: within 1e-6 of the largest element
    sd = s.double()[:, :, None]
    want = sd * (pages.double().transpose(1, 2) @ (sd * g.double())
                 + sd * g.double())
    assert rel_gap(y.grad, want) < 1e-6


def test_b14_column_blocks():
    assert b14.column_blocks(70) == [(0, 64, 64), (64, 70, 8)]
    assert b14.column_blocks(6) == [(0, 6, 8)]
    assert b14.column_blocks(33) == [(0, 33, 64)]
    assert b14.relation_chunk(645, 1097, 132) == 25


def test_b14_refuses_what_it_cannot_take():
    pages = random_pages(2, 10, 1)
    with pytest.raises(ValueError, match="uint8"):
        b14.rel_aggregate(pages.float(), scales(pages), torch.zeros(2, 10, 4))
    with pytest.raises(ValueError, match="s must be"):
        b14.rel_aggregate(pages, torch.zeros(3, 10), torch.zeros(2, 10, 4))


def b13_oracle(dvec, rmat, z, pages, q, seed):
    """(loss, dz, dd, dR) in float64 by autograd over the estimator."""
    dvec, rmat, z = (x.double().detach().requires_grad_(True)
                     for x in (dvec, rmat, z))
    r, n, _ = pages.shape
    logits = b13.dedicom_logits(z, dvec, rmat)
    u = ref.u24(seed, torch.arange(r), n).to(pages.device)
    cnt = sum((u < q[:, k, None, None].long()).double() for k in range(3))
    da = pages.double()
    cnt = torch.where(da > 0, 0.0, cnt)
    sp = torch.nn.functional.softplus(-logits)
    loss = torch.sum(sp * da + (sp + logits) * cnt)
    loss.backward()
    return loss.detach(), z.grad, dvec.grad, rmat.grad


def b13_inputs(r, n, d, seed, p=0.1):
    g = torch.Generator().manual_seed(seed)
    pages = random_pages(r, n, seed, p)
    z = torch.randn(n, d, generator=g) * 0.5
    dvec = torch.randn(r, d, generator=g)
    rmat = torch.randn(d, d, generator=g) / math.sqrt(d)
    q = torch.from_numpy(ref.thresholds(
        pages.sum((1, 2)).numpy(), n)).int() * 64  # a busier field
    return dvec, rmat, z, pages, q


# float32 against float64: the loss a sum of n^2 r cells, each logit a
# D-long dot; the gradients n-long sums of them (relative, of the largest)
B13_TOL = 1e-5


def b13_gaps(got, want):
    return [abs(float(got[0]) - float(want[0])) / abs(float(want[0]))] + [
        rel_gap(a, b) for a, b in zip(got[1:], want[1:])]


def test_b13_plain_against_a_float64_oracle():
    dvec, rmat, z, pages, q = b13_inputs(6, 50, 8, 4)
    got = b13.dense_bce_dedicom_plain(dvec, rmat, z, pages, q, SEED,
                                      grads=True)
    assert max(b13_gaps(got, b13_oracle(dvec, rmat, z, pages, q, SEED))) \
        < B13_TOL
    # the autograd.Function: the same gradients, scaled by the incoming one
    x = [t.clone().requires_grad_(True) for t in (dvec, rmat, z)]
    (3.0 * b13.dense_bce_dedicom_sum(*x, pages, q, SEED)).backward()
    for a, b in zip([t.grad for t in x], [got[2], got[3], got[1]]):
        assert torch.allclose(a, 3.0 * b)  # one scaling, a float32 rounding


def test_bf16_operands_in_b13_fail_its_tolerance():
    """B13's dots are float32-exact: its operands rounded to bf16 (the
    precision below a float32 product on the tensor cores) read far past
    the tolerance the card tests hold the kernel to."""
    dvec, rmat, z, pages, q = b13_inputs(6, 50, 8, 4)
    want = b13_oracle(dvec, rmat, z, pages, q, SEED)
    rnd = [t.to(torch.bfloat16).float() for t in (dvec, rmat, z)]
    got = b13.dense_bce_dedicom_plain(*rnd, pages, q, SEED, grads=True)
    assert max(b13_gaps(got, want)) > 100 * B13_TOL


def test_b13_scratch_at_decagon_shape_is_no_larger():
    """The fused launch's partials at Decagon's shape (645 drugs, 1,097
    relations, d = 32) stay within the 24,158,772 floats of the mma.sync
    kernel: they live at the step's peak."""
    size = b13.scratch_floats(645, 1097, 32)
    assert set(size) == {"loss_part", "dd_part", "dz_part", "dr_part"}
    assert sum(size.values()) <= 24_158_772
    assert size["loss_part"] == 36 * 69  # one a block: 6 x 6 tiles, 69 chunks


def test_b13_padded_width():
    assert [b13.padded_width(d) for d in (1, 8, 9, 17, 32)] == [8, 8, 16, 32,
                                                               32]
    with pytest.raises(ValueError, match="> 32"):
        b13.padded_width(33)


def test_the_chunked_layout_is_refused(data, monkeypatch):
    monkeypatch.setattr("tip_tpu_torch.train.model.dense_rgcn_feasible",
                        lambda *a, **k: False)
    with pytest.raises(ValueError, match="dense budget"):
        runner.build_variant("decagon", data, "cpu")


def test_float32_matmuls_keep_the_uint8_pages(data):
    model, graph, _ = runner.build_variant(
        "decagon", data, "cpu", matmul_precision="highest", dims=DIMS)
    assert model.gs.dd_layout == "strips_pages"
    assert model.rel_precision == "float32"
    assert graph["dd_adj_u8"].dtype == torch.uint8 and "dd_adj_t" not in graph
    model, _, _ = runner.build_variant("decagon", data, "cpu", dims=DIMS)
    assert model.rel_precision == "bfloat16"


def test_cli_decagon_synthetic_cpu(tmp_path):
    out_json = tmp_path / "m.json"
    out = subprocess.run(
        [sys.executable, "-m", "tip_tpu_torch.models", "--variant",
         "decagon", "--synthetic", "--cpu", "--epochs", "2", "--out",
         str(out_json)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    records = [json.loads(x) for x in lines if x.startswith("{")]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert records[-1]["spans"]["rel_conv"]["count"] == 2 * 2 + 2
    res = json.loads(out_json.read_text())
    assert res["variant"] == "decagon" and 0.0 <= res["final"]["auroc"] <= 1.0


# --- on the card -------------------------------------------------------------


def card_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_matmul_precision()
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n", [77, 300])
@pytest.mark.parametrize("d", [1, 6, 8, 16, 24, 32, 40, 64, 70])
def test_on_the_card_b14_at_every_width(n, d):
    """Forward within (n + r) 2^-24 sum |terms| of the float64 oracle (the
    plain version's bound: the same rounded operand, float32 sums in
    another order), at the stated precision and exact (the float32 operand
    in three bf16 terms, against the unrounded oracle); backward (three exact bf16 terms, float32 sums of at
    most n + 1 exact products) within (n + 1) 2^-24 sum |terms| of the
    float64 transposed product, element by element (a gradient of spread
    exponents: the largest element does not bound the small ones)."""
    dev = card_device()
    r = 7
    pages = random_pages(r, n, n + d).to(dev)
    s = scales(pages)
    g = torch.Generator().manual_seed(7 * d + n)
    y = torch.randn(r, n, d, generator=g).to(dev)
    out = b14.rel_aggregate_cuda(pages, s, y=y)
    want = b14_oracle(pages, s, y)
    bound = (n + r) * 2.0**-24 * b14_oracle(pages, s, y.abs())
    assert out.shape == (n, d)
    assert torch.all((out.double() - want).abs() <= bound)
    ex = b14.rel_aggregate_cuda(pages, s, y=y, exact=True)
    want = b14_oracle(pages, s, y, exact=True)
    bound = (n + r) * 2.0**-24 * b14_oracle(pages, s, y.abs(), exact=True)
    assert torch.all((ex.double() - want).abs() <= bound)
    gr = (torch.randn(n, d, generator=g) * torch.exp2(torch.randint(
        -8, 9, (n, d), generator=g).float())).to(dev)
    dy = b14.rel_aggregate_cuda(pages, s, g=gr)
    sd = s.double()[:, :, None]
    v, va = sd * gr.double(), sd * gr.double().abs()
    assert dy.shape == (r, n, d)
    bound = (n + 1) * 2.0**-24 * (sd * (pages.double() @ va + va))
    assert torch.all((dy.double() - sd * (pages.double() @ v + v)).abs()
                     <= bound)


@pytest.mark.card
@pytest.mark.parametrize("r", [1, 5, b13.RC + 1])
@pytest.mark.parametrize("n", [2, 50, 63, 64, 65, 129, 300, 645])
@pytest.mark.parametrize("d", [1, 8, 13, 16, 24, 32])
def test_on_the_card_b13_at_every_width(n, d, r):
    """The loss and the three gradients within B13_TOL of the float64
    oracle and of the plain version on the card: n on both sides of the
    tile's warpgroup (64 rows), its logit block (32 columns) and its edge
    (128), one relation and one more than a block's chunk (n = 2: the
    smallest plane with an edge, denser pages so that every case has
    one)."""
    dev = card_device()
    dvec, rmat, z, pages, q = (t.to(dev) for t in b13_inputs(
        r, n, d, n + d, p=0.6 if n < 8 else 0.1))
    got = b13.dense_bce_dedicom_cuda(dvec, rmat, z, pages, q, SEED,
                                     grads=True)
    want = b13_oracle(dvec, rmat, z, pages, q, SEED)
    assert max(b13_gaps(got, want)) < B13_TOL
    plain = b13.dense_bce_dedicom_plain(dvec, rmat, z, pages, q, SEED,
                                        grads=True)
    assert max(b13_gaps(got, plain)) < B13_TOL


@pytest.mark.card
@pytest.mark.parametrize("n,d", [(65, 16), (645, 32)])
def test_on_the_card_b13_reruns_are_bit_equal(n, d):
    """Fixed-order partial sums: two fused launches give the same bits."""
    dev = card_device()
    args = [t.to(dev) for t in b13_inputs(b13.RC + 1, n, d, 7)]
    one = b13.dense_bce_dedicom_cuda(*args, SEED, grads=True)
    two = b13.dense_bce_dedicom_cuda(*args, SEED, grads=True)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.card
@pytest.mark.parametrize("n,d", [(65, 8), (129, 16), (645, 32)])
def test_on_the_card_b13_value_only_loss_is_the_fused_loss(n, d):
    """The value-only launch adds the same cells in the same order as the
    fused one: the two losses are bit-equal."""
    dev = card_device()
    args = [t.to(dev) for t in b13_inputs(b13.RC + 1, n, d, 9)]
    fused = b13.dense_bce_dedicom_cuda(*args, SEED, grads=True)[0]
    value = b13.dense_bce_dedicom_cuda(*args, SEED, grads=False)
    assert torch.equal(fused, value)


@pytest.mark.card
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_on_the_card_a_step_against_the_plain_reference(precision):
    """A Decagon step on the card (B14, B12, B13) against the plain
    reference on the CPU, at the test graph's size: z, the loss and the
    gradients, as the CPU test holds the plain versions; at the stated
    precision and with float32 matmuls pinned (B14's forward exact)."""
    dev = card_device()
    raw = synthetic_trigraph(n_drug=40, n_prot=60, n_et=5, pairs_per_et=60,
                             n_pp_pairs=150, n_dp=50, seed=3)
    data = build_trigraph(raw, 0.9, 1111)
    graph, gs = make_decagon_graph_arrays(data, dev)
    model = DecagonModel.for_data(DecagonConfig(**DIMS), gs, dev,
                                  rel_precision=precision)
    params = model.init(torch.Generator().manual_seed(11))
    cpu = clone({k: {j: v.cpu() for j, v in d.items()}
                 for k, d in params.items()})
    params = clone(params)
    from tip_tpu_torch import kernels

    kernels.reset_launch_counts()
    loss = model.loss(params, graph, SEED)
    loss.backward()
    assert kernels.LAUNCHES["rel_aggregate"] == 4
    assert kernels.LAUNCHES["dense_bce_dedicom"] == 1
    g = plain_graph(data)
    loss_ref = ref.loss(g, cpu, SEED, dd_bf16=precision == "bfloat16")
    loss_ref.backward()
    # the kernels' float32 sums in other orders (B13 3xTF32) than the CPU's
    assert abs(loss.item() - loss_ref.item()) < 1e-5 * abs(loss_ref.item())
    for (path, a), (_, b) in zip(ref.leaves(params), ref.leaves(cpu)):
        # the kernels' sums in another order than the CPU's: a bf16
        # operand of layer 2 may round the other way
        assert rel_gap(a.grad.cpu(), b.grad) < 1e-3, path


@pytest.mark.card
def test_on_the_card_at_decagon_shape():
    """B14 (d = 64 and 32, both passes, the forward also exact) and B13
    (d = 32, uint8 pages) against their plain versions on the card at
    Decagon's shape: R = 1,097 symmetric pages of 645 drugs at its train
    density."""
    dev = card_device()
    r, n = 1097, 645
    g = torch.Generator(device=dev).manual_seed(13)
    a = torch.rand((r, n, n), generator=g, device=dev) < 0.01
    pages = ((a | a.transpose(1, 2)) & ~torch.eye(
        n, dtype=torch.bool, device=dev)).to(torch.uint8)
    del a
    s = scales(pages)
    for d in (64, 32):
        y = torch.randn(r, n, d, generator=g, device=dev)
        bound = (n + r) * 2.0**-24 * b14.rel_aggregate_plain(pages, s, y.abs())
        out = b14.rel_aggregate_cuda(pages, s, y=y)
        assert torch.all((out - b14.rel_aggregate_plain(pages, s, y)).abs()
                         <= bound)
        ex = b14.rel_aggregate_cuda(pages, s, y=y, exact=True)
        want = b14.rel_aggregate_plain(pages, s, y, rounded=False)
        bound = (n + r) * 2.0**-24 * b14.rel_aggregate_plain(
            pages, s, y.abs(), rounded=False)
        assert torch.all((ex - want).abs() <= bound)
        gr = torch.randn(n, d, generator=g, device=dev)
        dy = b14.rel_aggregate_cuda(pages, s, g=gr)
        bound = (n + 1) * 2.0**-24 * b14.rel_aggregate_t_plain(pages, s,
                                                               gr.abs())
        assert torch.all((dy - b14.rel_aggregate_t_plain(pages, s, gr)).abs()
                         <= bound)
    z = torch.randn(n, 32, generator=g, device=dev) * 0.5
    dvec = torch.randn(r, 32, generator=g, device=dev)
    rmat = torch.randn(32, 32, generator=g, device=dev) / math.sqrt(32)
    q = torch.from_numpy(ref.thresholds(
        pages.sum((1, 2)).cpu().numpy(), n)).int().to(dev)
    got = b13.dense_bce_dedicom_cuda(dvec, rmat, z, pages, q, SEED,
                                     grads=True)
    want = b13.dense_bce_dedicom_plain(dvec, rmat, z, pages, q, SEED,
                                       grads=True)
    assert max(b13_gaps(got, want)) < B13_TOL
