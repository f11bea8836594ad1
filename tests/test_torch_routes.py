"""The D-D model contract that TIP, DR-DF/DR-NN and Decagon share
(tip_tpu_torch/train/model.py), on small seeded graphs on the CPU:

* the seams other code reaches by name: one ``loss`` calls the fused loss
  entry of its route exactly once, through the module-level names
  ``train.model.dense_bce_sym_sum`` / ``dense_bce_sum`` and
  ``models.dd.dense_bce_nn_sum`` with their positional signatures; an
  ``encode`` set on the instance is what ``loss`` and ``evaluate`` run;
* packing: every packer ships, for each layout, the keys (in order),
  dtypes, shapes, bytes and contents, and returns the ``GraphStatic``,
  recorded in ``tests/golden/dd_contract.json``;
* the loops: ``train`` and ``train_variant`` give the recorded loss
  histories and take every step through ``train_step``.

The golden file was written by the packers and loops as they stood before
the three families shared their code.  Rewrite it only where a change is
meant to alter what is shipped or learned: ``python
tests/test_torch_routes.py --write``.
"""

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.data.packing import TypedEdges
from tip_tpu_torch.models import runner
from tip_tpu_torch.models.dd import DDConfig, DDModel, make_dd_graph_arrays
from tip_tpu_torch.models.decagon import (
    DecagonConfig,
    DecagonModel,
    make_decagon_graph_arrays,
)
from tip_tpu_torch.train import loop
from tip_tpu_torch.train.model import TIP, make_graph_arrays, make_test_arrays

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "dd_contract.json")
RAW_KW = dict(n_drug=40, n_prot=60, n_et=5, pairs_per_et=60, n_pp_pairs=150,
              n_dp=50, seed=3)
SMALL = dict(dd_chunk=32, pp_window=64, pp_chunk=32)
TIP_WIDTHS = dict(mode="cat", prot_drug_dim=6, n_embed=10, n_hid1=8,
                  n_hid2=8, num_base=4, pp_hid1=8, pp_hid2=6)
DD_WIDTHS = dict(n_embed=8, n_hid1=8, n_hid2=8, num_base=4,
                 nn_decoder_l1_dim=8)
EPOCHS = 3


def small_data():
    return build_trigraph(synthetic_trigraph(**RAW_KW), 0.9, 1111)


def heavy(data, copies=130):
    """``copies`` more of one pair in relation 0: a count past int8 (no
    strips) within bf16's exact range (bf16 pages)."""
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


def dup_pp(data):
    """One normalized P-P edge twice (still destination-sorted): a 0/1
    (A+I) cannot hold it, so the P-P side ships sparse."""
    idx, w = data.pp_norm_index, data.pp_norm_weight
    k = idx.shape[1] // 2
    return dataclasses.replace(
        data, pp_norm_index=np.insert(idx, k, idx[:, k], axis=1),
        pp_norm_weight=np.insert(w, k, w[k]))


def packings(data):
    """name -> () -> (graph, gs), one per layout of each packer."""
    hv, dup = heavy(data), dup_pp(data)
    tip = {"chunked": dict(dense_dtype=None),
           "strips": dict(dense_dtype="bfloat16"),
           "strips sampled": dict(dense_dtype="bfloat16", sampled=True),
           "pages": dict(dense_dtype="float32"),
           "pages sampled": dict(dense_dtype="float32", sampled=True),
           "strips nn": dict(dense_dtype="bfloat16", decoder="nn"),
           "pages nn": dict(dense_dtype="float32", decoder="nn"),
           "chunked nn": dict(dense_dtype=None, decoder="nn"),
           "strips windowed pp": dict(dense_dtype="bfloat16", pp_dense=False),
           "chunked dense pp": dict(dense_dtype=None, pp_dense=True)}
    out = {f"tip {k}": (lambda kw=kw: make_graph_arrays(data, "cpu", **SMALL,
                                                        **kw))
           for k, kw in tip.items()}
    out["tip pages bf16"] = lambda: make_graph_arrays(
        hv, "cpu", dense_dtype="bfloat16", **SMALL)
    out["tip strips duplicate pp"] = lambda: make_graph_arrays(
        dup, "cpu", dense_dtype="bfloat16", **SMALL)
    for dec in ("distmult", "nn"):
        for name, dtype in (("chunked", None), ("strips", "bfloat16"),
                            ("pages", "float32")):
            out[f"dd {dec} {name}"] = (
                lambda dec=dec, dtype=dtype: make_dd_graph_arrays(
                    data, "cpu", chunk=32, dense_dtype=dtype, decoder=dec))
        out[f"dd {dec} strips sampled"] = lambda dec=dec: make_dd_graph_arrays(
            data, "cpu", chunk=32, dense_dtype="bfloat16", decoder=dec,
            sampled=True)
    out["dd distmult pages sampled"] = lambda: make_dd_graph_arrays(
        data, "cpu", chunk=32, dense_dtype="float32", sampled=True)
    out["dd distmult pages bf16"] = lambda: make_dd_graph_arrays(
        hv, "cpu", chunk=32, dense_dtype="bfloat16")
    out["decagon"] = lambda: make_decagon_graph_arrays(data, "cpu")
    out["decagon duplicate pp"] = lambda: make_decagon_graph_arrays(dup, "cpu")
    return out


def digest(t: torch.Tensor) -> str:
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return hashlib.sha1(raw).hexdigest()[:16]


def shipped(graph, gs) -> dict:
    return {"tensors": [[k, str(v.dtype), list(v.shape),
                         v.numel() * v.element_size(), digest(v)]
                        for k, v in graph.items()],
            "static": dataclasses.asdict(gs)}


def loop_runs(data):
    """name -> () -> [loss of each epoch]: ``train`` on TIP's strips and
    chunked layouts, ``train_variant`` on DR-DF, DR-NN and Decagon."""
    tcfg = TrainConfig(epochs=EPOCHS, seed=5)

    def tip(chunked):
        def run():
            if chunked:  # the chunked layout, as past the dense budget
                real, loop.preferred_dense_dtype = (loop.preferred_dense_dtype,
                                                    lambda *a, **k: None)
            try:
                _, res = loop.train(ModelConfig(**TIP_WIDTHS), tcfg, data,
                                    log=lambda s: None, device="cpu")
            finally:
                if chunked:
                    loop.preferred_dense_dtype = real
            return [h["loss"] for h in res["history"]]
        return run

    def variant(name, dims):
        def run():
            model, graph, test = runner.build_variant(name, data, "cpu",
                                                      dims=dims)
            _, res = runner.train_variant(model, graph, test, epochs=EPOCHS,
                                          seed=5, log=None)
            return [h["loss"] for h in res["history"]]
        return run

    return {"tip strips": tip(False), "tip chunked": tip(True),
            "dr-df": variant("dr-df", dict(n_embed=8, n_hid1=8, n_hid2=8,
                                           num_base=4)),
            "dr-nn": variant("dr-nn", dict(n_embed=8, n_hid1=8, n_hid2=8,
                                           num_base=4)),
            "decagon": variant("decagon", dict(n_hid1=16, n_hid2=8))}


def dumps(golden: dict) -> str:
    """The golden file's text: one line a packing or loop."""
    parts = [",\n".join(f"  {json.dumps(k)}: {json.dumps(v)}"
                         for k, v in golden[group].items())
             for group in ("packing", "loops")]
    return ('{\n "packing": {\n' + parts[0] + '\n },\n "loops": {\n'
            + parts[1] + "\n }\n}\n")


def record(data) -> dict:
    return {"packing": {k: shipped(*f()) for k, f in packings(data).items()},
            "loops": {k: f() for k, f in loop_runs(data).items()}}


@pytest.fixture(scope="module")
def data():
    return small_data()


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


PACKINGS = [
    "tip chunked", "tip strips", "tip strips sampled", "tip pages",
    "tip pages sampled", "tip strips nn", "tip pages nn", "tip chunked nn",
    "tip strips windowed pp", "tip chunked dense pp", "tip pages bf16",
    "tip strips duplicate pp", "dd distmult chunked", "dd distmult strips",
    "dd distmult pages", "dd distmult strips sampled", "dd nn chunked",
    "dd nn strips", "dd nn pages", "dd nn strips sampled",
    "dd distmult pages sampled", "dd distmult pages bf16", "decagon",
    "decagon duplicate pp"]


@pytest.mark.parametrize("name", PACKINGS)
def test_each_packer_ships_what_it_shipped(data, golden, name):
    got = shipped(*packings(data)[name]())
    want = golden["packing"][name]
    # in order: the order the tensors reach the device in
    assert [t[0] for t in got["tensors"]] == [t[0] for t in want["tensors"]]
    for g, w in zip(got["tensors"], want["tensors"]):
        assert g == w, g[0]
    assert got["static"] == want["static"]


@pytest.mark.parametrize("name", ["tip strips", "tip chunked", "dr-df",
                                  "dr-nn", "decagon"])
def test_both_loops_step_through_train_step_as_before(data, golden, name,
                                                      monkeypatch):
    calls = []
    real = loop.train_step

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(loop, "train_step", counted)
    monkeypatch.setattr(runner, "train_step", counted)
    losses = loop_runs(data)[name]()
    assert len(calls) == EPOCHS
    np.testing.assert_allclose(losses, golden["loops"][name], rtol=1e-6)


# the module-level names the benchmark's faults patch, by route
ENTRIES = {"sym": "tip_tpu_torch.train.model.dense_bce_sym_sum",
           "pages": "tip_tpu_torch.train.model.dense_bce_sum",
           "nn": "tip_tpu_torch.models.dd.dense_bce_nn_sum"}


def _model(data, family, dense_dtype):
    if family == "tip":
        graph, gs = make_graph_arrays(data, "cpu", dense_dtype=dense_dtype,
                                      **SMALL)
        return TIP.for_data(ModelConfig(**TIP_WIDTHS), data, gs, "cpu"), graph
    if family == "decagon":
        graph, gs = make_decagon_graph_arrays(data, "cpu")
        return DecagonModel.for_data(DecagonConfig(n_hid1=16, n_hid2=8), gs,
                                     "cpu"), graph
    graph, gs = make_dd_graph_arrays(data, "cpu", chunk=32,
                                     dense_dtype=dense_dtype, decoder=family)
    return DDModel.for_data(DDConfig(decoder=family, **DD_WIDTHS), gs,
                            "cpu"), graph


@pytest.mark.parametrize("family,dense_dtype,layout,entry", [
    ("tip", "bfloat16", "strips", "sym"),
    ("tip", "float32", "pages", "pages"),
    ("distmult", "bfloat16", "strips", "sym"),
    ("nn", "bfloat16", "strips_pages", "nn")])
def test_one_loss_calls_its_routes_entry_once(data, monkeypatch, family,
                                              dense_dtype, layout, entry):
    calls = {k: 0 for k in ENTRIES}

    def counting(key, orig):
        if key == "nn":
            def wrapped(w1, w2, h1, h2, pages, q, seed, u24=None):
                calls[key] += 1
                return orig(w1, w2, h1, h2, pages, q, seed, u24=u24)
        else:
            def wrapped(w, z, pages, q, seed, u24=None):
                calls[key] += 1
                return orig(w, z, pages, q, seed, u24=u24)
        return wrapped

    for key, target in ENTRIES.items():
        module, name = target.rsplit(".", 1)
        orig = getattr(sys.modules[module], name)
        monkeypatch.setattr(target, counting(key, orig))
    model, graph = _model(data, family, dense_dtype)
    assert model.gs.dd_layout == layout
    params = model.init(torch.Generator().manual_seed(0))
    loss = model.loss(params, graph, 7)
    assert torch.isfinite(loss)
    assert calls == {k: int(k == entry) for k in ENTRIES}


@pytest.mark.parametrize("family", ["tip", "distmult", "nn", "decagon"])
def test_an_encode_set_on_the_instance_is_what_loss_and_evaluate_run(
        data, family):
    model, graph = _model(data, family, "bfloat16")
    params = model.init(torch.Generator().manual_seed(0))
    test = make_test_arrays(data, "cpu")
    neg = model.sample_test_negatives(torch.Generator().manual_seed(1), test)
    base_loss = model.loss(params, graph, 7).item()
    _, base_avg = model.evaluate(params, graph, test, neg)
    seen = []
    encode = model.encode

    def zeroed(*args, **kw):
        seen.append(1)
        return encode(*args, **kw) * 0.0

    object.__setattr__(model, "encode", zeroed)
    try:
        loss = model.loss(params, graph, 7).item()
        _, avg = model.evaluate(params, graph, test, neg)
    finally:
        object.__delattr__(model, "encode")
    assert len(seen) == 2
    # z = 0: every logit is 0, so the loss moves and the ranks tie
    assert loss != base_loss
    assert float(avg["auroc"]) == 0.5 != float(base_avg["auroc"])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_routes.py --write")
    torch.set_num_threads(1)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        f.write(dumps(record(small_data())))
