"""The port's span recorder (tip_tpu_torch/trace.py): nesting, self time,
totals and threads; nothing raw and no record_function with tracing off,
and the autograd graph as it was; the spans in a torch.profiler trace on
its clock; forward, backward and the ops' backward spans of a tiny TIP
step, with gradients bitwise those of an untraced step; the eval and
set-up spans; tools/idle_by_span.py on a trace made by hand.

The test marked ``card`` runs on the card (it skips itself here): ``python
-m pytest tests/test_torch_trace.py -m card --noconftest -q`` (the tests'
conftest imports JAX, which the card's machine lacks).
"""

import importlib.util
import itertools
import json
import os
import threading
import types

import pytest
import torch

from tip_tpu_torch import trace
from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.convert import leaves
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.data.cache import cached_trigraph
from tip_tpu_torch.models.dd import DDConfig, DDModel, make_dd_graph_arrays
from tip_tpu_torch.train.model import TIP, make_graph_arrays, make_test_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_KW = dict(n_drug=40, n_prot=70, n_et=5, pairs_per_et=50, seed=4)
SMALL = dict(dd_chunk=32, pp_window=64, pp_chunk=32)
WIDTHS = dict(mode="cat", prot_drug_dim=6, n_embed=10, n_hid1=8, n_hid2=8,
              num_base=4, pp_hid1=8, pp_hid2=6)
# each layout's ops with a backward span in a TIP-cat step
OPS = {"chunked": {"typed_neighbor_sum", "gcn_spmm", "distmult_logits"},
       "strips": {"dense_bce_sym", "pp_aggregate", "rgcn_contract"}}


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "idle_by_span", os.path.join(ROOT, "tools", "idle_by_span.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock ticking 10 ns a reading."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(trace, "_clock", lambda: next(ticks))


@pytest.fixture(scope="module")
def data():
    return build_trigraph(synthetic_trigraph(**RAW_KW), split_rate=0.9,
                          seed=4)


def tip_step(data, layout: str, device="cpu", remat: bool = False):
    """A tiny TIP-cat on ``layout``: (model, graph, params, loss of one
    step, grads by leaf after its backward)."""
    graph, gs = make_graph_arrays(
        data, device, dense_dtype="bfloat16" if layout == "strips" else None,
        **SMALL)
    assert gs.dd_layout == layout
    model = TIP.for_data(ModelConfig(**WIDTHS), data, gs, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    loss = model.loss(params, graph, 7, remat=remat)
    loss.backward()
    return model, graph, params, loss, [p.grad for p in leaves(params)]


def under(raw, i, j) -> bool:
    """Whether span i of a session lies under span j."""
    while raw[i]["parent"] is not None:
        i = raw[i]["parent"]
        if i == j:
            return True
    return False


def autograd_graph(root):
    """The autograd graph below node ``root``: [(node class, [child
    positions])] in the order a walk from the root first meets each node."""
    order, out = {}, []
    stack = [root]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in order:
            continue
        order[id(fn)] = len(out)
        out.append(fn)
        stack.extend(n for n, _ in reversed(fn.next_functions))
    return [(type(fn).__name__,
             [order.get(id(n)) for n, _ in fn.next_functions]) for fn in out]


def test_spans_nest_with_self_time_and_totals(clock):
    rec = trace.Recorder()
    with rec.span("a"):           # opens at 0
        with rec.span("b"):       # 10
            pass                  # closes at 20
        with rec.span("b"):       # 30
            pass                  # 40
    tot = rec.totals()            # a closes at 50
    assert tot["a"]["count"] == 1 and tot["b"]["count"] == 2
    assert tot["a"]["s"] == pytest.approx(50e-9)
    assert tot["a"]["self_s"] == pytest.approx(30e-9)
    assert tot["b"]["s"] == tot["b"]["self_s"] == pytest.approx(20e-9)
    assert rec.session() == []  # nothing traced
    with rec.span("a"):
        pass
    since = rec.totals(since=tot)
    assert set(since) == {"a"} and since["a"]["count"] == 1
    assert since["a"]["s"] == pytest.approx(10e-9)


def test_each_thread_keeps_its_own_stack_and_table():
    rec = trace.Recorder()

    def work():
        with rec.span("worker"):
            with rec.span("inner"):
                pass

    with rec.recording():
        with rec.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    tot = rec.totals()
    assert tot["main"]["count"] == tot["worker"]["count"] == 1
    # the worker's span is no child of the span open on the main thread
    assert tot["main"]["self_s"] == pytest.approx(tot["main"]["s"])
    by_name = {s["name"]: s for s in rec.session()}
    names = [s["name"] for s in rec.session()]
    assert by_name["main"]["tid"] == threading.get_native_id()
    assert by_name["worker"]["tid"] == by_name["inner"]["tid"] != \
        by_name["main"]["tid"]
    assert by_name["worker"]["parent"] is None
    assert by_name["inner"]["parent"] == names.index("worker")
    assert all(s["end_ns"] >= s["start_ns"] for s in rec.session())


def test_a_span_opened_by_hand_closes_on_another_thread():
    rec = trace.Recorder()
    with rec.recording():
        with rec.span("outer"):
            handle = rec.open("hand")
            with rec.span("child"):
                pass
            t = threading.Thread(target=rec.close, args=(handle,))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with rec.span("after"):
                pass
    s = {x["name"]: x for x in rec.session()}
    assert s["hand"]["end_ns"] is not None and s["child"]["parent"] == 1
    assert s["after"]["parent"] == 0 and s["outer"]["end_ns"] is not None
    tot = rec.totals()
    assert tot["hand"]["count"] == tot["outer"]["count"] == 1


def test_a_backward_that_raises_leaves_no_frame_behind():
    rec = trace.Recorder()

    class Boom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            raise RuntimeError("boom")

    x = torch.ones(2, requires_grad=True)
    with rec.recording():
        with pytest.raises(RuntimeError, match="boom"):
            rec.backward_span(Boom.apply(x).sum()).backward()
        with rec.span("after"):  # outside the engine: the frame is stale
            pass
        with pytest.raises(RuntimeError, match="boom"):
            rec.backward_span(Boom.apply(x).sum()).backward()
        rec.backward_span((2 * x).sum()).backward()  # its open drops it
        with rec.span("last"):
            pass
    raw = rec.session()
    assert [s["name"] for s in raw] == [
        "backward", "after", "backward", "backward", "last"]
    assert raw[0]["end_ns"] is None and raw[2]["end_ns"] is None
    assert raw[3]["end_ns"] is not None
    assert all(s["parent"] is None for s in raw)
    tot = rec.totals()
    assert tot["backward"]["count"] == 1
    assert tot["last"]["self_s"] == tot["last"]["s"]


def test_a_new_session_replaces_the_last():
    rec = trace.Recorder()
    with rec.recording():
        with rec.span("first"):
            pass
    with rec.span("untraced"):
        pass
    assert [s["name"] for s in rec.session()] == ["first"]
    with rec.recording():
        with rec.span("second"):
            pass
    assert [s["name"] for s in rec.session()] == ["second"]


def test_tracing_off_keeps_nothing_raw_and_opens_no_record_function(
        monkeypatch, data):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    profiler = types.SimpleNamespace(_is_profiler_enabled=False,
                                     record_function=Counting)
    monkeypatch.setattr(trace, "_profiler", profiler)
    rec = trace.Recorder()
    with rec.span("x"):
        pass
    assert rec.session() == [] and opened == []
    with rec.recording():  # raw spans, no profiler to take annotations
        with rec.span("x"):
            pass
    assert opened == [] and len(rec.session()) == 1
    profiler._is_profiler_enabled = True
    with rec.span("y"):
        pass
    assert opened == ["y"] and [s["name"] for s in rec.session()] == ["y"]
    profiler._is_profiler_enabled = False
    # the program's own spans: a step untraced opens no record_function
    before = trace.totals()
    *_, loss, _ = tip_step(data, "chunked")
    assert opened == ["y"]
    assert trace.totals(since=before)["forward"]["count"] == 1
    assert "backward" not in trace.totals(since=before)


def test_tracing_off_leaves_the_autograd_graph_and_grads_as_they_were(
        monkeypatch, data):
    *_, loss_off, grads_off = tip_step(data, "chunked")
    with monkeypatch.context() as m:
        m.setattr(trace, "backward_span", lambda loss: loss)
        *_, loss_bare, grads_bare = tip_step(data, "chunked")
    assert type(loss_off.grad_fn) is type(loss_bare.grad_fn)
    assert autograd_graph(loss_off.grad_fn) == \
        autograd_graph(loss_bare.grad_fn)
    assert all(torch.equal(a, b) for a, b in zip(grads_off, grads_bare))
    with trace.recording():
        *_, loss_on, _ = tip_step(data, "chunked")
    root = loss_on.grad_fn
    assert type(root).__name__ == "_BackwardMarkBackward"
    assert autograd_graph(root.next_functions[0][0]) == \
        autograd_graph(loss_off.grad_fn)


def test_a_profiler_session_holds_the_spans_on_its_clock(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert trace.tracing()
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(3).add_(1)
    assert not trace.tracing()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    op = next(e for e in events if e.get("cat") == "cpu_op"
              and e["name"] == "aten::add_")
    for outer, inner in (("outer", "inner"), ("inner", op)):
        a = ann[outer]
        b = ann[inner] if isinstance(inner, str) else inner
        assert a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"]
    assert ann["outer"]["tid"] == threading.get_native_id()
    raw = trace.session()
    assert [s["name"] for s in raw] == ["outer", "inner"]
    assert raw[1]["parent"] == 0 and raw[0]["tid"] == ann["outer"]["tid"]


@pytest.mark.parametrize("layout", ["chunked", "strips"])
def test_backward_follows_forward_and_holds_the_ops(data, layout):
    *_, grads_off = tip_step(data, layout)
    with trace.recording():
        *_, grads_on = tip_step(data, layout)
        raw = trace.session()
    assert all(torch.equal(a, b) for a, b in zip(grads_off, grads_on))
    names = [s["name"] for s in raw]
    fwd, bwd = raw[names.index("forward")], raw[names.index("backward")]
    assert names.count("forward") == names.count("backward") == 1
    assert bwd["start_ns"] >= fwd["end_ns"] and bwd["end_ns"] is not None

    kids = {s["name"] for i, s in enumerate(raw)
            if under(raw, i, names.index("backward"))}
    assert kids == OPS[layout]
    fkids = {s["name"] for i, s in enumerate(raw)
             if under(raw, i, names.index("forward"))}
    assert fkids == {"encode", "pp_gcn", "hierarchy", "rgcn", "loss"}


def test_remat_recomputes_encode_inside_backward(data):
    with trace.recording():
        tip_step(data, "chunked", remat=True)
        raw = trace.session()
    names = [s["name"] for s in raw]
    enc = [i for i, n in enumerate(names) if n == "encode"]
    assert len(enc) == 2
    assert raw[enc[0]]["parent"] == names.index("forward")
    assert under(raw, enc[1], names.index("backward"))


def test_eval_holds_encode_score_and_rank(data):
    model, graph, params, *_ = tip_step(data, "chunked")
    test = make_test_arrays(data, "cpu")
    neg = model.sample_test_negatives(torch.Generator().manual_seed(1), test)
    with trace.recording():
        model.evaluate(params, graph, test, neg)
        raw = trace.session()
    assert raw[0]["name"] == "eval"
    assert [s["name"] for s in raw if s["parent"] == 0] == [
        "encode", "score", "rank"]


def test_dd_model_spans(data):
    graph, gs = make_dd_graph_arrays(data, "cpu", dense_dtype=None, chunk=32,
                                     decoder="nn")
    model = DDModel.for_data(DDConfig(decoder="nn"), gs, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    with trace.recording():
        model.loss(params, graph, 3).backward()
        raw = trace.session()
    names = [s["name"] for s in raw]
    assert names[:4] == ["forward", "encode", "rgcn", "loss"]
    assert {"typed_neighbor_sum", "nn_logits"} <= set(names[4:])
    assert raw[names.index("nn_logits")]["parent"] == names.index("backward")


def test_set_up_spans(tmp_path):
    raw = synthetic_trigraph(**RAW_KW)
    before = trace.totals()
    d = cached_trigraph(raw, 0.9, 4, cache_dir=str(tmp_path))  # builds
    cached_trigraph(raw, 0.9, 4, cache_dir=str(tmp_path))  # loads
    make_graph_arrays(d, "cpu", **SMALL)
    make_dd_graph_arrays(d, "cpu", chunk=32)
    tot = trace.totals(since=before)
    assert tot["cache"]["count"] == 2 and tot["device_graph"]["count"] == 2
    assert tot["cache"]["s"] > 0.0


def test_idle_by_span_on_a_hand_made_trace(tmp_path, capsys):
    tool = load_tool()

    def x(cat, name, ts, dur, tid=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                **({} if tid is None else {"tid": tid})}

    events = [
        x("user_annotation", tool.WINDOW, 0, 100, 1),
        x("user_annotation", "forward", 0, 40, 1),
        x("user_annotation", "encode", 5, 20, 1),
        x("user_annotation", "backward", 50, 40, 2),  # the engine's thread
        x("user_annotation", "typed_neighbor_sum", 60, 10, 2),
        x("cpu_op", "aten::mm", 41, 8, 1),
        x("kernel", "k", 0, 5), x("kernel", "k", 20, 20),
        x("gpu_memcpy", "c", 45, 15), x("kernel", "k", 70, 25),
        x("kernel", "outside", 150, 10),
    ]
    out = tool.idle_by_span(events)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(65e-6)
    # [5, 20] under encode, [40, 45] and [95, 100] under no span, [60, 70]
    # under the second thread's span
    by = {k: v for k, v, _ in out["by_span"]}
    assert by == pytest.approx({"forward/encode": 15e-6,
                                "backward/typed_neighbor_sum": 10e-6,
                                tool.NO_SPAN: 10e-6})
    assert sum(s for _, _, s in out["by_span"]) == pytest.approx(1.0)
    # without the window: the first span's start to the last one's end
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events[1:]}))
    assert tool.main([str(path), "--top", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["window_s"] == pytest.approx(90e-6)
    assert out["by_span"] == [["forward/encode", pytest.approx(15e-6),
                               pytest.approx(0.5)]]


@pytest.mark.card
def test_on_the_card_backward_runs_on_the_engine_thread_and_adds_no_launch(
        data, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    with trace.recording():
        tip_step(data, "strips", device=dev)
        raw = trace.session()
    names = [s["name"] for s in raw]
    bwd = raw[names.index("backward")]
    assert raw[names.index("forward")]["tid"] == threading.get_native_id()
    assert bwd["tid"] != threading.get_native_id()
    op = raw[names.index("dense_bce_sym")]
    assert op["parent"] == names.index("backward") and op["tid"] == bwd["tid"]

    graph, gs = make_graph_arrays(data, dev, dense_dtype="bfloat16", **SMALL)
    model = TIP.for_data(ModelConfig(**WIDTHS), data, gs, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves(params), lr=0.01)

    def step(k):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, graph, k)
        loss.backward()
        opt.step()
        return float(loss)

    def launches(k):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(k)
            torch.cuda.synchronize()
        path = tmp_path / f"{k}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        return sum(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   for e in events)

    for k in range(3):
        step(k)
    on = launches(3)
    assert trace.session()[0]["name"] == "forward"
    with monkeypatch.context() as m:  # the profiler on, the recorder off
        m.setattr(trace, "_profiler", types.SimpleNamespace(
            _is_profiler_enabled=False,
            record_function=torch.autograd.profiler.record_function))
        off = launches(4)
    assert on == off > 0
