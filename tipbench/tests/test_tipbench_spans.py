"""The readers of the program's spans (lib/spans.py and the metrics of
source program_span) on a report made by hand, on one the program makes,
and on a program without the recorder."""

import builtins

import pytest

from tipbench.lib import spans
from tipbench.metrics import (
    backward_host_ms,
    cache_s,
    device_graph_s,
    forward_host_ms,
)

READERS = (forward_host_ms, backward_host_ms, cache_s, device_graph_s)


def span(name, start, end, parent=None, tid=1):
    return {"name": name, "parent": parent, "tid": tid, "start_ns": start,
            "end_ns": end}


REPORT = {
    "totals": {"cache": {"count": 1, "s": 2.5, "self_s": 2.5},
               "device_graph": {"count": 1, "s": 1.25, "self_s": 1.0},
               "forward": {"count": 40, "s": 9.0, "self_s": 1.0}},
    "session": [span("forward", 0, 4_000_000),
                span("encode", 1_000_000, 2_000_000, parent=0),
                span("backward", 5_000_000, 11_000_000, tid=2),
                span("forward", 20_000_000, 22_000_000),
                span("backward", 23_000_000, 33_000_000, tid=2),
                span("forward", 40_000_000, None)],  # still open
}


def test_readers_on_a_hand_made_report(monkeypatch):
    monkeypatch.setattr(spans, "program_report", lambda: REPORT)
    assert forward_host_ms.read({}) == pytest.approx(3.0)  # (4 + 2) / 2
    assert backward_host_ms.read({}) == pytest.approx(8.0)  # (6 + 10) / 2
    assert cache_s.read({}) == 2.5
    assert device_graph_s.read({}) == 1.25


def test_readers_without_the_spans_return_nothing(monkeypatch):
    monkeypatch.setattr(spans, "program_report",
                        lambda: {"totals": {}, "session": []})
    assert [m.read({}) for m in READERS] == [None] * 4
    monkeypatch.setattr(spans, "program_report", lambda: None)
    assert [m.read({}) for m in READERS] == [None] * 4


def test_a_program_without_the_recorder_gives_no_report(monkeypatch):
    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "tip_tpu_torch" and "trace" in (fromlist or ()):
            raise ImportError("cannot import name 'trace'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert spans.program_report() is None
    assert [m.read({}) for m in READERS] == [None] * 4


def test_the_program_report_holds_its_spans():
    from tip_tpu_torch import trace

    with trace.recording():
        with trace.span("cache"):
            pass
    report = spans.program_report()
    assert report["totals"]["cache"]["count"] >= 1
    assert [s["name"] for s in report["session"]] == ["cache"]
    assert cache_s.read({}) >= 0.0
