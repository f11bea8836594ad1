"""The reduction of a profiler trace to busy time, launches, device time by
name and idle gaps by host operation, on a trace made by hand."""

import pytest

from tipbench.lib import trace
from tipbench.metrics import (
    b1_roofline,
    device_idle_share,
    gemm_ms,
    launches_per_step,
)

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0,
     "dur": 100, "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50,
     "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 55, "dur": 40,
     "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "other thread", "ts": 0, "dur": 100,
     "tid": 2},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32", "ts": 10,
     "dur": 20},
    {"ph": "X", "cat": "kernel",
     "name": "void (anonymous namespace)::tile_kernel<16, true>(float)",
     "ts": 20, "dur": 20},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 60,
     "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "outside", "ts": 150, "dur": 10},
]


def test_reduce_trace():
    s = trace.reduce_trace(EVENTS)
    assert s["wall_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)  # [10, 40] and [60, 70]
    assert s["launches"] == 3
    gaps = dict(s["breakdown"]["idle_gaps"])
    # [0, 10] and [40, 60] under aten::mm (mid 50 is its end), [70, 100]
    # under aten::add
    assert gaps == pytest.approx({"aten::mm": 30e-6, "aten::add": 30e-6})
    assert s["breakdown"]["device_ops"][0][1] == pytest.approx(20e-6)


def test_metric_readers():
    s = trace.reduce_trace(EVENTS)
    s.update(steps=2, shape={"n_drug": 3, "n_et": 2, "n_hid2": 2})
    assert launches_per_step.read(s) == 1.5
    assert device_idle_share.read(s) == pytest.approx(60.0)
    assert gemm_ms.read(s) == pytest.approx(1e-2)
    from tipbench.counts.work import b1_bound_s
    assert b1_roofline.read(s) == pytest.approx(
        100 * 2 * b1_bound_s(s["shape"]) / 20e-6)


def test_a_reader_with_nothing_to_read_returns_nothing():
    s = trace.reduce_trace(EVENTS[:4])
    s.update(steps=2, shape={})
    assert gemm_ms.read(s) is None
    assert b1_roofline.read(s) is None
    assert launches_per_step.read(s) is None
