"""The program's own spans (tip_tpu_torch/trace.py), which the per-layer
metrics of source ``program_span`` read in the run's process: the span
totals since the process started, and the spans of the last traced session
(the traced steps: torch.profiler turns the recorder's tracing on).  A
program without the recorder gives no report, and its readers nothing."""

from __future__ import annotations


def program_report():
    """{"totals": trace.totals(), "session": trace.session()} of the
    program in this process, or None where it has no recorder."""
    try:
        from tip_tpu_torch import trace
    except ImportError:
        return None
    return {"totals": trace.totals(), "session": trace.session()}


def total_s(report, name: str):
    """Seconds of every span named ``name`` so far, or None."""
    row = (report or {}).get("totals", {}).get(name)
    return None if row is None else row["s"]


def session_mean_ms(report, name: str):
    """Mean milliseconds of the closed spans named ``name`` in the last
    traced session, or None."""
    ns = [s["end_ns"] - s["start_ns"] for s in (report or {}).get(
        "session", []) if s["name"] == name and s["end_ns"] is not None]
    return 1e-6 * sum(ns) / len(ns) if ns else None
