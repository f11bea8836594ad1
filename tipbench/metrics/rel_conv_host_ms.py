"""rel_conv_host_ms: host milliseconds a step inside the program's span
``rel_conv`` (tip_tpu_torch/models/decagon.py: the D-D relation
convolution's forward, once a layer), summed over the traced session and
divided by its steps; nothing where the program has no such span.  Layer:
the train loop on the host."""

from tipbench.lib import spans

PATTERNS = ()


def read(summary):
    report = spans.program_report()
    ns = [s["end_ns"] - s["start_ns"] for s in (report or {}).get(
        "session", []) if s["name"] == "rel_conv" and s["end_ns"] is not None]
    if not ns or not summary.get("steps"):
        return None
    return 1e-6 * sum(ns) / summary["steps"]
