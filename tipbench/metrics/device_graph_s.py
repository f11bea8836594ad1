"""device_graph_s: host seconds of set-up's device graph (the
``device_graph`` span: ``make_graph_arrays`` or ``make_dd_graph_arrays``,
their tensors copied to the card).  Layer: host packing."""

from tipbench.lib import spans

PATTERNS = ()


def read(summary):
    return spans.total_s(spans.program_report(), "device_graph")
