"""pack_s: host seconds of set-up's packing (the cached packing through
data/cache.py, its build on a miss) and device-graph build
(make_graph_arrays or make_dd_graph_arrays, tensors on the card).  Layer:
host packing."""

PATTERNS = ()


def read(summary):
    return summary.get("pack_s")
