"""graph_gib: GiB of the device graph's tensors, counted from their shapes
and dtypes.  Layer: host packing."""

PATTERNS = ()


def read(summary):
    nbytes = summary.get("graph_bytes")
    return None if not nbytes else nbytes / 2**30
