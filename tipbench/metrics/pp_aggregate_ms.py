"""pp_aggregate_ms: device ms a step in kernel B12 (csrc/pp_aggregate.cu:
its x staging, the tensor-core aggregate and the fixed-order sum of its k
ranges), the dense P-P GCN's (A+I) @ x.  Layer: the encoder."""

from tipbench.lib.trace import op_seconds

PATTERNS = (r"pp_aggregate::",)


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 1e3 * sec / summary["steps"]
