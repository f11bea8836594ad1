"""rgcn_contract_ms: device ms a step in kernel B15 (csrc/rgcn_contract.cu:
the forward's att staging and contraction, the backward's slab products
and their fixed-order sum), the R-GCN's M-first contraction over the int8
strips.  Layer: the encoder."""

from tipbench.lib.trace import op_seconds

PATTERNS = (r"rgcn_contract::",)


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 1e3 * sec / summary["steps"]
