"""b4_roofline: kernel B4's least time for a step's work, both R-GCN
layers forward and backward (counts/work.py:b4_bound_s), times the traced
steps, over the device time of its launches (csrc/typed_neighbor_sum.cu,
``tns_fwd`` and ``tns_bwd``), in %.  Layer: the chunked kernels."""

from tipbench.counts.work import b4_bound_s
from tipbench.lib.trace import op_seconds

PATTERNS = (r"tns_fwd<", r"tns_bwd<")


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 100.0 * summary["steps"] * b4_bound_s(summary["shape"]) / sec
