"""b16_roofline: kernel B16's least time for a step's work
(counts/compgcn_kernels.py:b16_bound_s) times the traced steps, over the
device time of its launches, in %.  B16 is CompGCN's relation-scaled
aggregation over the int8 strips (csrc/rel_scaled.cu: the tensor-core
pass and the fixed-order sums of its partials), forward and backward.
Layer: the encoder."""

from tipbench.counts.compgcn_kernels import b16_bound_s
from tipbench.lib.trace import op_seconds

PATTERNS = (r"rel_scaled::",)


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 100.0 * summary["steps"] * b16_bound_s(summary["shape"]) / sec
