"""b14_roofline: kernel B14's least time for a step's work
(counts/decagon_kernels.py:b14_bound_s) times the traced steps, over the
device time of its launches, in %.  B14 is Decagon's D-D relation
convolution (csrc/rel_aggregate.cu: its operand staging, the tensor-core
aggregate over the uint8 pages and the fixed-order sum of its relation
chunks).  Layer: the encoder."""

from tipbench.counts.decagon_kernels import b14_bound_s
from tipbench.lib.trace import op_seconds

PATTERNS = (r"rel_aggregate::",)


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 100.0 * summary["steps"] * b14_bound_s(summary["shape"]) / sec
