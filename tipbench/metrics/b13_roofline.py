"""b13_roofline: kernel B13's least time for a step's work
(counts/decagon_kernels.py:b13_bound_s) times the traced steps, over the
device time of its launches, in %.  B13 is the DEDICOM decoder's fused
dense BCE over the uint8 pages (csrc/dense_bce_dedicom.cu: the tile kernel
and its fixed-order sums).  Layer: the dense loss kernels."""

from tipbench.counts.decagon_kernels import b13_bound_s
from tipbench.lib.trace import op_seconds

PATTERNS = (r"dedicom::",)


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 100.0 * summary["steps"] * b13_bound_s(summary["shape"]) / sec
