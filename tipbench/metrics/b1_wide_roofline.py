"""b1_wide_roofline: the wide instance of kernel B1 (d > 32), its least
time for a step's work (counts/compgcn_kernels.py:b1_wide_bound_s) times
the traced steps, over the device time of its launches, in %.  The wide
instance is csrc/dense_bce_sym.cu's ``b1w::`` kernels with the loss and dw
reductions it shares with the tile kernel (and B2), so the metric is read
only where the wide kernel runs, and B2 does not.  Layer: the dense loss
kernels."""

from tipbench.counts.compgcn_kernels import b1_wide_bound_s
from tipbench.lib.trace import op_seconds

WIDE = (r"b1w::",)
PATTERNS = WIDE + (r"namespace\)::reduce_(loss|dw)\b",)


def read(summary):
    if not op_seconds(summary, WIDE)[1]:
        return None
    sec, _ = op_seconds(summary, PATTERNS)
    return 100.0 * summary["steps"] * b1_wide_bound_s(summary["shape"]) / sec
