"""b1_roofline: kernel B1's least time for a step's work
(counts/work.py:b1_bound_s) times the traced steps, over the device time of
its launches, in %.  B1 is the symmetric-strip tile kernel
(csrc/dense_bce_sym.cu, ``tile_kernel<D, GRADS>``) and its reductions;
B2's reductions share those names, so the metric is read only where B2
does not run.  Layer: the dense loss kernels."""

from tipbench.counts.work import b1_bound_s
from tipbench.lib.trace import op_seconds

TILE = (r"tile_kernel<\d+, (true|false)>",)
PATTERNS = TILE + (r"namespace\)::reduce_(loss|dw|dz)\b",)


def read(summary):
    if not op_seconds(summary, TILE)[1]:
        return None
    sec, _ = op_seconds(summary, PATTERNS)
    return 100.0 * summary["steps"] * b1_bound_s(summary["shape"]) / sec
