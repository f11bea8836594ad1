"""b2_roofline: kernel B2's least time for a step's work on float32 pages
(counts/work.py:b2_bound_s) times the traced steps, over the device time of
its launches, in %.  B2 is the full-page tile kernel (csrc/dense_bce.cu,
``tile_kernel<P, D, GRADS>``) and its reductions.  Layer: the dense loss
kernels."""

from tipbench.counts.work import b2_bound_s
from tipbench.lib.trace import op_seconds

TILE = (r"tile_kernel<float, \d+, (true|false)>",)
PATTERNS = TILE + (r"namespace\)::reduce_(loss|dw|dz)\b",)


def read(summary):
    if not op_seconds(summary, TILE)[1]:
        return None
    sec, _ = op_seconds(summary, PATTERNS)
    return 100.0 * summary["steps"] * b2_bound_s(summary["shape"]) / sec
