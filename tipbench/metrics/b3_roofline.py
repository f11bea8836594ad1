"""b3_roofline: kernel B3's least time for a step's work on uint8 pages
(counts/work.py:b3_bound_s) times the traced steps, over the device time of
its launches, in %.  B3 is the NN decoder's page kernel
(csrc/dense_bce_nn.cu, ``page_kernel<P, GRADS>``), its reductions and the
contraction it shares with B9 (csrc/contract.cuh), which the cells that
read this metric do not run.  Layer: the dense loss kernels."""

from tipbench.counts.work import b3_bound_s
from tipbench.lib.trace import op_seconds

TILE = (r"page_kernel<unsigned char, (true|false)>",)
PATTERNS = TILE + (r"namespace\)::reduce_loss\b", r"namespace\)::sum_tiles\b",
                   r"contract::contract_kernel", r"contract::sum_slabs")


def read(summary):
    if not op_seconds(summary, TILE)[1]:
        return None
    sec, _ = op_seconds(summary, PATTERNS)
    return 100.0 * summary["steps"] * b3_bound_s(summary["shape"]) / sec
