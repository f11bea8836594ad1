"""chunked_kernels_ms: device ms a step in the chunked layout's kernels:
B4 (csrc/typed_neighbor_sum.cu), B5 (csrc/gcn_spmm.cu), B8
(csrc/distmult_sddmm.cu with distmult_fwd.cuh, distmult_bwd.cuh and
chunk_sums.cuh) and B10 (csrc/typed_neg_sampler.cu).  Layer: the chunked
kernels."""

from tipbench.lib.trace import op_seconds

PATTERNS = (r"tns_fwd<", r"tns_bwd<",
            r"\(anonymous namespace\)::spmm(_runs)?\(",
            r"distmult_fwd::", r"distmult_bwd::", r"chunk_sums::",
            r"\(anonymous namespace\)::sample\(")


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 1e3 * sec / summary["steps"]
