"""gemm_ms: device ms a step in cuBLAS GEMM and GEMV kernels (the
encoder's dense products).  Layer: the encoder."""

from tipbench.lib.trace import op_seconds

PATTERNS = (r"(?i)gemm", r"(?i)gemv", r"(?i)splitkreduce")


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 1e3 * sec / summary["steps"]
