"""copy_ms: device ms a step in elementwise copy kernels: the materialised
upcasts and bf16 roundings of the dense products' operands.  Layer: the
encoder."""

from tipbench.lib.trace import op_seconds

PATTERNS = (r"copy_kernel",)


def read(summary):
    sec, count = op_seconds(summary, PATTERNS)
    if not count:
        return None
    return 1e3 * sec / summary["steps"]
