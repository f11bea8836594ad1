"""The least time of a CompGCN step's work in kernel B16 and in B1's wide
instance (the rooflines ``b16_roofline`` and ``b1_wide_roofline``), from
the cell's shapes (run.py:shape_of): each input byte read once and each
output byte written once at 3.35 TB/s, operations at the fastest rate that
keeps the kernel's stated precision (counts/peaks.py; bf16 at 989 TFLOP/s,
counts/decagon_kernels.py)."""

from __future__ import annotations

from tipbench.counts.decagon_kernels import PEAK_BF16_FLOP_PER_S
from tipbench.counts.peaks import PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S
from tipbench.counts.work import SYM_BLOCK


def strip_bytes(s: dict) -> int:
    """The int8 strips [R, 128, NB * 128]."""
    nb = -(-s["n_drug"] // SYM_BLOCK)
    return s["n_et"] * SYM_BLOCK * SYM_BLOCK * nb * (nb + 1) // 2


def b16_bound_s(s: dict) -> float:
    """Kernel B16's two passes a step at width w = 2 init_dim (the in and
    out directions in one pass).  Forward: reads the strips, U [n, w] bf16
    and z [R, w] float32, writes out [n, w]; 2 R n^2 w bf16 operations.
    Backward: reads the strips, G [n, w] float32, z and U, writes dU [n, w]
    and dz [R, w]; three bf16 terms, 6 R n^2 w.  Each pass the larger of
    its byte and operation times."""
    n, r, w = s["n_drug"], s["n_et"], 2 * s["init_dim"]
    strips = strip_bytes(s)
    fwd = max((strips + 2 * n * w + 4 * r * w + 4 * n * w) / PEAK_BYTES_PER_S,
              2.0 * r * n * n * w / PEAK_BF16_FLOP_PER_S)
    bwd = max((strips + 4 * n * w + 4 * r * w + 2 * n * w + 4 * n * w
               + 4 * r * w) / PEAK_BYTES_PER_S,
              6.0 * r * n * n * w / PEAK_BF16_FLOP_PER_S)
    return fwd + bwd


def b1_wide_bound_s(s: dict) -> float:
    """Kernel B1's wide instance, one fused pass a step at d = gcn_dim:
    reads the strips, w [R, d], z [n, d] and the thresholds [R, 8] int32,
    writes the loss, dw, dz.  Its work is what the estimator's cells need:
    about 20 float operations a cell of the upper block triangle inside
    n x n (the count and its test, as counts/peaks.py:tensor_core_bound_s
    counts them), and for each active cell, a cell with a positive or a
    negative drawn (expected: n_train / 2 positive cells of the triangle
    and n_train cells that draw, each relation's expected draws being its
    train edges), the float32 logit (3 d), its two gradient rows (4 d) and
    G's scaling (d); for each (row, relation) the dz and dw adds, 4 d.
    Every operation float32 at 67 TFLOP/s: cells whose G is zero add
    nothing, so no dense product is counted."""
    n, r, d = s["n_drug"], s["n_et"], s["gcn_dim"]
    nb = -(-n // SYM_BLOCK)
    cells = r * sum(min(SYM_BLOCK, n - i * SYM_BLOCK) * (n - i * SYM_BLOCK)
                    for i in range(nb))
    active = 1.5 * s["n_train"]
    nbytes = (strip_bytes(s) + 4 * (r * d + n * d + r * 8)
              + 4 * (1 + r * d + n * d))
    flops = 20.0 * cells + 8.0 * d * active + 4.0 * d * r * n
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)
