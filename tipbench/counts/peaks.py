"""H100 peaks and the least time of a piece of work.

Frozen copy of ``PEAK_*``, ``bound`` and ``tensor_core_bound`` of
chip_smoke.py:117-119, 257-278 and 546-552 at the commit that added this
benchmark.  Published peaks of one NVIDIA H100 SXM at its full 700 W
(NVIDIA's data sheet, dense rates): 3.35 TB/s of HBM, 67 TFLOP/s in
float32 outside the tensor cores, 495 TFLOP/s in TF32 on them.  A card set
below 700 W runs slower than these, so a share of them is stated with the
card's power limit beside it.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12


def bound_s(nbytes: float, f32_flops: float) -> float:
    """The least time of work that reads and writes ``nbytes`` once and
    runs ``f32_flops`` float32 operations on the SIMT units."""
    return max(nbytes / PEAK_BYTES_PER_S, f32_flops / PEAK_F32_FLOP_PER_S)


def tensor_core_bound_s(nbytes: float, cells: int, d: int) -> float:
    """The least time of a DistMult dense loss pass (B1, B2) over ``cells``
    cells of width ``d``: the three d-long dots of a cell (6 d flops) at
    float32 accuracy take three TF32 products each on the tensor cores,
    about 20 elementwise float operations a cell run on the SIMT units
    alongside, and the bytes stream once; the largest of the three."""
    t_tensor = 3 * cells * 6 * d / PEAK_TF32_FLOP_PER_S
    t_simt = cells * 20 / PEAK_F32_FLOP_PER_S
    return max(nbytes / PEAK_BYTES_PER_S, t_tensor, t_simt)
