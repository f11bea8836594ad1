"""The least time of a Decagon step's work in kernels B14 and B13 (the
rooflines ``b14_roofline`` and ``b13_roofline``), from the cell's shapes
(run.py:shape_of): each input byte read once and each output byte written
once at 3.35 TB/s, operations at the fastest rate that keeps the kernel's
stated precision (counts/peaks.py; bf16 below).

PEAK_BF16_FLOP_PER_S: 989 TFLOP/s, an H100 SXM's dense bf16 tensor-core
rate at its full 700 W (NVIDIA's data sheet)."""

from __future__ import annotations

from tipbench.counts.peaks import (
    PEAK_BYTES_PER_S,
    PEAK_F32_FLOP_PER_S,
    PEAK_TF32_FLOP_PER_S,
)

PEAK_BF16_FLOP_PER_S = 989e12


def b14_bound_s(s: dict) -> float:
    """Kernel B14's four passes a step: each layer's forward (reads the
    uint8 pages [R, n, n], Y [R, n, d] and the scales [R, n] float32,
    writes out [n, d]; 2 R n^2 d bf16 operations) and backward (reads the
    pages, g [n, d] and the scales, writes dY [R, n, d]; three bf16 terms,
    6 R n^2 d), d = h1 and h2."""
    n, r = s["n_drug"], s["n_et"]
    total = 0.0
    for d in (s["n_hid1"], s["n_hid2"]):
        pages, scales, big, small = r * n * n, 4 * r * n, 4 * r * n * d, \
            4 * n * d
        for nbytes, flops in ((pages + scales + big + small, 2.0 * r * n * n * d),
                              (pages + scales + small + big,
                               6.0 * r * n * n * d)):
            total += max(nbytes / PEAK_BYTES_PER_S,
                         flops / PEAK_BF16_FLOP_PER_S)
    return total


def b13_bound_s(s: dict) -> float:
    """Kernel B13's fused pass a step on uint8 pages: reads the pages, z
    [n, d], d_t [R, d], R [d, d], the thresholds [R, 3] int32, writes the
    loss, dz, dd, dR; the three d-long dots of every cell (6 d) and each
    relation's four [n, d] x [d, d] products (8 n d^2) as 3xTF32 on the
    tensor cores, about 20 elementwise operations a cell beside them."""
    n, r, d = s["n_drug"], s["n_et"], s["n_hid2"]
    cells = r * n * n
    args = n * d + r * d + d * d
    nbytes = cells + 4 * r * 3 + 4 * args + 4 * (1 + args)
    t_tensor = 3 * (6.0 * d * cells + 8.0 * r * n * d * d) / PEAK_TF32_FLOP_PER_S
    return max(nbytes / PEAK_BYTES_PER_S, t_tensor,
               20.0 * cells / PEAK_F32_FLOP_PER_S)
