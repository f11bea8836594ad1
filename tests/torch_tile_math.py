"""Numpy emulation of the arithmetic of the port's dense loss kernels
(tip_tpu_torch/csrc/tile_math.cuh), and the float32 error bound of a sum,
shared by the tests of kernels B1, B2 and B3.

* ``tf32``, ``split``, ``mma``: the 3xTF32 tensor-core products of B1 and
  B2 (mma.sync m16n8k8 TF32 with a float32 accumulator).
* ``softplus_sigmoid``: the cell's softplus(-x) and sigmoid(-x) from one
  exponential, in float32, with the approximate ex2 and lg2 of the card
  perturbed by their documented worst-case errors.
* ``assert_within_sum_bound``: a float32 result against a float64 one,
  within a multiple of the unit roundoff times the sum of the absolute
  values of the terms that make it up.  The error of a float32 sum is
  bounded relative to that sum, not to the result, which may cancel.
  ``PLAIN_ULPS``, ``PLAIN_ULPS_NN`` and ``JAX_ULPS`` are the multiples.
"""

import numpy as np

U32 = 2.0 ** -24  # unit roundoff of float32
# Error bounds of the parity tests under u24 = 0, in units of U32 * sum
# |terms| of each result.  The port's plain versions against the float64
# oracles, bit-stable over thread counts and MKL's and ATen's CPU kernels:
# they read <= 1.1 on B1's and B2's inputs (PLAIN_ULPS) and <= 6.9 on B3's
# (<= 8.5 under MKL_CBWR=COMPATIBLE; PLAIN_ULPS_NN), so a drift like the
# one B1's dw showed once under pytest-xdist (18.8, cause not found) fails
# and prints its reading.  The JAX interpret kernels against the oracles
# read <= 7.9, and the port against them <= 10.6 (JAX_ULPS).
PLAIN_ULPS = 8
PLAIN_ULPS_NN = 16
JAX_ULPS = 64


def tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away
    from zero (the low 13 bits cleared); a NaN stays a NaN."""
    x = np.asarray(x, np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    r = ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, r)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi)


def mma(a, b, passes: int):
    """a @ b as the kernels' mma.sync m16n8k8 chain computes it: k-steps of
    8, each adding its TF32 products (exact in float32) to a float32
    accumulator; 3 passes (lo*hi, hi*lo, hi*hi: 3xTF32) or 1 (hi*hi)."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in terms:
            acc = (acc + x[:, k:k + 8].astype(np.float64)
                   @ y[k:k + 8].astype(np.float64)).astype(np.float32)
    return acc


# PTX ISA: ex2.approx.ftz.f32 has a maximum relative error of 2^-22 (over
# the whole range), lg2.approx.ftz.f32 a maximum absolute error of 2^-22
# for arguments in [0.5, 2] (1 + e lies in [1, 2]); __fdividef is within
# 2 ulp for a divisor in [1, 2].
EX2_REL = 2.0 ** -22
LG2_ABS = 2.0 ** -22
DIV_REL = 2.0 * 2.0 ** -23


def softplus_sigmoid(x, ex2_sign: int = 0, lg2_sign: int = 0,
                     div_sign: int = 0):
    """(softplus(-x), sigmoid(-x)) in float32 as tile_math.cuh computes them
    from e = exp(-|x|), each approximate instruction moved by ``sign`` times
    its worst-case error (0: the correctly rounded value)."""
    f = np.float32
    x = np.asarray(x, f)
    log2e, ln2 = f(1.4426950408889634), f(0.6931471805599453)
    e = np.exp2(f(-1) * np.abs(x) * log2e).astype(f)
    e = (e * (1.0 + ex2_sign * EX2_REL)).astype(f)
    one_e = (f(1) + e).astype(f)
    lg = (np.log2(one_e.astype(np.float64)) + lg2_sign * LG2_ABS).astype(f)
    sp = (np.maximum(-x, f(0)) + (lg * ln2).astype(f)).astype(f)
    num = np.where(x >= 0, e, f(1)).astype(f)
    sg = (num.astype(np.float64) / one_e * (1.0 + div_sign * DIV_REL)).astype(f)
    return sp, sg


def assert_within_sum_bound(got, want, sabs, what: str, ulps: float) -> None:
    """Assert |got - want| <= ulps * U32 * sabs elementwise; the message
    gives the largest error in units of U32 * sabs, and the process's
    torch settings that could change a CPU result."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    scale = U32 * np.asarray(sabs, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = float(np.max(np.where(err == 0, 0.0, err / scale)))
    if ratio <= ulps:
        return
    import torch

    raise AssertionError(
        f"{what}: error {ratio:.2f} x U32 x sum|terms|, bound {ulps} (torch "
        f"{torch.__version__}, {torch.get_num_threads()} threads, CPU "
        f"capability {torch.backends.cpu.get_cpu_capability()}, float32 "
        f"matmul precision {torch.get_float32_matmul_precision()})")
