"""Dense P-P aggregate of the GCN, ``(A+I) @ x`` over the resident int8
(A+I) (kernel B12).

The JAX package contracts (A+I) with ``bf16(dinv * x W)`` as one XLA dot
with bf16 inputs and a float32 result (tip_tpu/nn/gcn.py:70); it replaces no
``pl.pallas_call``.  The CUDA kernel (``csrc/pp_aggregate.cu``, whose header
says how it is laid out and what bounds it) reads the int8 matrix where it
lies and multiplies on the tensor cores, with no float32 copy of it:

  * forward, x bf16: every product a * x is exact and the sums float32, as
    the float32 product of the upcast operands was;
  * backward, the float32 gradient g: (A+I) is symmetric
    (data/packing.py:dense_pp_parts), so (A+I)^T g = (A+I) g, and the kernel
    splits g exactly into three bf16 terms (:func:`split3_plain` is its
    plain version), so the products stay exact and the sums float32.  The
    gradient of x is the bf16 rounding of that float32 sum, as autograd's
    cast gives it.

Three pieces, as for the other kernels: :func:`pp_aggregate_plain`, the
plain PyTorch version (CPU tensors take it, and the card's checks hold the
kernel to it); :func:`pp_aggregate_cuda`, the kernel's wrapper, which
launches it or raises; :func:`pp_aggregate`, the entry point, an
``autograd.Function`` that saves only the resident int8 matrix.
"""

from __future__ import annotations

import functools

import torch

from tip_tpu_torch import kernels, trace
from tip_tpu_torch.ops.matmul import bf16_round

KERNEL = "pp_aggregate"
WIDTHS = (8, 16, 32)  # feature widths the kernel is instantiated for
BM, BK = 256, 128  # rows a block and k a stage (pp_aggregate.cu)
MAX_SPLITS = 32


def split3_plain(x: torch.Tensor):
    """(hi, mid, lo) float32, each a bf16 value, with hi + mid + lo = x
    exactly for |x| >= 2^-110 (and 0): hi is x with its low 16 bits
    cleared, mid the same of x - hi, lo = x - hi - mid (pp_aggregate.cu:
    split3).  Below 2^-110, lo may lose the bits of x under 2^-133, bf16's
    least subnormal."""

    def trunc(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)

    x = x.float()
    hi = trunc(x)
    r = x - hi
    mid = trunc(r)
    return hi, mid, trunc(r - mid)


def pp_aggregate_plain(a1: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(A+I) @ x in float32: a1 upcast exactly, x as it is (a bf16 x is one
    bf16 term; a float32 x is exact, as the kernel's three terms are)."""
    return bf16_round(a1) @ x.float()


def check_args(a1: torch.Tensor, x: torch.Tensor, kernel: bool = False):
    """Raise unless a1 is a square 2-D int8 matrix and x an [N, d] bf16 or
    float32 operand; with ``kernel``, also what the CUDA kernel takes: a
    contiguous, 16-byte aligned a1 and N, d >= 1 (any width:
    :func:`column_blocks`)."""
    if a1.dtype != torch.int8 or a1.dim() != 2:
        raise ValueError(f"a1 must be a 2-D int8 (A+I), got {a1.dim()}-D "
                         f"{a1.dtype}")
    n = a1.shape[0]
    if a1.shape[1] != n:
        raise ValueError(f"a1 must be square, got {tuple(a1.shape)}")
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, d], got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if not kernel:
        return
    if n < 1 or x.shape[1] < 1:
        raise ValueError(f"the kernel takes N, d >= 1, got {tuple(x.shape)}")
    if not a1.is_contiguous() or a1.data_ptr() % 16:
        raise ValueError("a1 must be contiguous and 16-byte aligned")


def column_blocks(d: int, widths=WIDTHS):
    """[(c0, c1, w)]: the column ranges of an [N, d] operand that the kernel
    takes in turn, each zero-padded to the instantiated width w (the least
    in ``widths`` that holds it): one block up to the widest, blocks of the
    widest beyond (B12: 32 columns)."""
    top = widths[-1]
    return [(c0, min(c0 + top, d),
             next(w for w in widths if w >= min(top, d - c0)))
            for c0 in range(0, d, top)]


@functools.lru_cache(maxsize=64)  # called a launch, on the host
def k_splits(n: int, d: int, sms: int) -> int:
    """Contiguous k ranges a row block is cut into: the fewest that keep the
    most loaded SM (one resident block each) near the mean, with the
    partial sums' traffic (8 ks n d bytes) counted against it."""
    rows, tiles = -(-n // BM), -(-n // BK)

    def cost(ks):
        return -(-rows * ks // sms) * BM * n / ks + 8 * ks * n * d / sms

    return min(range(1, min(tiles, MAX_SPLITS) + 1), key=cost)


def pp_aggregate_cuda(a1: torch.Tensor, x: torch.Tensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Launch csrc/pp_aggregate.cu: (A+I) @ x as float32, or its bf16
    rounding (``out_dtype`` bfloat16), at any width d: one launch a
    :func:`column_blocks` block, on x's columns zero-padded to its width
    (exact: an output column reads its own x column alone)."""
    if not (a1.is_cuda and x.is_cuda):
        raise ValueError("pp_aggregate_cuda needs CUDA tensors")
    check_args(a1, x, kernel=True)
    if x.device != a1.device:
        raise ValueError(f"x is on {x.device}, a1 on {a1.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    outs = []
    for c0, c1, w in column_blocks(x.shape[1]):
        xb = x[:, c0:c1]
        if c1 - c0 < w:
            xb = torch.nn.functional.pad(xb, (0, w - (c1 - c0)))
        outs.append(_launch(a1, xb.contiguous(), out_dtype)[:, : c1 - c0])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _launch(a1, x, out_dtype):
    """One launch on a contiguous x of an instantiated width."""
    dev, (n, d) = a1.device, x.shape
    tiles = -(-n // BK)
    ks = k_splits(n, d, kernels.sm_count(dev))
    terms = 3 if x.dtype == torch.float32 else 1
    # scratch freed on return while the kernel may still run (reused only by
    # later work on this stream)
    xt = torch.empty(terms * tiles * d * BK, dtype=torch.int16, device=dev)
    part = torch.empty(ks * n * d, dtype=torch.float32, device=dev)
    out = torch.empty((n, d), dtype=out_dtype, device=dev)
    kernels.launch(KERNEL, "tip_pp_aggregate", "pipiiipppi", a1, n, x, d,
                   int(terms == 3), ks, xt, part, out,
                   int(out_dtype == torch.bfloat16), device=dev)
    return out


class _PPAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a1, x):
        ctx.save_for_backward(a1)
        if a1.is_cuda:
            return pp_aggregate_cuda(a1, x)
        return pp_aggregate_plain(a1, x)

    @staticmethod
    @trace.spanned("pp_aggregate")
    def backward(ctx, g):
        (a1,) = ctx.saved_tensors
        if a1.is_cuda:  # (A+I)^T g = (A+I) g: the matrix is symmetric
            dx = pp_aggregate_cuda(a1, g.float(), out_dtype=torch.bfloat16)
        else:  # the transposed product, as the float32 matmul's backward
            dx = pp_aggregate_plain(a1.t(), g).to(torch.bfloat16)
        return None, dx


def pp_aggregate(a1: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(A+I) @ x, float32 [N, d], for the int8 (A+I) ``a1`` [N, N] and a bf16
    ``x`` [N, d]; differentiable in x.

    REQUIRES a symmetric (A+I): on the card the backward computes
    (A+I)^T g as (A+I) g.  CPU tensors take :func:`pp_aggregate_plain`,
    CUDA tensors the kernel (or raise)."""
    check_args(a1, x)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if x.device != a1.device:
        raise ValueError(f"x is on {x.device}, a1 on {a1.device}")
    if a1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pp_aggregate for device {a1.device}")
    return _PPAggregate.apply(a1, x)
