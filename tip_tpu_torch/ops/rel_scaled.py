"""The relation-scaled aggregation over the int8 strips,
``out = sum_r (A_r bf16(U)) * z_r``, and its gradients (kernel B16).

CompGCN's D-D messages (models/compgcn.py) are a drug's neighbours' rows
scaled by the relation's vector: for relation r with symmetric count
matrix A_r (the strips of data/packing.py:sym_strip_pack, mirror and
diagonal block included), every relation shares the operand U [n, d] and
differs only by a diagonal applied after the product.  The JAX package has
no such model; B16 replaces no ``pl.pallas_call``.  The CUDA kernel
(``csrc/rel_scaled.cu``, whose header says how it is laid out and what
bounds it) reads the int8 strips where they lie and multiplies on the
tensor cores, with no float copy of the strips and no [R, n, d] operand or
product in device memory:

  * forward: U rounded once to bf16; each relation's product A_r bf16(U)
    (exact int8 x bf16 products) over one 128-column block of A_r into a
    fresh float32 accumulator, then scaled by z_r in float32 and added; the
    column blocks' and relation chunks' partial sums are added in a fixed
    order (bit-equal reruns);
  * backward, for out's float32 gradient G: A_r is symmetric, so
    dU = sum_r (A_r G) * z_r and dz_r = sum_rows bf16(U) * (A_r G); G is
    split exactly into three bf16 terms (ops/pp_aggregate.py:split3_plain),
    so every product A_r G is the float32 product's, and dU, dz leave as
    float32 sums in a fixed order.  dU passes to U as it is (the rounding
    of U passes the gradient unrounded).

What bounds it (H100, Decagon shape, R = 1,097, n = 645, d = 200): the
strips are 377 MB, 0.11 ms at 3.35 TB/s each way; the products are 2 R n^2
d = 0.18 TFLOP forward and three times that backward, 0.18 / 0.55 ms at
989 TFLOP/s of bf16, so the tensor cores bound both passes; mma.sync
reaches about half that rate.

Three pieces, as for the other kernels: :func:`rel_scaled_plain` and
:func:`rel_scaled_grad_plain`, the plain PyTorch version (CPU tensors and
``backend="xla"`` take it, and the card's checks hold the kernel to it);
:func:`rel_scaled_cuda` and :func:`rel_scaled_grad_cuda`, the kernel's
wrappers, which launch it or raise; :func:`rel_scaled`, the entry point,
an ``autograd.Function`` that saves the strips, bf16(U) and z.
"""

from __future__ import annotations

import functools

import torch

from tip_tpu_torch import kernels, trace
from tip_tpu_torch.data.packing import SYM_BLOCK as B, nb_from_cols
from tip_tpu_torch.ops.pp_aggregate import split3_plain

KERNEL = "rel_scaled"
DC = 40  # columns a block (rel_scaled.cu: five n8 tiles)
PLAIN_CHUNK = 64  # relations a step of the plain version


def strip_pages(strips: torch.Tensor, n: int) -> torch.Tensor:
    """The full symmetric count pages [R, n, n] float32 of int8 strips
    [R, 128, totcols] (data/packing.py:sym_strip_pack): each strip's
    diagonal block as it is, its tail and the tail's mirror."""
    r, rows, totcols = strips.shape
    nb = nb_from_cols(totcols)
    if rows != B or not (nb - 1) * B < n <= nb * B:
        raise ValueError(f"strips {tuple(strips.shape)} do not hold n = {n}")
    npad = nb * B
    out = torch.zeros((r, npad, npad), dtype=torch.float32,
                      device=strips.device)
    off = 0
    for i in range(nb):
        width = (nb - i) * B
        tail = strips[:, :, off:off + width].float()
        out[:, i * B:(i + 1) * B, i * B:] = tail
        out[:, (i + 1) * B:, i * B:(i + 1) * B] = \
            tail[:, :, B:].transpose(1, 2)
        off += width
    return out[:, :n, :n]


def bf16_value(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def rel_scaled_plain(strips, ub, z, n_chunk: int = PLAIN_CHUNK):
    """sum_r (A_r ub) * z_r, float32 [n, d], for a bf16-valued ub [n, d]
    and z [R, d]: a relation chunk's pages upcast exactly, the float32
    product, then the z scaling and the chunks' sum in relation order."""
    n = ub.shape[0]
    out = torch.zeros(ub.shape, dtype=torch.float32, device=ub.device)
    ub, z = ub.float(), z.float()
    for c0 in range(0, strips.shape[0], n_chunk):
        pages = strip_pages(strips[c0:c0 + n_chunk], n)
        out = out + ((pages @ ub) * z[c0:c0 + n_chunk, None, :]).sum(0)
    return out


def rel_scaled_grad_plain(strips, ub, z, g, n_chunk: int = PLAIN_CHUNK):
    """(dU, dz) float32 for out's gradient g [n, d]: P_r = A_r g (A_r
    symmetric), dU = sum_r P_r * z_r, dz_r = sum_rows ub * P_r."""
    n = ub.shape[0]
    ub, z, g = ub.float(), z.float(), g.float()
    du = torch.zeros(ub.shape, dtype=torch.float32, device=ub.device)
    dz = []
    for c0 in range(0, strips.shape[0], n_chunk):
        p = strip_pages(strips[c0:c0 + n_chunk], n) @ g
        du = du + (p * z[c0:c0 + n_chunk, None, :]).sum(0)
        dz.append((p * ub[None]).sum(1))
    return du, torch.cat(dz)


def check_args(strips, u, z, kernel: bool = False):
    """Raise unless strips is an int8 [R, 128, totcols] strip array, u an
    [n, d] and z an [R, d] float tensor on its device, n inside the strips'
    rows; with ``kernel``, also contiguous, 16-byte aligned strips."""
    if strips.dtype != torch.int8 or strips.dim() != 3:
        raise ValueError(f"strips must be 3-D int8, got {strips.dim()}-D "
                         f"{strips.dtype}")
    r, rows, totcols = strips.shape
    nb = nb_from_cols(totcols)
    if u.dim() != 2 or z.dim() != 2 or z.shape != (r, u.shape[1]):
        raise ValueError(f"u must be [n, d] and z [{r}, d], got "
                         f"{tuple(u.shape)}, {tuple(z.shape)}")
    if rows != B or not (nb - 1) * B < u.shape[0] <= nb * B:
        raise ValueError(f"n = {u.shape[0]} does not fit {nb} strip rows")
    for name, x in (("u", u), ("z", z)):
        if not x.is_floating_point():
            raise ValueError(f"{name} must be a float tensor, got {x.dtype}")
        if x.device != strips.device:
            raise ValueError(f"{name} is on {x.device}, strips on "
                             f"{strips.device}")
    if kernel and (not strips.is_contiguous() or strips.data_ptr() % 16):
        raise ValueError("strips must be contiguous and 16-byte aligned")


def padded_width(d: int) -> int:
    return -(-d // DC) * DC


@functools.lru_cache(maxsize=64)  # called a launch, on the host
def relation_chunks(r: int, nb: int, sms: int) -> int:
    """Relation chunks of a launch: about four blocks an SM over the
    (column chunk, row block, column block) grid of a 200-wide operand."""
    per = 5 * nb * nb
    return max(1, min(r, -(-4 * sms // per)))


def _pad(x: torch.Tensor, rows: int, cols: int, dtype) -> torch.Tensor:
    out = torch.zeros((rows, cols), dtype=dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _launch(strips, xt, terms, zz, ubp, n, d, want_dz):
    """One pass; xt [terms, npad, dw] bf16 (the operand's exact terms),
    zz [R, dw] float32, ubp [npad, dw] bf16 (backward: bf16(U) for dz).
    Returns (out [n, d], dz [R, d] or None)."""
    dev = strips.device
    r, _, totcols = strips.shape
    nb = nb_from_cols(totcols)
    dw = zz.shape[1]
    rch = relation_chunks(r, nb, kernels.sm_count(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    # scratch freed on return while the kernel may still run (reused only by
    # later work on this stream)
    part = torch.empty(rch * nb * nb * B * dw, **f32)
    out = torch.empty((n, d), **f32)
    if want_dz:
        dz_part = torch.empty(nb * nb * r * dw, **f32)
        dz = torch.empty((r, d), **f32)
    else:
        dz_part = dz = None
    kernels.launch(KERNEL, "tip_rel_scaled", "piiiiiippppiippp", strips, r,
                   n, nb, totcols, d, dw, xt, zz, ubp, part, terms, rch, out,
                   dz_part, dz, device=dev)
    return out, dz


def rel_scaled_cuda(strips, ub, z):
    """Launch csrc/rel_scaled.cu's forward: sum_r (A_r ub) * z_r, float32
    [n, d], for a bf16-valued ub."""
    if not strips.is_cuda:
        raise ValueError("rel_scaled_cuda needs CUDA tensors")
    check_args(strips, ub, z, kernel=True)
    (n, d), nb = ub.shape, nb_from_cols(strips.shape[2])
    dw = padded_width(d)
    xt = _pad(ub, nb * B, dw, torch.bfloat16)[None]
    zz = _pad(z.float(), z.shape[0], dw, torch.float32)
    return _launch(strips, xt, 1, zz, xt[0], n, d, False)[0]


def rel_scaled_grad_cuda(strips, ub, z, g):
    """Launch csrc/rel_scaled.cu's backward: (dU, dz) float32 for out's
    float32 gradient g, its three exact bf16 terms in one pass."""
    if not strips.is_cuda:
        raise ValueError("rel_scaled_grad_cuda needs CUDA tensors")
    check_args(strips, ub, z, kernel=True)
    (n, d), nb = ub.shape, nb_from_cols(strips.shape[2])
    dw = padded_width(d)
    xt = torch.stack([_pad(t, nb * B, dw, torch.bfloat16)
                      for t in split3_plain(g)])
    zz = _pad(z.float(), z.shape[0], dw, torch.float32)
    ubp = _pad(ub, nb * B, dw, torch.bfloat16)
    return _launch(strips, xt, 3, zz, ubp, n, d, True)


class _RelScaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, z, strips, plain):
        ub = bf16_value(u)
        ctx.save_for_backward(strips, ub, z)
        ctx.plain = plain
        if strips.is_cuda and not plain:
            return rel_scaled_cuda(strips, ub, z)
        return rel_scaled_plain(strips, ub, z)

    @staticmethod
    @trace.spanned("rel_scaled")
    def backward(ctx, g):
        strips, ub, z = ctx.saved_tensors
        if strips.is_cuda and not ctx.plain:
            du, dz = rel_scaled_grad_cuda(strips, ub, z, g.float())
        else:
            du, dz = rel_scaled_grad_plain(strips, ub, z, g)
        return du, dz, None, None


def rel_scaled(strips: torch.Tensor, u: torch.Tensor, z: torch.Tensor,
               plain: bool = False) -> torch.Tensor:
    """sum_r (A_r bf16(u)) * z_r, float32 [n, d], for the int8 strips
    [R, 128, totcols], u [n, d] and z [R, d] float32; differentiable in u
    (straight through the rounding) and z.  CPU tensors and ``plain``
    (``backend="xla"``) take :func:`rel_scaled_plain`, CUDA tensors the
    kernel (or raise)."""
    check_args(strips, u, z)
    if strips.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rel_scaled for device {strips.device}")
    with trace.span("rel_scaled"):
        return _RelScaled.apply(u.float(), z.float(), strips, plain)
