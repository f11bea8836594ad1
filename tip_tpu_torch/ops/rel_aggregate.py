"""Decagon's multi-relation graph convolution over the D-D pages (kernel
B14):

    out[i] = sum_t s_t[i] ((A_t + I) u_t)[i],   u_t = bf16(s_t * Y_t)

with A_t relation t's count page [n, n], s_t = (deg_t + 1)^-1/2 and Y_t
[n, d] the relation's operand (layer 1: its one-hot weight table, layer 2:
H W_t), so that each relation's message is D_t^-1/2 (A_t + I) D_t^-1/2 Y_t
and the relations are summed (Zitnik et al. 2018, ``GraphConvolutionMulti``
before its row normalisation).  The JAX package has no Decagon model, so
B14 replaces no ``pl.pallas_call``.  The CUDA kernel
(``csrc/rel_aggregate.cu``, whose header says how it is laid out) reads the
resident uint8 pages where they lie and multiplies on the tensor cores,
with no float copy of them:

  * forward: the operand rounded to bf16 (the stated precision: bf16
    operands, float32 sums), every product exact, the sums float32 in a
    fixed order; with ``exact`` (float32 matmuls pinned) the operand stays
    float32, split exactly into three bf16 terms as the backward's, so the
    forward is the float32 product's, from the same uint8 pages;
  * backward: dY_t = s_t * ((A_t + I)^T (s_t * g)); the D-D pages are
    symmetric (both directions of every train pair), so the kernel reads
    A_t's rows, and splits s_t * g exactly into three bf16 terms
    (ops/pp_aggregate.py:split3_plain), so the gradient is the float32
    product's.  The forward's rounding passes the gradient through
    unchanged (a straight-through rounding), as the plain version's does.

:func:`rel_aggregate_plain` is the plain PyTorch version (CPU tensors take
it; ``backend="xla"`` takes it on any device); :func:`rel_aggregate_cuda`
launches the kernel or raises; :func:`rel_aggregate` is the entry point, an
``autograd.Function``.
"""

from __future__ import annotations

import functools

import torch

from tip_tpu_torch import kernels, trace

KERNEL = "rel_aggregate"
WIDTHS = (8, 16, 32, 64)  # feature widths the kernel is instantiated for
BM, BK = 256, 128  # rows a block and k a stage (rel_aggregate.cu)
PLAIN_CHUNK = 64  # relations a step of the plain version


def check_args(pages, s, y, kernel: bool = False):
    """Raise unless pages [R, n, n] uint8, s [R, n] float32 and y [R, n,
    d] float32 agree."""
    if pages.dim() != 3 or pages.shape[1] != pages.shape[2]:
        raise ValueError(f"pages must be [R, n, n], got {tuple(pages.shape)}")
    r, n, _ = pages.shape
    if pages.dtype != torch.uint8:
        raise ValueError(f"pages must be uint8, got {pages.dtype}")
    if s.shape != (r, n) or s.dtype != torch.float32:
        raise ValueError(f"s must be float32 [{r}, {n}], got {s.dtype} "
                         f"{tuple(s.shape)}")
    if y.dim() != 3 or y.shape[:2] != (r, n) or y.dtype != torch.float32:
        raise ValueError(f"y must be float32 [{r}, {n}, d], got {y.dtype} "
                         f"{tuple(y.shape)}")
    if kernel:
        if n < 1 or y.shape[2] < 1:
            raise ValueError(f"the kernel takes n, d >= 1, got {tuple(y.shape)}")
        if not pages.is_contiguous() or pages.data_ptr() % 16:
            raise ValueError("pages must be contiguous and 16-byte aligned")


def bf16_st(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, as float32; the gradient passes unrounded."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def rel_aggregate_plain(pages, s, y, rounded: bool = True):
    """sum_t s_t (A_t + I) (s_t y_t) in float32, relations PLAIN_CHUNK at a
    time; ``rounded``: the operand s_t y_t rounded to bf16 (straight
    through).  Differentiable in y by autograd."""
    r = pages.shape[0]
    out = None
    for c0 in range(0, r, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, r)
        sc = s[c0:c1, :, None]
        u = sc * y[c0:c1]
        if rounded:
            u = bf16_st(u)
        part = (sc * (pages[c0:c1].float() @ u + u)).sum(0)
        out = part if out is None else out + part
    return out


def rel_aggregate_t_plain(pages, s, g):
    """dY [R, n, d] = s_t * ((A_t + I)^T (s_t * g)) in float32: the
    backward of :func:`rel_aggregate_plain`, transposed pages (no symmetry
    assumed)."""
    r = pages.shape[0]
    parts = []
    for c0 in range(0, r, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, r)
        sc = s[c0:c1, :, None]
        v = sc * g[None]
        parts.append(sc * (pages[c0:c1].float().transpose(1, 2) @ v + v))
    return torch.cat(parts)


def column_blocks(d: int):
    """[(c0, c1, w)]: the column ranges the kernel takes in turn, each
    zero-padded to the instantiated width w: one block up to 64 columns,
    blocks of 64 beyond (an output column reads its own operand column
    alone)."""
    top = WIDTHS[-1]
    return [(c0, min(c0 + top, d),
             next(w for w in WIDTHS if w >= min(top, d - c0)))
            for c0 in range(0, d, top)]


@functools.lru_cache(maxsize=64)  # called a launch, on the host
def relation_chunk(n: int, n_et: int, sms: int) -> int:
    """Relations a block: as few blocks as keep every SM busy (one
    resident each), the row blocks times the chunks about a whole wave."""
    rows = -(-n // BM)
    return -(-n_et // max(1, sms // rows))


def _launch(pages, s, y, backward: bool, exact: bool):
    """One launch at an instantiated width: forward y [R, n, w] -> [n, w]
    (``exact``: the operand in three bf16 terms); backward y = g [n, w] ->
    [R, n, w]."""
    dev = pages.device
    r, n, _ = pages.shape
    w = y.shape[-1]
    ktiles = -(-n // BK)
    rc = relation_chunk(n, r, kernels.sm_count(dev))
    terms = 3 if backward or exact else 1
    # scratch freed on return while the kernel may still run (reused only
    # by later work on this stream)
    u = torch.empty(r * terms * ktiles * w * BK, dtype=torch.int16,
                    device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if backward:
        part = u[:0]
        out = torch.empty((r, n, w), **f32)
    else:
        part = torch.empty(-(-r // rc) * n * w, **f32)
        out = torch.empty((n, w), **f32)
    kernels.launch(KERNEL, "tip_rel_aggregate", "piippiiiippp", pages, n, r,
                   y, s, w, int(backward), int(exact), rc, u, part, out,
                   device=dev)
    return out


def rel_aggregate_cuda(pages, s, y=None, g=None, exact: bool = False):
    """Launch csrc/rel_aggregate.cu: the forward sum [n, d] of y [R, n, d]
    (``exact``: y unrounded, the float32 product), or with ``g`` [n, d]
    (and no y) the backward dY [R, n, d], at any width
    (:func:`column_blocks`)."""
    if not pages.is_cuda:
        raise ValueError("rel_aggregate_cuda needs CUDA tensors")
    backward = g is not None
    x = g if backward else y
    r, n, _ = pages.shape
    check_args(pages, s, x.expand(r, n, -1) if backward else x, kernel=True)
    outs = []
    for c0, c1, w in column_blocks(x.shape[-1]):
        xb = x[..., c0:c1]
        if c1 - c0 < w:
            xb = torch.nn.functional.pad(xb, (0, w - (c1 - c0)))
        outs.append(_launch(pages, s.contiguous(), xb.contiguous(),
                            backward, exact)[..., : c1 - c0])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


class _RelAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pages, s, y, plain, exact):
        ctx.save_for_backward(pages, s)
        ctx.plain = plain
        if plain:
            return rel_aggregate_plain(pages, s, y, rounded=not exact)
        return rel_aggregate_cuda(pages, s, y=y, exact=exact)

    @staticmethod
    @trace.spanned("rel_aggregate")
    def backward(ctx, g):
        pages, s = ctx.saved_tensors
        g = g.float()
        dy = (rel_aggregate_t_plain(pages, s, g) if ctx.plain
              else rel_aggregate_cuda(pages, s, g=g))
        return None, None, dy, None, None


def rel_aggregate(pages, s, y, plain: bool = False, exact: bool = False):
    """sum_t s_t (A_t + I) bf16(s_t y_t), float32 [n, d], for the uint8
    count pages ``pages`` [R, n, n] (symmetric: the kernel's backward reads
    rows for columns), ``s`` [R, n] and ``y`` [R, n, d] float32; ``exact``
    (float32 matmuls pinned): s_t y_t unrounded, the float32 product.
    Differentiable in y, its gradient the float32 product's.  CUDA tensors
    launch kernel B14 (or raise), CPU tensors and ``plain`` take the plain
    version."""
    check_args(pages, s, y)
    if pages.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rel_aggregate for device {pages.device}")
    return _RelAggregate.apply(pages, s, y, plain or not pages.is_cuda,
                               exact)
