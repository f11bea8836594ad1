"""Symmetric-strip fused dense BCE: positives + Poissonized negatives over
the upper-triangle strip-packed adjacency, with (dw, dz) from the same pass.

Port of tip_tpu/ops/pallas_dense_bce_sym.py (``dense_bce_sym_sum``).  The
DistMult logit tile of a relation, ``L = (z * w_t) z^T``, and its count page
are symmetric, so the loss reads only the strip layout of
data/packing.py:sym_strip_pack (``[R, 128, NB*128]`` int8).  Within strip I
the first 128 columns are the diagonal block (cells stand for themselves,
single-rate thresholds ``q8[:, :4]``, positive weight 1); the tail stands
for each cell and its mirror (doubled-rate thresholds ``q8[:, 4:]``,
positive weight 2).

Three pieces:

  * :func:`dense_bce_sym_plain` — the plain PyTorch version, strip by
    strip and in relation chunks.  The CPU path and the reference the CUDA
    kernel is held against on the card.
  * :func:`dense_bce_sym_cuda` — the wrapper of the hand-written kernel
    ``csrc/dense_bce_sym.cu`` (whose header says what it replaces, what
    bounds it and how it is laid out); it launches the kernel or raises.
  * :func:`dense_bce_sym_sum` — the entry point: an ``autograd.Function``
    whose forward runs the fused (loss, dw, dz) pass when a gradient is
    needed and saves (dw, dz); its backward scales them by the incoming
    gradient (the JAX package's custom_vjp).  CPU tensors take the plain
    version, CUDA tensors the kernel.

Random bits.  The TPU kernel draws from its on-chip PRNG, which no other
machine reproduces.  Here ``u24 = f(seed, t, row, col)`` is a counter-based
32-bit hash (:func:`u24_field`; the kernel's ``cell_u24``), written in
int64 with 32-bit masks since torch has no uint32 arithmetic; its products
are split into 16-bit halves so no int64 product overflows.  The plain
version also takes an explicit ``u24`` tensor so that a test can feed the
field the JAX kernel sees in interpret mode (zeros).
"""

from __future__ import annotations

from typing import Optional

import torch

from tip_tpu_torch import kernels
from tip_tpu_torch.data.packing import SYM_BLOCK as B, nb_from_cols

KERNEL = "dense_bce_sym"
RC = 16  # relations per CUDA block: the kernel keeps z tiles across them
PLAIN_CHUNK = 128  # relations per step of the plain version (memory bound)
SUPPORTED_D = (8, 16, 32)  # feature widths the kernel is instantiated for

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer mixer (lowbias32) on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def u24_field(seed: int, rel: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor, npad: int) -> torch.Tensor:
    """u24 [len(rel), len(rows), len(cols)] int64 for cells (row, col) of
    relations ``rel`` in the padded [npad, npad] plane — the kernel's
    ``cell_u24(relation_key(seed, t), row * npad + col)``."""
    t = rel.to(torch.int64)
    key = mix32((seed + mix32((t + 0x9E3779B9) & _M32)) & _M32)
    cell = rows.to(torch.int64)[:, None] * npad + cols.to(torch.int64)[None, :]
    return mix32(key[:, None, None] ^ mix32(cell)[None]) >> 8


# The plain versions of B1-B3 call no function that torch hands to MKL's
# vector math library (VML) on the CPU: exp, log, sqrt, tanh, ... of a
# float32 tensor there call MKL's vm*s (ATen/cpu/vml.h).  Split across the
# intra-op threads, the first such exp of a process that has run an MKL
# GEMM can return one thread's share at about half of float32's precision
# (relative errors to 1.5e-4), a different value from run to run: the u24
# = 0 tests' drift (ROADMAP Queue C).  softplus takes log1p(e^-|x|) from
# F.softplus and B1's sigmoid takes expm1, whose CPU kernels are SLEEF's.
def softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) without torch's large-x threshold, as jax.nn.softplus:
    # max(x, 0) + log1p(e^-|x|), the second term below any threshold
    return torch.clamp(x, min=0) + torch.nn.functional.softplus(-x.abs())


def _strip_off(nb: int, i: int) -> int:
    return (i * nb - i * (i - 1) // 2) * B


def dense_bce_sym_plain(w, z, pages, q8, seed: int, grads: bool = False,
                        u24: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the symmetric estimator.

    w [R, d], z [n, d] float; pages [R, 128, NB*128] int8; q8 [R, 8] int32;
    seed: uint32.  ``u24``: optional explicit field broadcastable to the
    pages' shape, in place of the hashed one.  Returns the loss, or
    (loss, dw, dz) with ``grads``.  Relations go PLAIN_CHUNK at a time
    to bound memory."""
    n_et, _, totcols = pages.shape
    n, d = z.shape
    nb = nb_from_cols(totcols)
    npad = nb * B
    dev = z.device
    zb = torch.nn.functional.pad(z.float(), (0, 0, 0, npad - n))
    wf = w.float()
    idx = torch.arange(npad, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    dw = torch.zeros((n_et, d), dtype=torch.float32, device=dev)
    dzb = torch.zeros((npad, d), dtype=torch.float32, device=dev)
    if u24 is not None:
        u24 = u24.to(dev).expand(n_et, B, totcols)
    for c0 in range(0, n_et, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, n_et)
        rel = torch.arange(c0, c1, device=dev)
        wc = wf[c0:c1]
        qc = q8[c0:c1].to(torch.int64)
        for i in range(nb):
            s = (nb - i) * B
            off = _strip_off(nb, i)
            da = pages[c0:c1, :, off:off + s].float()  # [Rc, B, s]
            zi, zt = zb[i * B:(i + 1) * B], zb[i * B:]
            logits = (zi[None] * wc[:, None, :]) @ zt.T  # [Rc, B, s]
            rows, cols = idx[i * B:(i + 1) * B], idx[i * B:]
            if u24 is None:
                u = u24_field(seed, rel, rows, cols, npad)
            else:
                u = u24[c0:c1, :, off:off + s].to(torch.int64)
            diag = (cols < (i + 1) * B)[None, None, :]  # first 128 columns
            cnt = torch.zeros_like(logits)
            for k in range(4):
                q = torch.where(diag, qc[:, k, None, None],
                                qc[:, 4 + k, None, None])
                cnt = cnt + (u < q).float()
            bad = (da > 0) | (rows >= n)[None, :, None] | (cols >= n)[None, None, :]
            cnt = torch.where(bad, torch.zeros_like(cnt), cnt)
            daw = torch.where(diag, da, 2.0 * da)
            sp = softplus(-logits)
            total = total + torch.sum(sp * daw + (sp + logits) * cnt)
            if not grads:
                continue
            sg = -torch.expm1(-sp)  # 1 - exp(-sp), as the JAX kernel
            g = cnt - sg * (daw + cnt)
            hi = g @ zt  # [Rc, B, d]
            hj = g.transpose(1, 2) @ zi  # [Rc, s, d]
            dw[c0:c1] += (zi[None] * hi).sum(1)
            dzb[i * B:(i + 1) * B] += (wc[:, None, :] * hi).sum(0)
            dzb[i * B:] += (wc[:, None, :] * hj).sum(0)
    if not grads:
        return total
    return total, dw, dzb[:n]


def _check_cuda_args(w, z, pages, q8):
    dev = pages.device
    for name, x, dtype, ndim in (("w", w, torch.float32, 2),
                                 ("z", z, torch.float32, 2),
                                 ("pages", pages, torch.int8, 3),
                                 ("q8", q8, torch.int32, 2)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, pages on {dev}")
        if x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D {dtype}, got "
                             f"{x.dim()}-D {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_et, rows, totcols = pages.shape
    n, d = z.shape
    nb = nb_from_cols(totcols)
    if rows != B or w.shape != (n_et, d) or q8.shape != (n_et, 8):
        raise ValueError(f"shapes do not match: w {tuple(w.shape)}, z "
                         f"{tuple(z.shape)}, pages {tuple(pages.shape)}, "
                         f"q8 {tuple(q8.shape)}")
    if not (nb - 1) * B < n <= nb * B:
        raise ValueError(f"n = {n} does not fit {nb} strip rows")
    if d not in SUPPORTED_D:
        raise ValueError(f"feature width {d} not in {SUPPORTED_D}")
    if (nb * B) ** 2 >= 2**32:
        raise ValueError("cell index exceeds 32 bits")
    if pages.data_ptr() % 16:
        raise ValueError("pages must be 16-byte aligned (the kernel copies "
                         "its page tiles 16 bytes at a time)")
    return n_et, n, d, nb, totcols


def dense_bce_sym_cuda(w, z, pages, q8, seed: int, grads: bool = False):
    """Launch csrc/dense_bce_sym.cu on CUDA tensors.  Same contract as
    :func:`dense_bce_sym_plain` with the hashed field."""
    if not pages.is_cuda:
        raise ValueError("dense_bce_sym_cuda needs CUDA tensors")
    n_et, n, d, nb, totcols = _check_cuda_args(w, z, pages, q8)
    n_tiles = nb * (nb + 1) // 2
    n_chunks = -(-n_et // RC)
    # scratch freed on return while the kernel may still run: the caching
    # allocator reuses it only for later work on this same stream
    f32 = dict(dtype=torch.float32, device=pages.device)
    loss_part = torch.empty(n_tiles * n_chunks, **f32)
    loss = torch.empty((), **f32)
    if grads:
        dw_part = torch.empty(n_tiles * n_et * d, **f32)
        dz_part = torch.empty(n_chunks * n_tiles * 2 * B * d, **f32)
        dw = torch.empty((n_et, d), **f32)
        dz = torch.empty((n, d), **f32)
    else:
        dw_part = dz_part = dw = dz = None
    kernels.launch(KERNEL, "tip_dense_bce_sym", "ppppuiiiiiiipppppp", w, z,
                   pages, q8, seed & _M32, n_et, n, d, nb, totcols, RC,
                   int(grads), loss_part, dw_part, dz_part, loss, dw, dz,
                   device=pages.device)
    if not grads:
        return loss
    return loss, dw, dz


def _run(w, z, pages, q8, seed, grads, u24, plain=False):
    if plain:
        return dense_bce_sym_plain(w, z, pages, q8, seed, grads, u24)
    if pages.is_cuda:
        if u24 is not None:
            raise ValueError("an explicit u24 field is for the plain version "
                             "on the CPU; the kernel hashes its own")
        return dense_bce_sym_cuda(w, z, pages, q8, seed, grads)
    if pages.device.type != "cpu":
        raise ValueError(f"no dense_bce_sym for device {pages.device}")
    return dense_bce_sym_plain(w, z, pages, q8, seed, grads, u24)


class _DenseBceSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, z, pages, q8, seed, u24, plain):
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return _run(w, z, pages, q8, seed, False, u24, plain)
        loss, dw, dz = _run(w, z, pages, q8, seed, True, u24, plain)
        ctx.save_for_backward(dw, dz)
        return loss

    @staticmethod
    def backward(ctx, g):
        dw, dz = ctx.saved_tensors
        return g * dw, g * dz, None, None, None, None, None


def dense_bce_sym_sum(w, z, pages, q8, seed: int,
                      u24: Optional[torch.Tensor] = None):
    """Scalar positive + Poissonized-negative BCE sum over symmetric strips.

    w [n_et, d] f32; z [n, d] f32; pages [n_et, 128, NB*128] int8
    (sym_strip_pack); q8 [n_et, 8] int32 (poisson_neg_thresholds_sym);
    seed: int (its low 32 bits key the u24 field).  Differentiable in w
    and z; with a gradient needed, one fused pass yields (loss, dw, dz)."""
    return _DenseBceSym.apply(w, z, pages, q8, int(seed) & _M32, u24, False)


def dense_bce_sym_sum_xla(w, z, pages, q8, seed: int,
                          u24: Optional[torch.Tensor] = None):
    """The ``backend="xla"`` route of :func:`dense_bce_sym_sum` (port of
    tip_tpu/ops/pallas_dense_bce_sym.py:354 ``dense_bce_sym_sum_xla``):
    the same arguments and value, on CPU or CUDA tensors, no kernel."""
    # The JAX package's XLA branch (dense_bce_sym_sum_xla) computes the kernel's estimator
    # by autodiff over threefry draws.  With the port's hashed u24 field in
    # their place it is the function the plain version computes (the same
    # cells, counts and sums; the gradient by hand, not by autodiff), so
    # the xla route runs the plain version on any device and launches no
    # kernel.
    return _DenseBceSym.apply(w, z, pages, q8, int(seed) & _M32, u24, True)
