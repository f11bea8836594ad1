"""Fused dense BCE over the full relation pages (kernel B2): positives plus
Poissonized negatives of the DistMult decoder, with (dw, dz) from the same
pass.

Port of tip_tpu/ops/pallas_dense_bce.py (``dense_bce_sum``; per-page math
``_common`` and ``_bwd_kernel``).  Per relation t, over the cells of the
[n, n] page (row i = dst, col j = src):

    L    = (z_i * w_t) . z_j
    loss = sum DA softplus(-L) + C (softplus(-L) + L)
    C    = #{k < 3 : u24 < q[t, k]} on cells with DA = 0, else 0
    G    = C - sigmoid(-L) (DA + C)                        (dloss / dL)
    dw_t = sum_i z_i * (G z)_i,   dz = sum_t w_t * (G z + G^T z)

Pages are the unpadded counts [R, n, n] in float32 or bf16
(data/packing.py:cast_dense_adj), thresholds those of
``poisson_neg_thresholds``.  Self-pairs are cells like any other, as in
the JAX package.  Random bits: the TPU kernel draws from its on-chip PRNG;
here ``u24`` is the counter hash of ops/dense_bce_sym.py over the [n, n]
plane (``u24_field(seed, t, i, j)``, the field of B3), drawn alike by the
CUDA kernel and the plain version.  The plain version also takes an
explicit ``u24`` field, so a test can feed the zeros the JAX kernel sees
in interpret mode.

CPU tensors take :func:`dense_bce_plain`; CUDA tensors launch
``csrc/dense_bce.cu`` or raise.  :func:`dense_bce_sum` runs one fused
(loss, dw, dz) pass when a gradient is needed and scales the saved
gradients in the backward (the JAX package's custom_vjp): one kernel
launch a training step.
"""

from __future__ import annotations

from typing import Optional

import torch

from tip_tpu_torch import kernels
from tip_tpu_torch.ops.dense_bce_sym import softplus, u24_field

KERNEL = "dense_bce"
RC = 16  # relations per CUDA block: the kernel keeps z tiles across them
PLAIN_CHUNK = 64  # relations per step of the plain version (memory bound)
SUPPORTED_D = (8, 16, 32)  # feature widths the kernel is instantiated for
PAGE_DTYPES = (torch.float32, torch.bfloat16)
_M32 = 0xFFFFFFFF


def dense_bce_plain(w, z, pages, q, seed: int, grads: bool = False,
                    u24: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the estimator.

    w [R, d], z [n, d] float; pages [R, n, n] float32 or bf16 counts; q
    [R, 3] int32; seed uint32.  ``u24``: optional explicit field
    broadcastable to the pages' shape, in place of the hashed one.  Returns
    the loss, or (loss, dw, dz) with ``grads``.  Relations go PLAIN_CHUNK
    at a time to bound memory."""
    n_et, n, _ = pages.shape
    dev = pages.device
    zf, wf = z.float(), w.float()
    idx = torch.arange(n, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    dw = torch.zeros_like(wf)
    dz = torch.zeros_like(zf)
    if u24 is not None:
        u24 = u24.to(dev).expand(n_et, n, n)
    for c0 in range(0, n_et, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, n_et)
        wc = wf[c0:c1]
        da = pages[c0:c1].float()
        logits = (zf[None] * wc[:, None, :]) @ zf.T  # [Rc, n, n]
        u = (u24_field(seed, torch.arange(c0, c1, device=dev), idx, idx, n)
             if u24 is None else u24[c0:c1].to(torch.int64))
        qc = q[c0:c1].to(torch.int64)
        cnt = sum((u < qc[:, k, None, None]).float() for k in range(3))
        cnt = torch.where(da > 0, torch.zeros_like(cnt), cnt)
        sp = softplus(-logits)
        total = total + torch.sum(sp * da + (sp + logits) * cnt)
        if grads:
            g = cnt - torch.sigmoid(-logits) * (da + cnt)
            h = g @ zf  # [Rc, n, d]: G z
            ht = g.transpose(1, 2) @ zf  # G^T z
            dw[c0:c1] = (zf[None] * h).sum(1)
            dz += (wc[:, None, :] * (h + ht)).sum(0)
    if not grads:
        return total
    return total, dw, dz


def _check_cuda_args(w, z, pages, q):
    dev = pages.device
    if pages.dtype not in PAGE_DTYPES:
        raise ValueError(f"pages must be float32 or bfloat16, got {pages.dtype}")
    for name, x, dtype, ndim in (("w", w, torch.float32, 2),
                                 ("z", z, torch.float32, 2),
                                 ("pages", pages, pages.dtype, 3),
                                 ("q", q, torch.int32, 2)):
        kernels.require(x, name, dtype, ndim, dev)
    n_et, n, n2 = pages.shape
    d = z.shape[1]
    if (n2 != n or z.shape[0] != n or w.shape != (n_et, d)
            or q.shape != (n_et, 3)):
        raise ValueError(f"shapes do not match: w {tuple(w.shape)}, z "
                         f"{tuple(z.shape)}, pages {tuple(pages.shape)}, "
                         f"q {tuple(q.shape)}")
    if d not in SUPPORTED_D:
        raise ValueError(f"feature width {d} not in {SUPPORTED_D}")
    if n * n >= 2**32:
        raise ValueError("cell index exceeds 32 bits")
    if pages.data_ptr() % 16:
        raise ValueError("pages must be 16-byte aligned (the kernel stages "
                         "page rows from the 16-byte chunks that cover them)")
    return n_et, n, d


def dense_bce_cuda(w, z, pages, q, seed: int, grads: bool = False):
    """Launch csrc/dense_bce.cu on CUDA tensors.  Same contract as
    :func:`dense_bce_plain` with the hashed field."""
    if not pages.is_cuda:
        raise ValueError("dense_bce_cuda needs CUDA tensors")
    n_et, n, d = _check_cuda_args(w, z, pages, q)
    nb = -(-n // 128)
    n_chunks = -(-n_et // RC)
    # scratch freed on return while the kernel may still run: the caching
    # allocator reuses it only for later work on this same stream
    f32 = dict(dtype=torch.float32, device=pages.device)
    loss_part = torch.empty(nb * nb * n_chunks, **f32)
    loss = torch.empty((), **f32)
    if grads:
        dw_part = torch.empty(nb * nb * n_et * d, **f32)
        dz_part = torch.empty(n_chunks * nb * nb * 2 * 128 * d, **f32)
        dw = torch.empty((n_et, d), **f32)
        dz = torch.empty((n, d), **f32)
    else:
        dw_part = dz_part = dw = dz = None
    kernels.launch(KERNEL, "tip_dense_bce", "pppipuiiiiipppppp", w, z, pages,
                   int(pages.dtype == torch.bfloat16), q, seed & _M32, n_et,
                   n, d, RC, int(grads), loss_part, dw_part, dz_part, loss, dw,
                   dz, device=pages.device)
    if not grads:
        return loss
    return loss, dw, dz


def _run(w, z, pages, q, seed, grads, u24, plain=False):
    if plain:
        return dense_bce_plain(w, z, pages, q, seed, grads, u24)
    if pages.is_cuda:
        if u24 is not None:
            raise ValueError("an explicit u24 field is for the plain version "
                             "on the CPU; the kernel hashes its own")
        return dense_bce_cuda(w, z, pages, q, seed, grads)
    if pages.device.type != "cpu":
        raise ValueError(f"no dense_bce for device {pages.device}")
    return dense_bce_plain(w, z, pages, q, seed, grads, u24)


class _DenseBce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, z, pages, q, seed, u24, plain):
        w, z = w.float().contiguous(), z.float().contiguous()
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return _run(w, z, pages, q, seed, False, u24, plain)
        loss, dw, dz = _run(w, z, pages, q, seed, True, u24, plain)
        ctx.save_for_backward(dw, dz)
        return loss

    @staticmethod
    def backward(ctx, g):
        dw, dz = ctx.saved_tensors
        return g * dw, g * dz, None, None, None, None, None


def dense_bce_sum(w, z, pages, q, seed: int,
                  u24: Optional[torch.Tensor] = None):
    """Scalar positive + Poissonized-negative BCE sum over the full pages.

    w [n_et, d] DistMult relation rows; z [n, d] embeddings; pages
    [n_et, n, n] float32 or bf16 counts; q [n_et, 3] int32 thresholds
    (poisson_neg_thresholds); seed: int (its low 32 bits key the u24
    field).  Differentiable in w and z; with a gradient needed, one fused
    pass yields (loss, dw, dz)."""
    return _DenseBce.apply(w, z, pages, q, int(seed) & _M32, u24, False)


def dense_bce_sum_xla(w, z, pages, q, seed: int,
                      u24: Optional[torch.Tensor] = None):
    """The ``backend="xla"`` route of :func:`dense_bce_sum` (port of
    tip_tpu/ops/pallas_dense_bce.py:363 ``dense_bce_sum_xla``): the same
    arguments and value, on CPU or CUDA tensors, no kernel."""
    # The JAX package's XLA branch (dense_bce_sum_xla) computes the kernel's estimator
    # by autodiff over threefry draws.  With the port's hashed u24 field in
    # their place it is the function the plain version computes (the same
    # cells, counts and sums; the gradient by hand, not by autodiff), so
    # the xla route runs the plain version on any device and launches no
    # kernel.
    return _DenseBce.apply(w, z, pages, q, int(seed) & _M32, u24, True)
