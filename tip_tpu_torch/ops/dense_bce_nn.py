"""Fused dense BCE of the NN decoder (kernel B3): positives plus
Poissonized negatives over the full relation pages, with the gradients to
the decoder's relation rows and endpoint hiddens from the same pass.

Port of tip_tpu/ops/pallas_dense_bce_nn.py (``dense_bce_nn_sum``).  Per
relation t, over the cells of the [n, n] page (row i = dst, col j = src):

    L[i, j] = s2_t[i] + s1_t[j],   s1_t = h1 @ w1[t],  s2_t = h2 @ w2[t]
    loss    = sum DA softplus(-L) + C (softplus(-L) + L)
    C       = #{k < 3 : u24 < q[t, k]} on cells with DA = 0, else 0
    G       = C - sigmoid(-L) (DA + C)                      (dloss / dL)

and, with the row sums r_t = G 1 and column sums c_t = G^T 1,

    dw2[t] = r_t . h2,  dh2 = sum_t r_t (x) w2[t],
    dw1[t] = c_t . h1,  dh1 = sum_t c_t (x) w1[t].

Pages are the unpadded counts of data/packing.py:cast_dense_adj in the
dtype the graph ships (uint8 beside DR-NN's strips, bf16 or float32 as the
full-page layout: the JAX kernel reads the pages of whatever dtype
``preferred_dense_dtype`` picked), thresholds those of
``poisson_neg_thresholds``.  Random bits: the TPU
kernel draws from its on-chip PRNG; here ``u24`` is the counter hash of
ops/dense_bce_sym.py (``u24_field(seed, t, i, j)`` over the [n, n] plane),
drawn alike by the CUDA kernel and the plain version.  The plain version
also takes an explicit ``u24`` field, so a test can feed the zeros the
JAX kernel sees in interpret mode.

CPU tensors take :func:`dense_bce_nn_plain`; CUDA tensors launch
``csrc/dense_bce_nn.cu`` or raise.  :func:`dense_bce_nn_sum` runs one fused
(loss, dw1, dw2, dh1, dh2) pass when a gradient is needed and scales the
saved gradients in the backward (the JAX package's custom_vjp): one kernel
launch a training step.
"""

from __future__ import annotations

from typing import Optional

import torch

from tip_tpu_torch import kernels
from tip_tpu_torch.ops.dense_bce_sym import softplus, u24_field
from tip_tpu_torch.ops.sddmm2 import contract_slabs

KERNEL = "dense_bce_nn"
D = 16  # the kernel's hidden width: nn_decoder_l1_dim of DR-NN
PLAIN_CHUNK = 64  # relations per step of the plain version (memory bound)
# page dtype -> the C entry point's page_kind
PAGE_KINDS = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}
_M32 = 0xFFFFFFFF


def dense_bce_nn_plain(w1, w2, h1, h2, pages, q, seed: int,
                       grads: bool = False,
                       u24: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the estimator.

    w1, w2 [R, l1], h1, h2 [n, l1] float; pages [R, n, n] uint8, bf16 or
    float32 counts; q [R, 3] int32; seed uint32.  ``u24``: optional explicit field broadcastable to
    the pages' shape, in place of the hashed one.  Returns the loss, or
    (loss, dw1, dw2, dh1, dh2) with ``grads``."""
    n_et, n, _ = pages.shape
    dev = pages.device
    h1f, h2f = h1.float(), h2.float()
    w1f, w2f = w1.float(), w2.float()
    s1, s2 = h1f @ w1f.T, h2f @ w2f.T  # [n, R] endpoint scores
    idx = torch.arange(n, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    r = torch.zeros((n_et, n), dtype=torch.float32, device=dev)
    c = torch.zeros((n_et, n), dtype=torch.float32, device=dev)
    if u24 is not None:
        u24 = u24.to(dev).expand(n_et, n, n)
    for c0 in range(0, n_et, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, n_et)
        rel = torch.arange(c0, c1, device=dev)
        da = pages[c0:c1].float()
        logits = s2[:, c0:c1].T[:, :, None] + s1[:, c0:c1].T[:, None, :]
        u = (u24_field(seed, rel, idx, idx, n) if u24 is None
             else u24[c0:c1].to(torch.int64))
        qc = q[c0:c1].to(torch.int64)
        cnt = sum((u < qc[:, k, None, None]).float() for k in range(3))
        cnt = torch.where(da > 0, torch.zeros_like(cnt), cnt)
        sp = softplus(-logits)
        total = total + torch.sum(sp * da + (sp + logits) * cnt)
        if grads:
            g = cnt - torch.sigmoid(-logits) * (da + cnt)
            r[c0:c1] = g.sum(2)
            c[c0:c1] = g.sum(1)
    if not grads:
        return total
    return total, c @ h1f, r @ h2f, c.T @ w1f, r.T @ w2f


def _check_cuda_args(w1, w2, h1, h2, pages, q):
    dev = pages.device
    if pages.dtype not in PAGE_KINDS:
        raise ValueError(f"pages must be uint8, bfloat16 or float32, got "
                         f"{pages.dtype}")
    for name, x, dtype, ndim in (("w1", w1, torch.float32, 2),
                                 ("w2", w2, torch.float32, 2),
                                 ("h1", h1, torch.float32, 2),
                                 ("h2", h2, torch.float32, 2),
                                 ("pages", pages, pages.dtype, 3),
                                 ("q", q, torch.int32, 2)):
        kernels.require(x, name, dtype, ndim, dev)
    n_et, n, n2 = pages.shape
    if (n2 != n or w1.shape != (n_et, D) or w2.shape != (n_et, D)
            or h1.shape != (n, D) or h2.shape != (n, D)
            or q.shape != (n_et, 3)):
        raise ValueError(
            f"shapes do not match (l1 = {D}): w1 {tuple(w1.shape)}, w2 "
            f"{tuple(w2.shape)}, h1 {tuple(h1.shape)}, h2 {tuple(h2.shape)}, "
            f"pages {tuple(pages.shape)}, q {tuple(q.shape)}")
    if n * n >= 2**32:
        raise ValueError("cell index exceeds 32 bits")
    if pages.data_ptr() % 16:
        raise ValueError("pages must be 16-byte aligned (the kernel stages "
                         "page rows from the 16-byte chunks that cover them)")
    return n_et, n


ROWS = 128  # page rows per CUDA block (the kernel's TR)


def dense_bce_nn_cuda(w1, w2, h1, h2, pages, q, seed: int,
                      grads: bool = False):
    """Launch csrc/dense_bce_nn.cu on CUDA tensors.  Same contract as
    :func:`dense_bce_nn_plain` with the hashed field."""
    if not pages.is_cuda:
        raise ValueError("dense_bce_nn_cuda needs CUDA tensors")
    n_et, n = _check_cuda_args(w1, w2, h1, h2, pages, q)
    n_tiles = -(-n // ROWS)
    # scratch freed on return while the kernel may still run: the caching
    # allocator reuses it only for later work on this same stream
    f32 = dict(dtype=torch.float32, device=pages.device)
    loss_part = torch.empty(n_et * n_tiles, **f32)
    loss = torch.empty((), **f32)
    slabs = contract_slabs(n_et)
    if grads:
        col_part = torch.empty((n_et, n_tiles, n), **f32)
        rows, cols = torch.empty((n_et, n), **f32), torch.empty((n_et, n), **f32)
        slab_part = torch.empty((2, slabs, n, D), **f32)
        dw1, dw2 = torch.empty((n_et, D), **f32), torch.empty((n_et, D), **f32)
        dh1, dh2 = torch.empty((n, D), **f32), torch.empty((n, D), **f32)
    else:
        col_part = rows = cols = slab_part = dw1 = dw2 = dh1 = dh2 = None
    kernels.launch(KERNEL, "tip_dense_bce_nn", "pppppipuiiippppipppppp", w1,
                   w2, h1, h2, pages, PAGE_KINDS[pages.dtype], q, seed & _M32,
                   n_et, n, int(grads), loss_part, col_part, rows, cols,
                   slabs, slab_part, loss, dw1, dw2, dh1, dh2,
                   device=pages.device)
    if not grads:
        return loss
    return loss, dw1, dw2, dh1, dh2


def _run(w1, w2, h1, h2, pages, q, seed, grads, u24, plain=False):
    if plain:
        return dense_bce_nn_plain(w1, w2, h1, h2, pages, q, seed, grads, u24)
    if pages.is_cuda:
        if u24 is not None:
            raise ValueError("an explicit u24 field is for the plain version "
                             "on the CPU; the kernel hashes its own")
        return dense_bce_nn_cuda(w1, w2, h1, h2, pages, q, seed, grads)
    if pages.device.type != "cpu":
        raise ValueError(f"no dense_bce_nn for device {pages.device}")
    return dense_bce_nn_plain(w1, w2, h1, h2, pages, q, seed, grads, u24)


class _DenseBceNN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w1, w2, h1, h2, pages, q, seed, u24, plain):
        args = [x.float().contiguous() for x in (w1, w2, h1, h2)]
        if not any(ctx.needs_input_grad[:4]):
            return _run(*args, pages, q, seed, False, u24, plain)
        loss, *grads = _run(*args, pages, q, seed, True, u24, plain)
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    def backward(ctx, g):
        dw1, dw2, dh1, dh2 = ctx.saved_tensors
        return (g * dw1, g * dw2, g * dh1, g * dh2, None, None, None, None,
                None)


def dense_bce_nn_sum(w1_l2, w2_l2, h1, h2, pages, q, seed: int,
                     u24: Optional[torch.Tensor] = None):
    """Scalar BCE sum for the NN decoder: positives + Poissonized negatives.

    w1_l2, w2_l2 [n_et, l1] per-relation L2 rows; h1, h2 [n, l1] post-ReLU
    endpoint hiddens; pages [n_et, n, n] uint8, bf16 or float32
    counts; q [n_et, 3] int32
    thresholds; seed: int (its low 32 bits key the u24 field).
    Differentiable in w1_l2, w2_l2, h1 and h2."""
    return _DenseBceNN.apply(w1_l2, w2_l2, h1, h2, pages, q,
                             int(seed) & _M32, u24, False)


def dense_bce_nn_sum_xla(w1_l2, w2_l2, h1, h2, pages, q, seed: int,
                         u24: Optional[torch.Tensor] = None):
    """The ``backend="xla"`` route of :func:`dense_bce_nn_sum` (port of
    tip_tpu/ops/pallas_dense_bce_nn.py:248 ``dense_bce_nn_sum_xla``): the
    same arguments and value, on CPU or CUDA tensors, no kernel."""
    # The JAX package's XLA branch (dense_bce_nn_sum_xla) computes the kernel's estimator
    # by autodiff over threefry draws.  With the port's hashed u24 field in
    # their place it is the function the plain version computes (the same
    # cells, counts and sums; the gradient by hand, not by autodiff), so
    # the xla route runs the plain version on any device and launches no
    # kernel.
    return _DenseBceNN.apply(w1_l2, w2_l2, h1, h2, pages, q,
                             int(seed) & _M32, u24, True)
