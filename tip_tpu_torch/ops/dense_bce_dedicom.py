"""Fused dense BCE of Decagon's DEDICOM decoder over the full relation pages
(kernel B13): positives plus Poissonized negatives, with (dz, dd, dR) from
the same pass.

DEDICOM (Zitnik et al. 2018, ``DEDICOMDecoder``) scores relation t's pair
(dst i, src j) as L = z_i D_t R D_t z_j^T: D_t = diag(d_t) a relation's
diagonal, R [d, d] one global matrix; the logits are not symmetric.  Per
relation t, over the cells of the [n, n] page (row i = dst, col j = src):

    loss = sum DA softplus(-L) + C (softplus(-L) + L)
    C    = #{k < 3 : u24 < q[t, k]} on cells with DA = 0, else 0
    G    = C - sigmoid(-L) (DA + C)                        (dloss / dL)
    H = G z,  H' = G^T z,  uI = (H d_t) R^T,  uJ = (H' d_t) R
    dz = sum_t d_t (uI + uJ),  dd_t = sum_i z_i (uI + uJ)_i,
    dR = sum_t sum_i (z_i d_t)^T (H_i d_t)

The field and the thresholds are those of kernel B2 (ops/dense_bce.py):
the counter hash ``u24_field(seed, t, i, j)`` over the [n, n] plane and
``poisson_neg_thresholds``.  The JAX package has no Decagon model, so B13
replaces no ``pl.pallas_call``; its dots are float32-exact (3xTF32 on the
tensor cores: mma.sync beside the cell math, warpgroup MMA for the
gradients' products; csrc/dense_bce_dedicom.cu).

CPU tensors take :func:`dense_bce_dedicom_plain`; CUDA tensors launch the
kernel or raise (``plain`` takes the plain version on any device).
:func:`dense_bce_dedicom_sum` runs one fused (loss, dz, dd, dR) pass when a
gradient is needed and scales the saved gradients in the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from tip_tpu_torch import kernels, trace
from tip_tpu_torch.ops.dense_bce_sym import softplus, u24_field

KERNEL = "dense_bce_dedicom"
RC = 16  # relations a CUDA block: the kernel keeps z tiles across them
PLAIN_CHUNK = 64  # relations a step of the plain version
WIDTHS = (8, 16, 32)  # feature widths the kernel is instantiated for
_M32 = 0xFFFFFFFF


def dedicom_logits(z, dvec, rmat):
    """[R, n, n] logits, rows dst, columns src: ((z d_t) R) (z d_t)^T."""
    zd = z[None] * dvec[:, None, :]
    return (zd @ rmat) @ zd.transpose(1, 2)


def dense_bce_dedicom_plain(dvec, rmat, z, pages, q, seed: int,
                            grads: bool = False,
                            u24: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the estimator.

    dvec [R, d], rmat [d, d], z [n, d] float; pages [R, n, n] uint8 or
    float32 counts; q [R, 3] int32; seed uint32.  ``u24``: an explicit
    field broadcastable to the pages' shape, in place of the hashed one.
    Returns the loss, or (loss, dz, dd, dR) with ``grads``."""
    n_et, n, _ = pages.shape
    dev = pages.device
    zf, df, rf = z.float(), dvec.float(), rmat.float()
    idx = torch.arange(n, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    dz, dd, dr = torch.zeros_like(zf), torch.zeros_like(df), torch.zeros_like(rf)
    if u24 is not None:
        u24 = u24.to(dev).expand(n_et, n, n)
    for c0 in range(0, n_et, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, n_et)
        dc = df[c0:c1]
        da = pages[c0:c1].float()
        logits = dedicom_logits(zf, dc, rf)
        u = (u24_field(seed, torch.arange(c0, c1, device=dev), idx, idx, n)
             if u24 is None else u24[c0:c1].to(torch.int64))
        qc = q[c0:c1].to(torch.int64)
        cnt = sum((u < qc[:, k, None, None]).float() for k in range(3))
        cnt = torch.where(da > 0, torch.zeros_like(cnt), cnt)
        sp = softplus(-logits)
        total = total + torch.sum(sp * da + (sp + logits) * cnt)
        if grads:
            g = cnt - torch.sigmoid(-logits) * (da + cnt)
            hd = (g @ zf) * dc[:, None, :]  # (G z) d_t
            htd = (g.transpose(1, 2) @ zf) * dc[:, None, :]  # (G^T z) d_t
            uu = hd @ rf.T + htd @ rf
            dz += (dc[:, None, :] * uu).sum(0)
            dd[c0:c1] = (zf[None] * uu).sum(1)
            zd = zf[None] * dc[:, None, :]
            dr += (zd.transpose(1, 2) @ hd).sum(0)
    if not grads:
        return total
    return total, dz, dd, dr


def _check_cuda_args(dvec, rmat, z, pages, q):
    dev = pages.device
    if pages.dtype != torch.uint8:
        raise ValueError(f"pages must be uint8, got {pages.dtype}")
    for name, x, dtype, ndim in (("dvec", dvec, torch.float32, 2),
                                 ("rmat", rmat, torch.float32, 2),
                                 ("z", z, torch.float32, 2),
                                 ("pages", pages, torch.uint8, 3),
                                 ("q", q, torch.int32, 2)):
        kernels.require(x, name, dtype, ndim, dev)
    n_et, n, n2 = pages.shape
    d = z.shape[1]
    if (n2 != n or z.shape[0] != n or dvec.shape != (n_et, d)
            or rmat.shape != (d, d) or q.shape != (n_et, 3)):
        raise ValueError(f"shapes do not match: dvec {tuple(dvec.shape)}, "
                         f"rmat {tuple(rmat.shape)}, z {tuple(z.shape)}, "
                         f"pages {tuple(pages.shape)}, q {tuple(q.shape)}")
    if d not in WIDTHS:
        raise ValueError(f"feature width {d} not in {WIDTHS}")
    if n * n >= 2**32:
        raise ValueError("cell index exceeds 32 bits")
    if pages.data_ptr() % 16:
        raise ValueError("pages must be 16-byte aligned")
    return n_et, n, d


def padded_width(d: int) -> int:
    """The instantiated width a feature width d runs at (zero-padded: a
    zero feature adds nothing to any logit or gradient); d <= 32."""
    for w in WIDTHS:
        if d <= w:
            return w
    raise ValueError(f"feature width {d} > {WIDTHS[-1]}: the kernel keeps "
                     "whole z rows of a tile in shared memory")


def scratch_floats(n: int, n_et: int, d: int) -> dict:
    """Float32 scratch a fused launch allocates for its partials, by part
    (the C entry point's sizes): 128 x 128 tiles, RC relations a block."""
    nb = -(-n // 128)
    n_chunks = -(-n_et // RC)
    return {"loss_part": nb * nb * n_chunks,
            "dd_part": nb * nb * n_et * d,
            "dz_part": n_chunks * nb * nb * 2 * 128 * d,
            "dr_part": nb * nb * n_chunks * d * d}


def launch_config(n: int, n_et: int, d: int, grads: bool = True) -> dict:
    """The tile kernel's grid, threads a block and dynamic shared memory
    for an [n_et, n, n] launch at width d (padded as the wrapper pads),
    from the built library (CUDA only)."""
    import ctypes

    fn = kernels.load(KERNEL).tip_dense_bce_dedicom_config
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(n, n_et, padded_width(d), RC, int(grads), ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{KERNEL}: no configuration for width {d}")
    return {"blocks": [out[0], out[1]], "threads": out[2],
            "smem_bytes": out[3]}


def dense_bce_dedicom_cuda(dvec, rmat, z, pages, q, seed: int,
                           grads: bool = False):
    """Launch csrc/dense_bce_dedicom.cu on CUDA tensors, at any width up to
    32 (zero-padded to the next instance).  Same contract as
    :func:`dense_bce_dedicom_plain` with the hashed field."""
    if not pages.is_cuda:
        raise ValueError("dense_bce_dedicom_cuda needs CUDA tensors")
    d = z.shape[1]
    w = padded_width(d)
    if w != d:
        pad = w - d
        F = torch.nn.functional
        out = dense_bce_dedicom_cuda(F.pad(dvec, (0, pad)),
                                     F.pad(rmat, (0, pad, 0, pad)),
                                     F.pad(z, (0, pad)), pages, q, seed, grads)
        if not grads:
            return out
        loss, gz, gd, gr = out
        return loss, gz[:, :d], gd[:, :d], gr[:d, :d]
    n_et, n, d = _check_cuda_args(dvec, rmat, z, pages, q)
    size = scratch_floats(n, n_et, d)
    f32 = dict(dtype=torch.float32, device=pages.device)
    loss_part = torch.empty(size["loss_part"], **f32)
    loss = torch.empty((), **f32)
    if grads:
        dd_part = torch.empty(size["dd_part"], **f32)
        dz_part = torch.empty(size["dz_part"], **f32)
        dr_part = torch.empty(size["dr_part"], **f32)
        dz = torch.empty((n, d), **f32)
        dd = torch.empty((n_et, d), **f32)
        dr = torch.empty((d, d), **f32)
    else:
        dd_part = dz_part = dr_part = dz = dd = dr = None
    kernels.launch(KERNEL, "tip_dense_bce_dedicom", "pppppuiiiiipppppppp",
                   dvec, rmat, z, pages, q, seed & _M32, n_et, n, d, RC,
                   int(grads), loss_part, dd_part, dz_part, dr_part, loss, dd,
                   dz, dr, device=pages.device)
    if not grads:
        return loss
    return loss, dz, dd, dr


def _run(dvec, rmat, z, pages, q, seed, grads, u24, plain):
    if plain or not pages.is_cuda:
        if pages.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no dense_bce_dedicom for device {pages.device}")
        return dense_bce_dedicom_plain(dvec, rmat, z, pages, q, seed, grads,
                                       u24)
    if u24 is not None:
        raise ValueError("an explicit u24 field is for the plain version; the "
                         "kernel hashes its own")
    return dense_bce_dedicom_cuda(dvec, rmat, z, pages, q, seed, grads)


class _DenseBceDedicom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dvec, rmat, z, pages, q, seed, u24, plain):
        dvec, rmat, z = (x.float().contiguous() for x in (dvec, rmat, z))
        if not any(ctx.needs_input_grad[:3]):
            return _run(dvec, rmat, z, pages, q, seed, False, u24, plain)
        loss, dz, dd, dr = _run(dvec, rmat, z, pages, q, seed, True, u24,
                                plain)
        ctx.save_for_backward(dd, dr, dz)
        return loss

    @staticmethod
    @trace.spanned("dedicom_bce")
    def backward(ctx, g):
        dd, dr, dz = ctx.saved_tensors
        return g * dd, g * dr, g * dz, None, None, None, None, None


def dense_bce_dedicom_sum(dvec, rmat, z, pages, q, seed: int,
                          u24: Optional[torch.Tensor] = None,
                          plain: bool = False):
    """Scalar positive + Poissonized-negative BCE sum of the DEDICOM
    decoder over the full pages.

    dvec [R, d] the relations' diagonals; rmat [d, d] the global matrix; z
    [n, d] embeddings; pages [R, n, n] uint8 counts (any dtype for the
    plain version); q [R, 3]
    int32 thresholds (poisson_neg_thresholds); seed: int (its low 32 bits
    key the u24 field).  Differentiable in dvec, rmat and z; with a
    gradient needed one fused pass yields all three."""
    return _DenseBceDedicom.apply(dvec, rmat, z, pages, q, int(seed) & _M32,
                                  u24, plain)
