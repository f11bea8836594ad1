"""The R-GCN's M-first contraction over the int8 strips, ``M = bf16(att)^T
S``, and its gradient (kernel B15).

nn/rgcn.py:dense_rgcn_pair_apply_sym contracts the concatenated attention
table of both layers, rounded to bf16, with the resident int8 strips S
[R, 128, totcols] (data/packing.py:sym_strip_pack), so that both layers' M
come from one product.  The JAX package does it as one XLA dot with bf16
inputs and a float32 result (tip_tpu/nn/rgcn.py:203); it replaces no
``pl.pallas_call``.  The CUDA kernel (``csrc/rgcn_contract.cu``, whose header
says how it is laid out and what bounds it) reads the int8 strips where they
lie and multiplies on the tensor cores, with no float32 copy of them:

  * forward: every int8 x bf16 product is exact, each group of 16 relations
    is summed into a fresh accumulator and added to the running float32
    sum in relation order;
  * backward, dA = S dM^T for M's float32 gradient dM: the kernel splits dM
    exactly into three bf16 terms (ops/pp_aggregate.py:split3_plain), so
    the products stay exact and the sums float32; column slabs' partials
    are added in a fixed order (bit-equal reruns).  The gradient leaves as
    float32, and autograd rounds it to the bf16 ``att``'s dtype, as the
    cast in ``bf16_round(att_cat)`` did.

Three pieces, as for the other kernels: :func:`rgcn_contract_plain` (and
:func:`rgcn_contract_grad_plain`), the plain PyTorch version (CPU tensors
take it, and the card's checks hold the kernel to it);
:func:`rgcn_contract_cuda` (and :func:`rgcn_contract_grad_cuda`), the
kernel's wrapper, which launches it or raises; :func:`rgcn_contract`, the
entry point, an ``autograd.Function`` that saves only the int8 strips and
the bf16 ``att``.
"""

from __future__ import annotations

import functools

import torch

from tip_tpu_torch import kernels, trace
from tip_tpu_torch.ops import pp_aggregate

KERNEL = "rgcn_contract"
WIDTHS = (32, 64)  # basis widths the kernel is instantiated for
F_COLS = 256  # columns a forward block (rgcn_contract.cu)
B_KC = 64  # columns a backward stage
MAX_SLABS = 512


def rgcn_contract_plain(att: torch.Tensor, strips: torch.Tensor) -> torch.Tensor:
    """M = att^T S, float32 [Bt, C]: att upcast (a bf16 att exactly),
    the strips upcast exactly, one float32 product (the expression the
    kernel replaced, bit for bit)."""
    r = strips.shape[0]
    return att.float().T @ strips.reshape(r, -1).float()


def rgcn_contract_grad_plain(strips: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """dA = S g^T, float32 [R, Bt], for M's gradient g [Bt, C]: the product
    the float32 matmul's backward computes for ``att`` (column-major
    ``att^T``, so as ``S @ g^T``)."""
    r = strips.shape[0]
    return strips.reshape(r, -1).float() @ g.float().t()


def check_strips(strips: torch.Tensor, kernel: bool = False) -> None:
    """Raise unless strips is an int8 [R, ...] array; with ``kernel``, also
    what the CUDA kernel takes: contiguous and 16-byte aligned, R >= 1 and
    its R x C flattening's C a multiple of 256 (the strips' C is a
    multiple of 16,384)."""
    if strips.dtype != torch.int8 or strips.dim() < 2:
        raise ValueError(f"strips must be an int8 [R, ...] array, got "
                         f"{strips.dim()}-D {strips.dtype}")
    if not kernel:
        return
    r = strips.shape[0]
    c = strips[0].numel() if r else 0
    if r < 1 or c % F_COLS:
        raise ValueError(f"the kernel takes R >= 1 and C a multiple of "
                         f"{F_COLS}, got R={r}, C={c}")
    if not strips.is_contiguous() or strips.data_ptr() % 16:
        raise ValueError("strips must be contiguous and 16-byte aligned")


def check_args(att: torch.Tensor, strips: torch.Tensor, kernel: bool = False):
    """Raise unless att is an [R, Bt] bf16 table, Bt >= 1, for the int8
    strips [R, ...] (:func:`check_strips`)."""
    check_strips(strips, kernel)
    r = strips.shape[0]
    if att.dim() != 2 or att.shape[0] != r or att.shape[1] < 1:
        raise ValueError(f"att must be [{r}, Bt >= 1], got {tuple(att.shape)}")
    if att.dtype != torch.bfloat16:
        raise ValueError(f"att must be bfloat16, got {att.dtype}")


def column_blocks(bt: int):
    """[(b0, b1, w)]: the basis ranges the kernel takes in turn, each
    zero-padded to the instantiated width w (the least in :data:`WIDTHS`
    that holds it): one block up to 64 bases, blocks of 64 beyond."""
    return pp_aggregate.column_blocks(bt, WIDTHS)


def relation_tile(w: int) -> int:
    """Relations a backward block holds at width w: two warpgroups, each
    128 / w groups of 64 relations by all w bases."""
    return 2 * 64 * 128 // w


@functools.lru_cache(maxsize=64)  # called a launch, on the host
def slabs(r: int, c: int, w: int, sms: int) -> int:
    """Column slabs of the backward: the fewest that keep the most loaded
    SM (one resident block each) near the mean, with the partial sums'
    traffic (8 ks r w bytes) counted against a stage's strip bytes."""
    rt = relation_tile(w)
    tiles, nst = -(-r // rt), c // B_KC

    def cost(ks):
        return (-(-tiles * ks // sms) * nst / ks
                + 8 * ks * r * w / (sms * rt * B_KC))

    return min(range(1, min(nst, MAX_SLABS) + 1), key=cost)


def rgcn_contract_cuda(att: torch.Tensor, strips: torch.Tensor) -> torch.Tensor:
    """Launch csrc/rgcn_contract.cu's forward: M = att^T S, float32 [Bt, C],
    one launch a :func:`column_blocks` block."""
    if not (att.is_cuda and strips.is_cuda):
        raise ValueError("rgcn_contract_cuda needs CUDA tensors")
    check_args(att, strips, kernel=True)
    if att.device != strips.device:
        raise ValueError(f"att is on {att.device}, strips on {strips.device}")
    dev, att = strips.device, att.contiguous()
    (r, bt), c = att.shape, strips[0].numel()
    m = torch.empty((bt, c), dtype=torch.float32, device=dev)
    ksteps = 2 * -(-r // 32)
    for b0, b1, w in column_blocks(bt):
        # scratch freed on return while the kernel may still run (reused
        # only by later work on this stream)
        af = torch.empty(ksteps * w * 8, dtype=torch.int32, device=dev)
        kernels.launch(KERNEL, "tip_rgcn_contract_fwd", "piqpiiiipp", strips,
                       r, c, att, bt, b0, b1 - b0, w, af, m, device=dev)
    return m


def rgcn_contract_grad_cuda(strips: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """Launch csrc/rgcn_contract.cu's backward: dA = S g^T, float32 [R, Bt],
    for M's float32 gradient g [Bt, C], one launch a block of bases."""
    if not (strips.is_cuda and g.is_cuda):
        raise ValueError("rgcn_contract_grad_cuda needs CUDA tensors")
    r, c = strips.shape[0], strips[0].numel()
    if g.dim() != 2 or g.shape[0] < 1 or g.shape[1] != c:
        raise ValueError(f"g must be [Bt, {c}], got {tuple(g.shape)}")
    if g.device != strips.device:
        raise ValueError(f"g is on {g.device}, strips on {strips.device}")
    check_strips(strips, kernel=True)
    dev, bt = strips.device, g.shape[0]
    g = g.float().contiguous()
    if g.data_ptr() % 16:  # the kernel reads dM's rows as float4
        g = g.clone()
    out = torch.empty((r, bt), dtype=torch.float32, device=dev)
    sms = kernels.sm_count(dev)
    for b0, b1, w in column_blocks(bt):
        ks = slabs(r, c, w, sms)
        part = torch.empty(ks * r * w, dtype=torch.float32, device=dev)
        kernels.launch(KERNEL, "tip_rgcn_contract_bwd", "piqpiiiippi", strips,
                       r, c, g, b0, b1 - b0, w, ks, part, out, bt, device=dev)
    return out


class _RgcnContract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, att, strips):
        ctx.save_for_backward(att, strips)
        if strips.is_cuda:
            return rgcn_contract_cuda(att, strips)
        return rgcn_contract_plain(att, strips)

    @staticmethod
    @trace.spanned("rgcn_contract")
    def backward(ctx, g):
        _, strips = ctx.saved_tensors
        if strips.is_cuda:
            da = rgcn_contract_grad_cuda(strips, g)
        else:
            da = rgcn_contract_grad_plain(strips, g)
        return da, None  # float32: autograd rounds it to att's bf16


def rgcn_contract(att: torch.Tensor, strips: torch.Tensor) -> torch.Tensor:
    """M = att^T S, float32 [Bt, C] with C = strips[0].numel(), for the
    bf16 attention table ``att`` [R, Bt] and the int8 strips ``strips``
    [R, 128, totcols]; differentiable in att.  CPU tensors take
    :func:`rgcn_contract_plain`, CUDA tensors the kernel (or raise)."""
    check_args(att, strips)
    if att.device != strips.device:
        raise ValueError(f"att is on {att.device}, strips on {strips.device}")
    if strips.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rgcn_contract for device {strips.device}")
    return _RgcnContract.apply(att, strips)
