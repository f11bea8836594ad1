"""Differentiable collectives: the port's counterparts of ``lax.psum``,
``lax.all_gather(tiled=True)``, ``lax.ppermute`` and ``lax.axis_index``.

JAX derives their transposes from shard_map's replication typing.  PyTorch
has none, so every sharded function here keeps one convention:

  * every rank computes the same replicated loss and backpropagates a
    cotangent of 1 from it;
  * the backward of a sum over ranks is a sum over the same ranks of the
    cotangent;
  * the backward of a tiled all-gather is a sum over ranks of the
    cotangent, then this rank's tile (a reduce-scatter);
  * the train step sums the parameter gradients over all ranks and divides
    by their number (parallel/sharded.py).

Each rank's gradient then carries the world size times its share, and the
step's mean gives the single-device gradient: for intermediate sums (the
R-GCN's ``q``, the hierarchy's ``part``), for the loss sum, and for
replicated parameters used on both replicated and rank-local branches.
tests/test_torch_parallel.py holds the sharded gradients against the
single-device ones.

Gloo runs collectives on host tensors (it refuses CUDA tensors for several
of them), so each one stages a CUDA tensor through a pinned host copy and
copies the result back; the copies wait for the device.  ``group`` None is
the world group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of x that a collective may overwrite."""
    x = x.detach()
    if x.is_cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return buf.copy_(x)
    return x.clone(memory_format=torch.contiguous_format)


def group_rank(group=None) -> int:
    """This rank's index in ``group`` (``lax.axis_index``)."""
    return dist.get_rank(group)


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def all_reduce_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of x over the ranks of ``group``, on x's device."""
    buf = _host(x)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' x concatenated along axis 0 in rank order."""
    buf = _host(x)
    parts = [torch.empty_like(buf) for _ in range(group_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts).to(x.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_plain(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_plain(g.contiguous(), ctx.group), None


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_plain(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        full = all_reduce_plain(g.contiguous(), ctx.group)
        i = group_rank(ctx.group)
        return full[i * ctx.rows:(i + 1) * ctx.rows], None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _permute_plain(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _permute_plain(g.contiguous(), -ctx.shift, ctx.group), None, None


def _permute_plain(x, shift: int, group):
    k = group_size(group)
    if k == 1:
        return x.clone()
    i = group_rank(group)
    rows = x.shape[0]
    full = all_gather_plain(x.contiguous(), group)
    j = (i + shift) % k
    return full[j * rows:(j + 1) * rows]


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of ``group``; backward sums the cotangent."""
    return _AllReduceSum.apply(x, group)


def all_gather_tiled(x: torch.Tensor, group=None) -> torch.Tensor:
    """[k * rows, ...]: the ranks' x along axis 0 in rank order; backward
    sums the cotangent over the ranks and takes this rank's tile."""
    return _AllGatherTiled.apply(x, group)


def ppermute_from(x: torch.Tensor, shift: int, group=None) -> torch.Tensor:
    """The x of rank ``(i + shift) mod k`` on rank i: ``lax.ppermute`` with
    the permutation j -> (j - shift) mod k.  Backward sends the cotangent
    the other way.  The plain version gathers every rank's x (k times the
    bytes of a point-to-point send; it serves the plain ring only)."""
    return _Permute.apply(x, shift, group)
