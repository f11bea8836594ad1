"""Rank layouts over an initialised ``torch.distributed`` process group
(port of tip_tpu/parallel/mesh.py: ``EDGE_AXIS``, ``RING_AXIS``,
``make_mesh``, ``make_mesh2``, ``mesh_axes``).

The JAX package's mesh is a grid of devices under one program; here each
rank is a process that drives one device, and a :class:`Mesh` says where
this rank sits:

  * 1-D ``(edges,)`` (:func:`make_mesh`): every subsystem spans all ranks.
    The D-D edge-chunk sums and the protein-row ring both run over the
    world group.
  * 2-D ``(ring, edges)`` (:func:`make_mesh2`): rank ``r`` sits at
    ``(r // n_edges, r % n_edges)``, as the JAX package reshapes its device
    list.  The D-D edge-chunk shard flattens over both axes (shard index =
    rank; its sums run over the world group); the P-P ring rides the
    ``ring`` axis, inside the subgroup of the ranks that share an ``edges``
    index.

Collectives go through gloo (parallel/collectives.py): NCCL refuses two
ranks on one device, and ranks share a card where a machine has fewer
cards than ranks (rank ``r`` drives ``cuda:(r % device_count)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

EDGE_AXIS = "edges"
RING_AXIS = "ring"


@dataclass
class Mesh:
    """Where this rank sits.  ``ring_group`` None is the world group."""

    axis_names: tuple
    rank: int
    world: int
    n_ring: int
    ring_rank: int
    ring_group: Optional[object] = None
    device: torch.device = torch.device("cpu")
    # the B11 ring's device buffers (ops/ring.py:RingComm), opened at the
    # first ring SpMM on CUDA tensors and closed by :meth:`close`
    comm: Optional[object] = field(default=None, repr=False)

    @property
    def n_edges(self) -> int:
        return self.world // self.n_ring

    def ring_comm(self, n_local: int, d: int):
        """The rank's B11 ring buffers, big enough for [n_local, d] shards;
        opened (a collective over the ring group) on first use or when a
        wider shard comes."""
        from tip_tpu_torch.ops.ring import RingComm

        if self.comm is not None and not self.comm.fits(n_local, d):
            self.comm.close()
            self.comm = None
        if self.comm is None:
            self.comm = RingComm.open(self.ring_group, self.ring_rank,
                                      self.n_ring, n_local, d, self.device)
        return self.comm

    def close(self) -> None:
        """Release the ring buffers (a collective over the ring group)."""
        if self.comm is not None:
            self.comm.close()
            self.comm = None


def rank_device(rank: int, device_type: str = "cuda") -> torch.device:
    """The device rank ``rank`` drives: ``cuda:(rank % device_count)``, or
    the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; run the ranks on the "
                           "CPU (--cpu)")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _require_group(n: int) -> None:
    if not dist.is_initialized():
        raise RuntimeError("init_process_group first: a mesh spans its ranks")
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {n} ranks over a world of "
                         f"{dist.get_world_size()}")


def make_mesh(n_devices: Optional[int] = None, axis: str = EDGE_AXIS,
              device_type: str = "cuda") -> Mesh:
    """1-D mesh over every rank of the process group."""
    n = dist.get_world_size() if n_devices is None else n_devices
    _require_group(n)
    rank = dist.get_rank()
    return Mesh(axis_names=(axis,), rank=rank, world=n, n_ring=n,
                ring_rank=rank, device=rank_device(rank, device_type))


def make_mesh2(n_ring: int, n_edges: int, device_type: str = "cuda") -> Mesh:
    """2-D ``(ring, edges)`` mesh.  Every rank creates every ring subgroup
    (``new_group`` is collective) and keeps its own."""
    n = n_ring * n_edges
    _require_group(n)
    rank = dist.get_rank()
    group = None
    for e in range(n_edges):
        g = dist.new_group([r * n_edges + e for r in range(n_ring)])
        if rank % n_edges == e:
            group = g
    return Mesh(axis_names=(RING_AXIS, EDGE_AXIS), rank=rank, world=n,
                n_ring=n_ring, ring_rank=rank // n_edges, ring_group=group,
                device=rank_device(rank, device_type))


def mesh_axes(mesh: Mesh):
    """(reduce_axes, ring_axis, n_flat), as the JAX package's: the edge
    sums run over every axis, the P-P ring over the leading one."""
    names = mesh.axis_names
    return (names if len(names) > 1 else names[0]), names[0], mesh.world
