"""Ring SpMM of the row-sharded P-P GCN (kernel B11).

Port of tip_tpu/ops/pallas_ring.py (``ring_spmm_rdma``): on ring rank i,
out_i = sum_s A[rows_i, rows_(i+s) mod k] @ h_(i+s) mod k over the ring
blocks of parallel/ring.py:build_ring_pp, the activation shard moving to
rank (i-1) mod k between steps.  The TPU kernel moves it by remote DMA
inside the kernel; the CUDA kernel (``csrc/ring_spmm.cu``, whose header
says what bounds it and how it is laid out) copies it into the left
neighbour's buffer through a CUDA IPC pointer, one launch a ring step,
with a device-side barrier between neighbours.

:class:`RingComm` holds one rank's buffers: one ``cudaMalloc`` allocation
[flag words | comm slot 0 | comm slot 1] on its device, exported by
``cudaIpcGetMemHandle``; the 64-byte handles are exchanged over the ring's
process group and each rank maps its left and right neighbours'
allocations.  That works between processes on one device (CUDA IPC is how
``torch.multiprocessing`` shares CUDA tensors), so k ranks time-sliced on
one card run the kernel's peer copy and barrier for real, and between
cards of one machine over NVLink.

The plain version is parallel/ring.py:ring_spmm.  CPU tensors take it;
CUDA tensors launch the kernel or raise.  The backward of
:func:`ring_spmm_rdma` is the same op on the cotangent (A_hat is
symmetric), so it launches the kernel again.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from tip_tpu_torch import kernels, trace

KERNEL = "ring_spmm"
# bytes before the comm slots: the step counts from the left and the right
# neighbour (words 0, 1) and the kernel's block counter (word 2)
HEADER = 256
FROM_LEFT, FROM_RIGHT, DONE = 0, 4, 8  # their byte offsets
SLOT_ALIGN = 256
# a neighbour that does not reach the barrier within this time is lost: the
# kernel traps and the launch fails
WAIT_S = 120.0


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{KERNEL}: {what} failed with CUDA error {err}")


def _lib():
    lib = kernels.load(KERNEL)
    if lib.tip_ring_alloc.argtypes is None:
        vp, pvp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        for name, args in (("tip_ring_alloc", [ctypes.c_longlong, pvp]),
                           ("tip_ring_free", [vp]),
                           ("tip_ring_export", [vp, ctypes.c_char_p]),
                           ("tip_ring_import", [ctypes.c_char_p, pvp]),
                           ("tip_ring_close", [vp]),
                           ("tip_ring_handle_bytes", [])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


class RingComm:
    """One ring rank's B11 buffers and its neighbours' mapped ones.

    Pointers are plain ints.  ``left`` is the allocation the kernel copies
    into, ``left_flag``/``right_flag`` the words it bumps (the left
    neighbour's count from its right, the right one's count from its left),
    ``own`` the allocation whose two counts it waits on.  ``steps`` counts
    this rank's ring steps: the k-th waits until each neighbour has
    finished k steps."""

    def __init__(self, device, own: int, slot_bytes: int, n_ring: int,
                 left: int, left_flag: int, right_flag: int,
                 opened=(), extra=(), group=None):
        self.device = device
        self.own, self.slot_bytes, self.n_ring = own, slot_bytes, n_ring
        self.left, self.left_flag, self.right_flag = left, left_flag, right_flag
        self.opened, self.extra, self.group = list(opened), list(extra), group
        self.steps = 0
        self.closed = False

    @staticmethod
    def slot_size(n_local: int, d: int) -> int:
        return -(-n_local * d * 4 // SLOT_ALIGN) * SLOT_ALIGN

    @staticmethod
    def _alloc(device, nbytes: int) -> int:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(_lib().tip_ring_alloc(nbytes, ctypes.byref(ptr)), "cudaMalloc")
        return ptr.value

    @classmethod
    def open(cls, group, ring_rank: int, n_ring: int, n_local: int, d: int,
             device) -> "RingComm":
        """Allocate this rank's buffers on ``device`` and map its ring
        neighbours' (a collective over ``group``, the ring's ranks)."""
        lib = _lib()
        slot = cls.slot_size(n_local, d)
        own = cls._alloc(device, HEADER + 2 * slot)
        handle = ctypes.create_string_buffer(lib.tip_ring_handle_bytes())
        with torch.cuda.device(device):
            _check(lib.tip_ring_export(own, handle), "cudaIpcGetMemHandle")
        handles = [None] * n_ring
        dist.all_gather_object(handles, handle.raw, group=group)
        peers = {}
        for j in {(ring_rank - 1) % n_ring, (ring_rank + 1) % n_ring}:
            if j == ring_rank:  # a ring of one: no neighbour to map
                continue
            ptr = ctypes.c_void_p()
            with torch.cuda.device(device):
                _check(lib.tip_ring_import(handles[j], ctypes.byref(ptr)),
                       "cudaIpcOpenMemHandle")
            peers[j] = ptr.value
        left = peers.get((ring_rank - 1) % n_ring, 0)
        right = peers.get((ring_rank + 1) % n_ring, 0)
        return cls(device, own, slot, n_ring, left, left + FROM_RIGHT,
                   right + FROM_LEFT, opened=peers.values(), group=group)

    @classmethod
    def loopback(cls, n_local: int, d: int, device) -> "RingComm":
        """One process's stand-in ring: the copy goes to a second local
        allocation and the barrier bumps this rank's own two counts, so a
        step runs the copy, the SpMM and the barrier's atomics and passes
        at once (for timing a step)."""
        slot = cls.slot_size(n_local, d)
        own = cls._alloc(device, HEADER + 2 * slot)
        peer = cls._alloc(device, HEADER + 2 * slot)
        return cls(device, own, slot, 2, peer, own + FROM_RIGHT,
                   own + FROM_LEFT, extra=[peer])

    def fits(self, n_local: int, d: int) -> bool:
        return self.slot_size(n_local, d) <= self.slot_bytes

    def slot(self, base: int, j: int) -> int:
        return base + HEADER + j * self.slot_bytes

    def close(self) -> None:
        """Unmap the neighbours' buffers, then free this rank's, each behind
        a barrier of the ring, so no buffer is freed while a neighbour may
        still write to it."""
        if self.closed:
            return
        self.closed = True
        lib = _lib()
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            if self.opened:
                dist.barrier(group=self.group)
                for p in self.opened:
                    _check(lib.tip_ring_close(p), "cudaIpcCloseMemHandle")
                dist.barrier(group=self.group)
            for p in [self.own] + self.extra:
                _check(lib.tip_ring_free(p), "cudaFree")


def ring_step_cuda(h, out, src, dst, w, comm: RingComm, s: int, copy: bool,
                   barrier: bool = True) -> None:
    """Launch ring step ``s`` of csrc/ring_spmm.cu: out += block(src, dst,
    w) @ h (h a tensor, or the raw pointer of a comm slot holding
    [n_local, d]); with ``copy``, h also goes to the left neighbour's slot
    (s + 1) % 2; with ``barrier`` (a ring of two or more), the neighbour
    barrier follows."""
    n_local, d = out.shape
    peer = comm.slot(comm.left, (s + 1) % 2) if copy else 0
    done, flag, left, right = ((comm.own + DONE, comm.own + FROM_LEFT,
                                comm.left_flag, comm.right_flag)
                               if barrier else (0, 0, 0, 0))
    if barrier:
        comm.steps += 1
    kernels.launch(KERNEL, "tip_ring_step", "pppppiiipppppuq", h, peer, src,
                   dst, w, src.shape[0], n_local, d, out, done, flag, left,
                   right, comm.steps & 0xFFFFFFFF, int(WAIT_S * 1e9),
                   device=out.device)


def ring_spmm_cuda(h_own, src_l, dst_l, w, comm: RingComm):
    """The k launches of B11 for one ring SpMM on this rank (k = the
    blocks' leading axis).  Same contract as parallel/ring.py:ring_spmm;
    ``comm`` holds the ring's buffers (:class:`RingComm`)."""
    dev = h_own.device
    if not h_own.is_cuda:
        raise ValueError("ring_spmm_cuda needs CUDA tensors")
    kernels.require(h_own, "h_own", torch.float32, 2, dev)
    for name, x, dt in (("src_l", src_l, torch.int32),
                        ("dst_l", dst_l, torch.int32), ("w", w, torch.float32)):
        kernels.require(x, name, dt, 2, dev)
    k, e_pad = src_l.shape
    n_local, d = h_own.shape
    if dst_l.shape != src_l.shape or w.shape != src_l.shape or e_pad < 1:
        raise ValueError(f"ring blocks do not match: src_l "
                         f"{tuple(src_l.shape)}, dst_l {tuple(dst_l.shape)}, "
                         f"w {tuple(w.shape)}")
    if k > 1 and k != comm.n_ring:
        raise ValueError(f"{k} ring blocks for a ring of {comm.n_ring}")
    if not comm.fits(n_local, d):
        raise ValueError(f"a [{n_local}, {d}] shard does not fit the ring "
                         "buffers")
    if h_own.data_ptr() % 16:  # the copy moves 16 bytes a thread
        h_own = h_own.clone()
    out = torch.zeros((n_local, d), dtype=torch.float32, device=dev)
    for s in range(k):
        h = h_own if s == 0 else comm.slot(comm.own, s % 2)
        ring_step_cuda(h, out, src_l[s], dst_l[s], w[s], comm, s,
                       copy=s < k - 1, barrier=k > 1)
    return out


def _ring(h, src_l, dst_l, w, mesh):
    if h.is_cuda:
        comm = mesh.ring_comm(h.shape[0], h.shape[1])
        return ring_spmm_cuda(h.contiguous(), src_l, dst_l, w, comm)
    if h.device.type != "cpu":
        raise ValueError(f"no ring SpMM for device {h.device}")
    from tip_tpu_torch.parallel.ring import ring_spmm

    with torch.no_grad():
        return ring_spmm(h, src_l, dst_l, w, h.shape[0], mesh)


class _RingSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_own, src_l, dst_l, w, mesh):
        ctx.save_for_backward(src_l, dst_l, w)
        ctx.mesh = mesh
        return _ring(h_own.float(), src_l, dst_l, w, mesh)

    @staticmethod
    @trace.spanned("ring_spmm")
    def backward(ctx, dout):
        # A_hat is symmetric: dh = A_hat^T dout = the same ring on dout
        dh = _ring(dout.float().contiguous(), *ctx.saved_tensors, ctx.mesh)
        return dh, None, None, None, None


def ring_spmm_rdma(h_own, src_l, dst_l, w, mesh):
    """out[rows_i] = sum_s A[rows_i, rows_(i+s)] @ h[rows_(i+s)] on ring
    rank i of ``mesh`` (parallel/mesh.py), kernel B11 on CUDA tensors.

    h_own [n_local, d] float; src_l/dst_l int32 and w float32 [k, E_pad],
    this rank's ring blocks, step-major (parallel/ring.py:build_ring_pp).
    Every ring rank must call it at the same point of its program.
    REQUIRES a symmetric A_hat: the backward runs the same ring on the
    cotangent."""
    return _RingSpmm.apply(h_own, src_l, dst_l, w, mesh)
