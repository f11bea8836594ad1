"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with plain C entry points (device
helpers that several kernels share sit in ``csrc/*.cuh``).  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``tip_tpu_torch/_build/`` (listed in ``.gitignore``) at first use, loaded
with ``ctypes``, and never imported at module import: a machine without
``nvcc`` or a GPU imports this package and runs the plain PyTorch versions.

``KERNELS`` lists every kernel with the TPU kernel it replaces (B12,
``pp_aggregate``, and B15, ``rgcn_contract``, replace no
``pl.pallas_call``: the XLA dots of the dense P-P GCN and of the R-GCN's
M-first contraction over the strips; B13 and B14, Decagon's DEDICOM loss
and relation convolution, and B16, ``rel_scaled``, CompGCN's
relation-scaled aggregation, replace nothing: the JAX package has neither
model).  Each CUDA wrapper
adds one to ``LAUNCHES[name]`` where it launches its kernel (:func:`launch` does so for it), so a run can show
that its main path went through the kernels (``reset_launch_counts``
before, ``LAUNCHES`` after).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass

from tip_tpu_torch import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SMEM_BYTES = 227 * 1024  # shared memory one block can use on Hopper


@dataclass(frozen=True)
class KernelSpec:
    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel's pl.pallas_call, or of
    # the XLA op a kernel replaces where the JAX package has no kernel
    route: str = "cuda"


KERNELS = {
    "dense_bce_sym": KernelSpec(
        name="dense_bce_sym",
        source="tip_tpu_torch/csrc/dense_bce_sym.cu",
        replaces="tip_tpu/ops/pallas_dense_bce_sym.py:264",
    ),
    "dense_bce": KernelSpec(
        name="dense_bce",
        source="tip_tpu_torch/csrc/dense_bce.cu",
        replaces="tip_tpu/ops/pallas_dense_bce.py:225",
    ),
    "typed_neighbor_sum": KernelSpec(
        name="typed_neighbor_sum",
        source="tip_tpu_torch/csrc/typed_neighbor_sum.cu",
        replaces="tip_tpu/ops/pallas_segment.py:112",
    ),
    "gcn_spmm": KernelSpec(
        name="gcn_spmm",
        source="tip_tpu_torch/csrc/gcn_spmm.cu",
        replaces="tip_tpu/ops/pallas_segment.py:263",
    ),
    "distmult_sddmm": KernelSpec(
        name="distmult_sddmm",
        source="tip_tpu_torch/csrc/distmult_sddmm.cu",
        replaces="tip_tpu/ops/pallas_sddmm2.py:133",
    ),
    "typed_neg_sampler": KernelSpec(
        name="typed_neg_sampler",
        source="tip_tpu_torch/csrc/typed_neg_sampler.cu",
        replaces="tip_tpu/ops/pallas_sampler.py:262",
    ),
    "dense_bce_nn": KernelSpec(
        name="dense_bce_nn",
        source="tip_tpu_torch/csrc/dense_bce_nn.cu",
        replaces="tip_tpu/ops/pallas_dense_bce_nn.py:163",
    ),
    "nn_sddmm": KernelSpec(
        name="nn_sddmm",
        source="tip_tpu_torch/csrc/nn_sddmm.cu",
        replaces="tip_tpu/ops/pallas_sddmm2.py:324",
    ),
    "distmult_sddmm_v1": KernelSpec(
        name="distmult_sddmm_v1",
        source="tip_tpu_torch/csrc/distmult_sddmm_v1.cu",
        replaces="tip_tpu/ops/pallas_segment.py:354",
    ),
    "nn_sddmm_v1": KernelSpec(
        name="nn_sddmm_v1",
        source="tip_tpu_torch/csrc/nn_sddmm_v1.cu",
        replaces="tip_tpu/ops/pallas_segment.py:534",
    ),
    "ring_spmm": KernelSpec(
        name="ring_spmm",
        source="tip_tpu_torch/csrc/ring_spmm.cu",
        replaces="tip_tpu/ops/pallas_ring.py:124",
    ),
    "pp_aggregate": KernelSpec(
        name="pp_aggregate",
        source="tip_tpu_torch/csrc/pp_aggregate.cu",
        replaces="tip_tpu/nn/gcn.py:70",
    ),
    "dense_bce_dedicom": KernelSpec(
        name="dense_bce_dedicom",
        source="tip_tpu_torch/csrc/dense_bce_dedicom.cu",
        replaces="none (no Decagon model in the JAX package)",
    ),
    "rel_aggregate": KernelSpec(
        name="rel_aggregate",
        source="tip_tpu_torch/csrc/rel_aggregate.cu",
        replaces="none (no Decagon model in the JAX package)",
    ),
    "rgcn_contract": KernelSpec(
        name="rgcn_contract",
        source="tip_tpu_torch/csrc/rgcn_contract.cu",
        replaces="tip_tpu/nn/rgcn.py:203",
    ),
    "rel_scaled": KernelSpec(
        name="rel_scaled",
        source="tip_tpu_torch/csrc/rel_scaled.cu",
        replaces="none (no CompGCN model in the JAX package)",
    ),
}

LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_libs: dict = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from tip_tpu_torch/csrc at first use")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named kernels (all by default), one ``nvcc`` per source,
    all started together.  Returns {name: compiler stderr}; with
    ``verbose`` that holds ptxas's register and shared-memory report."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        src = os.path.join(CSRC, f"{name}.cu")
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, src]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        logs[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}{err}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def _newest_source(name: str) -> float:
    """mtime of the kernel's source or of any shared header it may include."""
    paths = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in paths)


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, built first if missing or older than
    its sources."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        with trace.span("kernel_load"):
            so = _lib_path(name)
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < _newest_source(name)):
                build([name])
            lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
           "u": ctypes.c_uint, "f": ctypes.c_float}


def sm_count(device) -> int:
    """Streaming multiprocessors of the card (the grid of persistent
    kernels)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def require(x, name: str, dtype, ndim: int, device) -> None:
    """Raise unless ``x`` is a contiguous ``ndim``-D ``dtype`` tensor on
    ``device``: what a kernel's C entry point takes."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype or x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D {dtype}, got {x.dim()}-D "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, entry: str, sig: str, *args, device) -> None:
    """Call C entry point ``entry`` of kernel ``name`` on ``device``'s
    current stream and count one launch.  ``sig`` types ``args`` one
    character each: p pointer (a tensor passes its data pointer), i int,
    q int64, u uint32, f float; the stream is appended.  Raises on the
    CUDA error the entry point returns (a refused launch never runs)."""
    import torch

    if len(sig) != len(args):
        raise TypeError(f"{entry}: {len(args)} arguments for signature {sig!r}")
    fn = getattr(load(name), entry)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[ch] for ch in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: {entry} failed with CUDA error {err}")
    count_launch(name)
