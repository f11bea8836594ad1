"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``tip_tpu_torch/_build/`` (listed in ``.gitignore``) at first use, loaded
with ``ctypes``, and never imported at module import: a machine without
``nvcc`` or a GPU imports this package and runs the plain PyTorch versions.

``KERNELS`` lists every kernel with the TPU kernel it replaces.  Each CUDA
wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel, so a
run can show that its main path went through the kernels
(``reset_launch_counts`` before, ``LAUNCHES`` after).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


@dataclass(frozen=True)
class KernelSpec:
    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel's pl.pallas_call
    route: str = "cuda"


KERNELS = {
    "dense_bce_sym": KernelSpec(
        name="dense_bce_sym",
        source="tip_tpu_torch/csrc/dense_bce_sym.cu",
        replaces="tip_tpu/ops/pallas_dense_bce_sym.py:264",
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


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, built first if missing or older than
    its source."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so, src = _lib_path(name), os.path.join(CSRC, f"{name}.cu")
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            build([name])
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib
