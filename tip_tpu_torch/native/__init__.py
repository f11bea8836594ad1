"""The port's native packing library: the host loops of graph packing in
C++ (``tipcore.cpp``), bound with ctypes.

Port of tip_tpu/native/: the same four C functions with the same results
(edge sort by (et, dst, src), membership bitmap, chunk-aligned padded fill,
int32 bincount).  ``data/packing.py`` calls them on the main path; each has
its numpy version beside it here (``*_plain``), which the tests hold it to
bit for bit and which :func:`plain_versions` switches the packing to.

The library is built with ``g++ -O3 -shared -fPIC`` at first use into
``tip_tpu_torch/_build/`` (git-ignored) and rebuilt when older than its
source.  Each building process compiles into a file of its own and renames
it into place (``os.replace``), so processes that start together never
load a half-written library.  A failed build or load raises with the
compiler's message: g++ is a requirement of the port's packing, and there
is no silent numpy fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "tipcore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}
_plain = False

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "tip_sort_edges": [_I32, _I32, _I32, ctypes.c_int64, ctypes.c_int64, _I64],
    "tip_build_bitmap": [_I64, ctypes.c_int64, _U32],
    "tip_pad_typed": [_I32, _I32, _I64, _I64, _I64, ctypes.c_int64, _I32,
                      _I32, _U8],
    "tip_bincount": [_I32, ctypes.c_int64, _I64],
}


def build(source: Optional[str] = None,
          build_dir: Optional[str] = None) -> str:
    """Compile ``source`` (default :data:`SOURCE`) into
    ``build_dir/lib<name>.so`` (default :data:`BUILD_DIR`) through a file
    of this process's own, renamed into place; returns the library's path.
    Raises RuntimeError with g++'s output if it fails."""
    source = SOURCE if source is None else source
    build_dir = BUILD_DIR if build_dir is None else build_dir
    os.makedirs(build_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(build_dir, f"lib{name}.so")
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *GXX_FLAGS, source, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native packing library: {' '.join(cmd)} "
                           f"failed to run: {e}") from e
    if proc.returncode != 0:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise RuntimeError(
            f"native packing library: g++ exited {proc.returncode} on "
            f"{source}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(source: Optional[str] = None,
         build_dir: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library, built first if missing or older than its
    source; one load per (source, build_dir) in a process."""
    source = SOURCE if source is None else source
    build_dir = BUILD_DIR if build_dir is None else build_dir
    key = (os.path.abspath(source), os.path.abspath(build_dir))
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        name = os.path.splitext(os.path.basename(source))[0]
        so = os.path.join(build_dir, f"lib{name}.so")
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(source)):
            so = build(source, build_dir)
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError(f"native packing library: cannot load {so}: "
                               f"{e}") from e
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = None
        _libs[key] = lib
        return lib


@contextlib.contextmanager
def plain_versions():
    """Within the block, the four entry points run their numpy versions
    (for timing the packing both ways; the main path runs the library)."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _require_range(x: np.ndarray, hi: int, what: str) -> None:
    """Raise unless every value of x lies in [0, hi): the C loops index
    and key by them unchecked."""
    x = np.asarray(x)
    if x.size and (int(x.min()) < 0 or int(x.max()) >= hi):
        raise ValueError(f"{what} must lie in [0, {hi}), got "
                         f"[{int(x.min())}, {int(x.max())}]")


def sort_edges_order_plain(et, dst, src, n_nodes: int) -> np.ndarray:
    return np.lexsort((src, dst, et))


def sort_edges_order(et: np.ndarray, dst: np.ndarray, src: np.ndarray,
                     n_nodes: int) -> np.ndarray:
    """Permutation sorting edges by (et, dst, src), ties in index order:
    ``np.lexsort((src, dst, et))``.  int64 [E]."""
    if _plain:
        return sort_edges_order_plain(et, dst, src, n_nodes)
    _require_range(src, n_nodes, "src")
    _require_range(dst, n_nodes, "dst")
    _require_range(et, 2**31, "et")
    et, dst, src = (np.ascontiguousarray(a, np.int32) for a in (et, dst, src))
    e = et.shape[0]
    if not dst.shape[0] == src.shape[0] == e:
        raise ValueError("et, dst and src must have one length")
    order = np.empty(e, np.int64)
    load().tip_sort_edges(_ptr(et, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
                          _ptr(src, ctypes.c_int32), e, n_nodes,
                          _ptr(order, ctypes.c_int64))
    return order


def build_bitmap_plain(keys, key_space: int) -> np.ndarray:
    keys = np.asarray(keys, np.int64)
    bitmap = np.zeros((key_space + 31) // 32, np.uint32)
    words = (keys >> 5).astype(np.int64)
    bits = (keys & 31).astype(np.uint32)
    np.bitwise_or.at(bitmap, words, np.uint32(1) << bits)
    return bitmap


def build_bitmap(keys: np.ndarray, key_space: int) -> np.ndarray:
    """Pack bit positions into a uint32 bitmap [ceil(key_space / 32)]."""
    if _plain:
        return build_bitmap_plain(keys, key_space)
    keys = np.ascontiguousarray(keys, np.int64)
    _require_range(keys, (key_space + 31) // 32 * 32, "keys")  # the words
    bitmap = np.zeros((key_space + 31) // 32, np.uint32)
    load().tip_build_bitmap(_ptr(keys, ctypes.c_int64), keys.shape[0],
                            _ptr(bitmap, ctypes.c_uint32))
    return bitmap


def pad_typed_fill_plain(src, dst, range_list, out_starts, total: int,
                         n_nodes: int):
    psrc = np.zeros(total, np.int32)
    pdst = np.full(total, n_nodes, np.int32)
    valid = np.zeros(total, bool)
    for t in range(range_list.shape[0]):
        s, e = (int(x) for x in range_list[t])
        o = int(out_starts[t])
        psrc[o:o + e - s] = src[s:e]
        pdst[o:o + e - s] = dst[s:e]
        valid[o:o + e - s] = True
    return psrc, pdst, valid


def pad_typed_fill(src: np.ndarray, dst: np.ndarray, range_list: np.ndarray,
                   out_starts: np.ndarray, total: int, n_nodes: int):
    """Padded (src, dst, valid) buffers of ``total`` slots: relation t's
    edges ``range_list[t]`` of (src, dst) at ``out_starts[t]``; src 0, dst
    ``n_nodes`` and valid False elsewhere."""
    if _plain:
        return pad_typed_fill_plain(src, dst, range_list, out_starts, total,
                                    n_nodes)
    src, dst = (np.ascontiguousarray(a, np.int32) for a in (src, dst))
    starts = np.ascontiguousarray(range_list[:, 0], np.int64)
    ends = np.ascontiguousarray(range_list[:, 1], np.int64)
    outs = np.ascontiguousarray(out_starts, np.int64)
    if ((starts < 0) | (ends < starts) | (ends > min(src.size, dst.size))
            | (outs < 0) | (outs + ends - starts > total)).any():
        raise ValueError("pad_typed_fill: a range lies outside its buffer")
    psrc = np.zeros(total, np.int32)
    pdst = np.full(total, n_nodes, np.int32)
    valid = np.zeros(total, np.uint8)
    load().tip_pad_typed(_ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
                         _ptr(starts, ctypes.c_int64),
                         _ptr(ends, ctypes.c_int64),
                         _ptr(outs, ctypes.c_int64), range_list.shape[0],
                         _ptr(psrc, ctypes.c_int32),
                         _ptr(pdst, ctypes.c_int32),
                         _ptr(valid, ctypes.c_uint8))
    return psrc, pdst, valid.view(bool)


def bincount_i32_plain(x, n: int) -> np.ndarray:
    return np.bincount(x, minlength=n).astype(np.int64)


def bincount_i32(x: np.ndarray, n: int) -> np.ndarray:
    """Count of each value of ``x`` (all in [0, n)), int64 [n]."""
    if _plain:
        return bincount_i32_plain(x, n)
    _require_range(np.asarray(x), n, "x")
    xs = np.ascontiguousarray(x, np.int32)
    out = np.zeros(n, np.int64)
    load().tip_bincount(_ptr(xs, ctypes.c_int32), xs.shape[0],
                        _ptr(out, ctypes.c_int64))
    return out
