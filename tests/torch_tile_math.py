"""Numpy emulation of the arithmetic of the port's dense loss kernels
(tip_tpu_torch/csrc/tile_math.cuh), and the float32 error bound of a sum,
shared by the tests of kernels B1, B2 and B3.

* ``tf32``, ``split``, ``mma``: the 3xTF32 tensor-core products of B1 and
  B2 (mma.sync m16n8k8 TF32 with a float32 accumulator).
* ``softplus_sigmoid``: the cell's softplus(-x) and sigmoid(-x) from one
  exponential, in float32, with the approximate ex2 and lg2 of the card
  perturbed by their documented worst-case errors.
* ``assert_readings``: the three readings of a u24 = 0 parity test (port
  and JAX kernel against a float64 oracle, port against JAX), each a
  float32 result against another within a multiple of the unit roundoff
  times the sum of the absolute values of the terms that make it up (the
  error of a float32 sum is bounded relative to that sum, not to the
  result, which may cancel; ``PLAIN_ULPS``, ``PLAIN_ULPS_NN`` and
  ``JAX_ULPS`` are the multiples), all taken before it raises; a failing
  port reading appends the test's diagnosis (``diagnosis``: a
  recomputation from fresh copies of the inputs, the inputs' digests
  against those taken when the fixture built them, the terms of the
  cell with the largest error, and, against the first call's record
  (``recorded``: the live threads, the process settings and the digests
  of each ATen op's outputs as the call left them), the settings that
  moved and the first op, of those the two calls' op streams align on,
  where the recomputation parts from it).
"""

import hashlib

import numpy as np

U32 = 2.0 ** -24  # unit roundoff of float32
# Error bounds of the parity tests under u24 = 0, in units of U32 * sum
# |terms| of each result.  The port's plain versions against the float64
# oracles, bit-stable over thread counts and MKL's and ATen's CPU kernels:
# they read <= 1.1 on B1's and B2's inputs (PLAIN_ULPS) and <= 6.9 on B3's
# (<= 8.5 under MKL_CBWR=COMPATIBLE; PLAIN_ULPS_NN), so a drift like those
# seen under pytest-xdist (B1's dw at 18.8, B2's value at 61.6 and 65.3:
# MKL's first parallel exp, MKL_VML_OPS below) fails and prints its
# readings and diagnosis.  The JAX interpret kernels against the oracles
# read <= 7.9, and the port against them <= 10.6 (JAX_ULPS).
PLAIN_ULPS = 8
PLAIN_ULPS_NN = 16
JAX_ULPS = 64


def tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away
    from zero (the low 13 bits cleared); a NaN stays a NaN."""
    x = np.asarray(x, np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    r = ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, r)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi)


def mma(a, b, passes: int):
    """a @ b as the kernels' mma.sync m16n8k8 chain computes it: k-steps of
    8, each adding its TF32 products (exact in float32) to a float32
    accumulator; 3 passes (lo*hi, hi*lo, hi*hi: 3xTF32) or 1 (hi*hi)."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in terms:
            acc = (acc + x[:, k:k + 8].astype(np.float64)
                   @ y[k:k + 8].astype(np.float64)).astype(np.float32)
    return acc


# PTX ISA: ex2.approx.ftz.f32 has a maximum relative error of 2^-22 (over
# the whole range), lg2.approx.ftz.f32 a maximum absolute error of 2^-22
# for arguments in [0.5, 2] (1 + e lies in [1, 2]); __fdividef is within
# 2 ulp for a divisor in [1, 2].
EX2_REL = 2.0 ** -22
LG2_ABS = 2.0 ** -22
DIV_REL = 2.0 * 2.0 ** -23


def softplus_sigmoid(x, ex2_sign: int = 0, lg2_sign: int = 0,
                     div_sign: int = 0):
    """(softplus(-x), sigmoid(-x)) in float32 as tile_math.cuh computes them
    from e = exp(-|x|), each approximate instruction moved by ``sign`` times
    its worst-case error (0: the correctly rounded value)."""
    f = np.float32
    x = np.asarray(x, f)
    log2e, ln2 = f(1.4426950408889634), f(0.6931471805599453)
    e = np.exp2(f(-1) * np.abs(x) * log2e).astype(f)
    e = (e * (1.0 + ex2_sign * EX2_REL)).astype(f)
    one_e = (f(1) + e).astype(f)
    lg = (np.log2(one_e.astype(np.float64)) + lg2_sign * LG2_ABS).astype(f)
    sp = (np.maximum(-x, f(0)) + (lg * ln2).astype(f)).astype(f)
    num = np.where(x >= 0, e, f(1)).astype(f)
    sg = (num.astype(np.float64) / one_e * (1.0 + div_sign * DIV_REL)).astype(f)
    return sp, sg


def sum_bound_reading(got, want, sabs):
    """(largest |got - want| in units of U32 * sabs, the element where it
    lies, got, want and sabs there)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    sabs = np.broadcast_to(np.asarray(sabs, np.float64), got.shape)
    err = np.abs(got - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(err == 0, 0.0, err / (U32 * sabs))
    ratio = np.where(np.isnan(ratio), np.inf, ratio)
    at = np.unravel_index(int(np.argmax(ratio)), ratio.shape)
    return float(ratio[at]), tuple(int(i) for i in at), float(got[at]), \
        float(want[at]), float(sabs[at])


def _cpu_model() -> str:
    """The CPU's model name and its bf16/AMX flags, from /proc/cpuinfo."""
    model, flags = "unknown", []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k.strip() == "model name" and model == "unknown":
                    model = v.strip()
                elif k.strip() == "flags":
                    flags = [x for x in v.split()
                             if x == "avx512_bf16" or x.startswith("amx")]
                    break
    except OSError:
        pass
    return f"{model} [{' '.join(flags) or 'no avx512_bf16/amx'}]"


def _denormals() -> str:
    """Whether this thread's float unit flushes denormal results to zero
    (FTZ) and reads denormal inputs as zero (DAZ), probed with numpy."""
    f = np.float32
    with np.errstate(all="ignore"):
        ftz = (np.array([1e-30], f) * f(1e-10))[0] == 0
        daz = (np.array([1e-39], f) * f(1.0))[0] == 0
    return f"FTZ {'on' if ftz else 'off'}, DAZ {'on' if daz else 'off'}"


def _tipcore_state() -> str:
    """Whether the JAX package's native packing library loaded in this
    process, without calling it (its build is not safe to enter twice)."""
    import datetime
    import os
    import sys

    mod = sys.modules.get("tip_tpu.native")
    if mod is None:
        return "tip_tpu.native not imported"
    so = getattr(mod, "_SO", "")
    try:
        age = "written " + datetime.datetime.fromtimestamp(
            os.path.getmtime(so)).strftime("%H:%M:%S.%f")[:-3]
    except OSError:
        age = "absent"
    if getattr(mod, "_lib", None) is not None:
        state = "loaded"
    elif getattr(mod, "_tried", False):
        state = "fell back to numpy"
    else:
        state = "not yet asked for"
    return f"tip_tpu.native {state}; its library {age}"


def process_settings() -> dict:
    """What the port's plain float32 arithmetic may depend on and a freshly
    started machine may set differently: torch's build, threads and CPU
    dispatch, the CPU, the OpenMP/MKL environment, denormal handling, the
    load, and the native library's state.  Reads no tensor."""
    import os

    import torch

    env = {k: v for k, v in sorted(os.environ.items())
           if k.startswith(("OMP_", "MKL_", "KMP_", "GOMP_", "OPENBLAS_"))}
    return {
        "torch": torch.__version__,
        "threads": f"{torch.get_num_threads()} intra-op, "
                   f"{torch.get_num_interop_threads()} inter-op",
        "affinity": f"{len(os.sched_getaffinity(0))} CPUs",
        "CPU capability": torch.backends.cpu.get_cpu_capability(),
        "CPU": _cpu_model(),
        "float32 matmul precision": torch.get_float32_matmul_precision(),
        "OpenMP/MKL env": env or "none set",
        "denormals": _denormals(),
        "load average": " ".join(f"{x:.2f}" for x in os.getloadavg()),
        "native packing": _tipcore_state(),
    }


def _torch_settings(settings=None) -> str:
    settings = process_settings() if settings is None else settings
    return "; ".join(f"{k} {v}" for k, v in settings.items())


def _reading_line(what, got, want, sabs, ulps):
    ratio, at, g, w, s = sum_bound_reading(got, want, sabs)
    flag = "FAIL" if ratio > ulps else "ok"
    return ratio > ulps, (f"{flag} {what}: {ratio:.2f} x U32 x sum|terms| "
                          f"(bound {ulps}) at {at}: {g!r} against {w!r}, "
                          f"sum|terms| {s!r}")


def assert_readings(names, port_out, jax_out, exact, sabs, port_ulps: float,
                    diagnose=None) -> None:
    """The u24 = 0 parity test's three readings of each result: the port's
    plain version against the float64 oracle (``port_ulps``), the JAX
    kernel against the oracle and the port against the JAX kernel
    (JAX_ULPS).  Every reading is taken before anything raises; the
    message lists them all with the process's torch settings and, when a
    port reading fails, the text of ``diagnose()``, run in this same
    process."""
    failed = port_failed = False
    lines = []
    for name, got, want, ex, s in zip(names, port_out, jax_out, exact, sabs):
        for what, a, b, ulps, port in (
                (f"port {name} vs float64", got, ex, port_ulps, True),
                (f"JAX {name} vs float64", want, ex, JAX_ULPS, False),
                (f"port {name} vs JAX", got, want, JAX_ULPS, False)):
            bad, line = _reading_line(what, a, b, s, ulps)
            lines.append(line)
            failed |= bad
            port_failed |= bad and port
    if not failed:
        return
    if port_failed and diagnose is not None:
        lines.append("diagnosis, same process:")
        lines.append(diagnose())
    raise AssertionError("\n".join(lines + [_torch_settings()]))


def digest(x) -> str:
    """A short sha256 of an array's or tensor's bytes, its dtype and shape:
    shows whether an input changed after it was built."""
    import torch

    if isinstance(x, torch.Tensor):
        h = hashlib.sha256(f"{x.dtype}{tuple(x.shape)}".encode())
        x = x.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy()
    else:
        x = np.ascontiguousarray(x)
        h = hashlib.sha256(f"{x.dtype}{x.shape}".encode())
    h.update(x.view(np.uint8).tobytes())
    return h.hexdigest()[:16]


def digests(**arrays) -> dict:
    return {k: digest(v) for k, v in arrays.items()}


def recorded(fn):
    """Run ``fn()`` (the port's first call in a u24 = 0 test) and record,
    through the test (the program has no hook for it): the threads alive
    when it starts (Python's by name, and the process's native count),
    the process settings then (``process_settings``), and every ATen op
    it runs, forward and backward, with the key (data
    pointer, dtype, shape, strides) of each tensor input and output.
    While fn runs, the record neither copies nor reads a tensor: it keeps
    a reference to each op's outputs and digests them once fn has
    returned.  So what it reads is each intermediate's bytes at the end
    of the call, and what it changes is that none of them is freed and
    its memory reused during the call (ROADMAP Queue C).  Returns (fn's
    result, the record) for ``diagnosis(..., first_call=)``."""
    import os
    import threading

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def tensors(tree):
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    def key(t):
        return f"{t.data_ptr():#x} {t.dtype} {tuple(t.shape)} {t.stride()}"

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ops.append((func, [key(t) for t in tensors((args, kwargs))],
                        tensors(out)))
            return out

    record = {"threads": [t.name for t in threading.enumerate()],
              "native_threads": len(os.listdir("/proc/self/task")),
              "settings": process_settings()}
    with Record():
        result = fn()
    record["ops"] = [(str(func), ins, [(key(t), digest(t)) for t in outs])
                     for func, ins, outs in ops]
    return result, record


def _aligned_pairs(a: list, b: list):
    """(i, j) pairs of ops that align between two records' op-name
    streams, in order: the matching blocks of ``difflib.SequenceMatcher``,
    so a prefix or a gap on either side (inputs built inside one call and
    outside the other, an extra op) shifts no later op."""
    import difflib

    sm = difflib.SequenceMatcher(None, [f for f, _, _ in a],
                                 [f for f, _, _ in b], autojunk=False)
    for i, j, n in sm.get_matching_blocks():
        for k in range(n):
            yield i + k, j + k


# The functions torch hands to MKL's vector math library on the CPU (float32
# and float64 tensors; ATen/cpu/vml.h, IMPLEMENT_VML_MKL).  Their first call
# in a process, split across threads, can return one thread's share at
# about half of float32's precision (ROADMAP Queue C); the dense BCEs'
# plain versions call none of them.
MKL_VML_OPS = frozenset((
    "acos", "asin", "atan", "cos", "erf", "erfc", "erfinv", "exp", "log",
    "log10", "log2", "sin", "sqrt", "tan", "tanh", "trunc"))


def mkl_vml_ops(record: dict) -> list:
    """The ops of a record (``recorded``) that torch runs through MKL's
    VML on the CPU, by name (in-place and out= forms included)."""
    return sorted({f for f, _, _ in record["ops"]
                   if f.split(".")[1].rstrip("_") in MKL_VML_OPS})


def op_divergence(first: dict, again: dict) -> str:
    """Where the first call's record (``recorded``) and a recomputation's
    part: the live threads and the process settings, then, over the ops
    that align by name (``_aligned_pairs``; the ops skipped to align them
    are counted), the first op whose outputs, as the call left them,
    differ, with the ops that wrote its inputs; its digests name the
    tensor that moved."""
    lines = [f"threads at the first call: {first['threads']} "
             f"({first['native_threads']} native); at the recomputation: "
             f"{again['threads']} ({again['native_threads']} native)"]
    s0, s1 = first.get("settings", {}), again.get("settings", {})
    lines.append(f"settings at the first call: {_torch_settings(s0)}")
    moved = [f"{k} {s1.get(k)}" for k in s1 if s1.get(k) != s0.get(k)]
    lines.append("at the recomputation: "
                 + ("; ".join(moved) if moved else "the same"))
    a, b = first["ops"], again["ops"]
    pairs = list(_aligned_pairs(a, b))
    lines.append(f"{len(a)} ops in the first call, {len(b)} in the "
                 f"recomputation; {len(pairs)} align, skipped "
                 f"{len(a) - len(pairs)} and {len(b) - len(pairs)} to align")
    for i, j in pairs:
        (fa, ia, oa), (_, _, ob) = a[i], b[j]
        if [d for _, d in oa] != [d for _, d in ob]:
            writers = {}
            for k, (_, _, outs) in enumerate(a[:i]):
                writers.update({kk: k for kk, _ in outs})
            reads = ", ".join(
                f"{kk} (op {writers[kk]})" if kk in writers else kk
                for kk in ia)
            lines.append(
                f"op {i} {fa} (recomputation's op {j}): outputs differ: "
                f"first call {[f'{kk} {d}' for kk, d in oa]}, recomputation "
                f"{[d for _, d in ob]}; it read {reads}")
            break
    else:
        lines.append(f"all {len(pairs)} aligned ops left equal bytes")
    return "\n".join(lines)


def diagnosis(fresh_call, names, exact, sabs, port_ulps, built: dict,
              now: dict, cells=None, first_call=None) -> str:
    """The diagnosis of a failing port reading.

    fresh_call: () -> call: builds fresh copies of the fixture's inputs
        and returns a call of the port on them, made as the first call
        was (the same ops from the first), whose plain outputs come in the
        order of ``names``; only the call is recorded, and its readings
        against the float64 oracle follow.
    built, now: digests of the inputs when the fixture (or the test) built
        them, and the arrays now; which changed.
    cells: optional () -> (float32 terms, float64 terms, labels): arrays of
        each cell's share of the value, recomputed in float32 by torch and
        in float64, and a dict of per-cell arrays (logit, count, page
        value, ...); the cell with the largest error and its terms.
    first_call: optional record of the first call (``recorded``); the
        recomputation is recorded too and ``op_divergence`` of the two
        follows."""
    lines = []
    call = fresh_call()
    if first_call is not None:
        outs, again = recorded(call)
    else:
        outs, again = call(), None
    for name, got, ex, s in zip(names, outs, exact, sabs):
        lines.append(_reading_line(f"recomputed port {name} vs float64", got,
                                   ex, s, port_ulps)[1])
    if again is not None:
        lines.append(op_divergence(first_call, again))
    for k, arr in now.items():
        d = digest(arr)
        lines.append(f"input {k}: digest {d} "
                     + ("unchanged" if d == built[k]
                        else f"CHANGED from {built[k]}"))
    if cells is not None:
        t32, t64, labels = cells()
        err = np.abs(np.asarray(t32, np.float64) - t64)
        at = tuple(int(i) for i in
                   np.unravel_index(int(np.argmax(err)), err.shape))
        terms = ", ".join(
            f"{k} {float(np.broadcast_to(v, err.shape)[at])!r}"
            for k, v in labels.items())
        lines.append(f"cell with the largest float32 error {at}: "
                     f"{float(t32[at])!r} against {float(t64[at])!r}; {terms}")
    return "\n".join(lines)
