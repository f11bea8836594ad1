"""Instructions a cell of the dense loss kernels B1, B2 and B3 costs, read
from the SASS the card's compiler emits.

    python3 tools/sass_cells.py

Builds tip_tpu_torch/csrc/dense_bce_sym.cu (B1), dense_bce.cu (B2) and
dense_bce_nn.cu (B3) of this checkout with nvcc for sm_90a, disassembles
each library with ``cuobjdump -sass`` and, for every instantiation of the cell kernel (B1, B2: ``tile_kernel``;
B3: ``page_kernel``), finds the loops (backward branches) whose body holds
cells.  A cell hashes its index with two mix32 calls (bce_cell.cuh), each
one multiply by 0x7feb352d, so a loop body with k such multiplies holds
k / 2 cells.  Prints, per instantiation, the innermost such loop: its
instructions, cells, instructions a cell, and its MUFU, HMMA and integer
instruction counts, as one JSON line.  Needs nvcc and cuobjdump, not a
GPU.  A diagnostic, run by hand: it leans on the hash's constant and the
compiler's loop shapes, and nothing tests it.
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import re
import subprocess
import sys

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = ("dense_bce_sym", "dense_bce", "dense_bce_nn")
HASH_MUL = "0x7feb352d"  # the first multiply of mix32, twice a cell
INT_OPS = ("IMAD", "LOP3", "SHF", "ISETP", "IADD3", "VIADD", "SEL", "LEA")
_INS = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def parse(sass: str) -> dict:
    """{function name: [(address, instruction text)]}."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = _INS.match(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    words = text.split()
    op = words[1] if words[0].startswith("@") else words[0]
    return op.split(".")[0]


def cell_loop(ins: list):
    """The innermost loop of a function whose body holds cells, as a
    report, or None."""
    best = None
    for addr, text in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", text)
        if not m or int(m.group(1), 16) > addr:
            continue
        lo, hi = int(m.group(1), 16), addr
        body = [t for a, t in ins if lo <= a <= hi]
        cells = sum(HASH_MUL in t for t in body) / 2
        if cells and (best is None or len(body) < best[0]):
            best = (len(body), body, cells, lo, hi)
    if best is None:
        return None
    n, body, cells, lo, hi = best
    ops = collections.Counter(opcode(t) for t in body)
    return {"loop": [hex(lo), hex(hi)], "instructions": n, "cells": cells,
            "per_cell": n / cells,
            "mufu_per_cell": ops["MUFU"] / cells,
            "hmma_per_cell": ops["HMMA"] / cells,
            "int_per_cell": sum(ops[o] for o in INT_OPS) / cells}


def instantiation(name: str) -> str:
    """A readable tag of a mangled kernel name: page type, width, grads."""
    m = re.search(r"(?:tile_kernel|page_kernel)I(.*?)EEEv", name)
    if not m:
        return name
    args = m.group(1)
    ptype = ("bf16" if "bfloat16" in args else "uint8" if args.startswith("h")
             else "float32" if args.startswith("f") else "int8")
    width = re.search(r"Li(\d+)E", args)
    grads = "fused" if args.endswith("Lb1") else "value-only"
    return " ".join([ptype] + ([f"d={width.group(1)}"] if width else [])
                    + [grads])


def main() -> dict:
    sys.path.insert(0, str(CHECKOUT))
    from tip_tpu_torch import kernels

    kernels.build(KERNELS)
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    out = {}
    for k in KERNELS:
        lib = os.path.join(kernels.BUILD_DIR, f"lib{k}.so")
        sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                              capture_output=True, text=True).stdout
        rep = {}
        for name, ins in parse(sass).items():
            if "tile_kernel" in name or "page_kernel" in name:
                loop = cell_loop(ins)
                if loop is not None:
                    rep[instantiation(name)] = loop
        out[k] = rep
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
