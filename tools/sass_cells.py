"""Instructions a cell of the dense loss kernels B1, B2, B3 and B13 costs,
read from the SASS the card's compiler emits.

    python3 tools/sass_cells.py

Builds tip_tpu_torch/csrc/dense_bce_sym.cu (B1), dense_bce.cu (B2),
dense_bce_nn.cu (B3) and dense_bce_dedicom.cu (B13) of this checkout with
nvcc for sm_90a, disassembles each library with ``cuobjdump -sass`` and,
for every instantiation of the cell kernel (B1, B2: ``tile_kernel``; B3:
``page_kernel``; B13: ``dedicom_kernel``), finds the loops (backward
branches) whose body holds cells.  A cell hashes its index with two mix32
calls (bce_cell.cuh), each one multiply by 0x7feb352d, so a loop body with
k such multiplies holds k / 2 cells.  Prints, per instantiation, the
innermost such loop: its instructions, cells, instructions a cell, and its
MUFU, HMMA (mma.sync), HGMMA (wgmma) and integer instruction counts, as
one JSON line.  For B13 also the loop around it (a relation) and the
instructions a thread issues for one relation of a full 128 x 128 tile
(64 cells a thread: the loop around once, the cell loop as often as it
takes), and ptxas's registers, spills and shared memory of every
instantiation (``-Xptxas -v``).  Needs nvcc and cuobjdump, not a GPU.  A
diagnostic, run by hand: it leans on the hash's constant and the
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
KERNELS = ("dense_bce_sym", "dense_bce", "dense_bce_nn", "dense_bce_dedicom")
CELL_KERNELS = ("tile_kernel", "page_kernel", "dedicom_kernel")
TILE_CELLS = 64  # cells a thread of B13 computes for one relation of a full tile
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


def loops(ins: list) -> list:
    """(lo, hi, body) of every backward branch's loop."""
    out = []
    for addr, text in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", text)
        if not m or int(m.group(1), 16) > addr:
            continue
        lo, hi = int(m.group(1), 16), addr
        out.append((lo, hi, [t for a, t in ins if lo <= a <= hi]))
    return out


def counts(body: list, cells: float) -> dict:
    ops = collections.Counter(opcode(t) for t in body)
    return {"instructions": len(body), "cells": cells,
            "per_cell": len(body) / cells,
            "mufu_per_cell": ops["MUFU"] / cells,
            "hmma_per_cell": ops["HMMA"] / cells,
            "hgmma_per_cell": ops["HGMMA"] / cells,
            "int_per_cell": sum(ops[o] for o in INT_OPS) / cells}


def cells_in(body: list) -> float:
    return sum(HASH_MUL in t for t in body) / 2


def cell_loop(ins: list, relation: bool = False):
    """The innermost loop of a function whose body holds cells, as a
    report, or None.  With ``relation``, also the loop around it and the
    instructions of one relation of a full tile."""
    # a cell takes two MUFU (ex2, lg2) at least: a loop of multiplies
    # without them is a set-up loop (B13 keys its relations with mix32)
    found = [(lo, hi, body) for lo, hi, body in loops(ins)
             if cells_in(body) and sum(opcode(t) == "MUFU" for t in body)
             >= cells_in(body)]
    if not found:
        return None
    lo, hi, body = min(found, key=lambda x: len(x[2]))
    cells = cells_in(body)
    rep = {"loop": [hex(lo), hex(hi)], **counts(body, cells)}
    if not relation:
        return rep
    outer = [x for x in found if x[0] <= lo and x[1] >= hi and x[0:2] != (lo, hi)]
    if outer and cells < TILE_CELLS:
        olo, ohi, obody = min(outer, key=lambda x: len(x[2]))
        rest = len(obody) - len(body)
        per_rel = rest + TILE_CELLS / cells * len(body)
        rep["relation_loop"] = {"loop": [hex(olo), hex(ohi)],
                                "instructions_beside_cells": rest}
    else:
        per_rel = TILE_CELLS / cells * len(body)
    rep["relation_instructions"] = per_rel
    rep["relation_per_cell"] = per_rel / TILE_CELLS
    ops = collections.Counter(opcode(t) for a, t in ins)
    rep["function"] = {"instructions": len(ins), "HMMA": ops["HMMA"],
                       "HGMMA": ops["HGMMA"], "MUFU": ops["MUFU"],
                       "BAR": ops["BAR"]}
    return rep


def ptxas_report(log: str) -> dict:
    """{function: registers, spills, shared memory} from ptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(m.group(1)) if m else 0
        if "serialized" in line or "Performance Loss" in line:
            out[name]["warning"] = line.strip()
    return out


def instantiation(name: str) -> str:
    """A readable tag of a mangled kernel name: page type, width, grads."""
    m = re.search(r"(?:tile_kernel|page_kernel|dedicom_kernel)I(.*?)EEEv", name)
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

    logs = kernels.build(KERNELS, verbose=True)
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    out = {}
    for k in KERNELS:
        lib = os.path.join(kernels.BUILD_DIR, f"lib{k}.so")
        sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                              capture_output=True, text=True).stdout
        rep = {}
        ptxas = ptxas_report(logs[k])
        for name, ins in parse(sass).items():
            if any(c in name for c in CELL_KERNELS):
                b13 = "dedicom_kernel" in name
                loop = cell_loop(ins, relation=b13)
                if loop is not None:
                    if b13:
                        loop["ptxas"] = ptxas.get(name, {})
                    rep[instantiation(name)] = loop
        out[k] = rep
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
