"""Tiny versions of the cells, for the CPU tests: the same files with a
small graph (the program runs its kernels' plain versions on the CPU)."""

from __future__ import annotations

import contextlib
import json
import os
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_GRAPH = {"kind": "synthetic_trigraph", "n_drug": 40, "n_prot": 60,
              "n_et": 5, "pairs_per_et": 60, "n_pp_pairs": 150, "n_dp": 50,
              "seed": 3}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def files(workload: str) -> dict:
    """The cell's files as run.py reads them, on the tiny graph."""
    from tipbench import run

    out = run.cell_files(bench(), workload)
    out["traffic"] = dict(out["traffic"], graph=dict(TINY_GRAPH),
                          trace_steps=2)
    return out


@contextlib.contextmanager
def layout_of(workload: str):
    """A tiny graph fits the dense budget; the chunked cell's program is
    made to find it past the budget, as the full-size graph is."""
    if "chunked" not in workload:
        yield
        return
    with mock.patch("tip_tpu_torch.train.model.dense_rgcn_feasible",
                    lambda *a, **k: False):
        yield
