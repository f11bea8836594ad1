"""Readings that the limits of a cell are set from, in one process on the
card (tipbench/limits/<workload>.json; PERF.md gives the readings and the
limits):

* the program's numbers over many seeds (run.run, a window of no length:
  the warm-up's steps and evaluation against the reference);
* the control's: the plain reference computed with TF32 operands in every
  float32 product (the precision below the stated one) put in the
  program's place, against the reference;
* the planted faults' (lib/faults.py), each seed a run.

    python3 tipbench/calibrate.py --workload <name> --seeds 1,2,3
        [--control-seeds 4,5,6] [--faults half_batch,altered]
        [--fault-seeds 7,8,9]

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tipbench import run  # noqa: E402


def control_numbers(files: dict, seed: int, device, steps: int = 3) -> dict:
    """The control's numbers: the reference with TF32 operands against the
    reference, from the seed's weights and test negatives."""
    from tipbench.lib import check, weights
    from tipbench.lib.generator import make_raw
    from tipbench.reference.follow import draw_test_negatives, follow
    from tipbench.reference.graph import build
    from tipbench.reference.model import model_of

    config, traffic = files["config"], files["traffic"]
    raw = make_raw(traffic["graph"])
    g = build(raw, traffic["split"]["split_rate"], traffic["split"]["seed"])
    gs = SimpleNamespace(n_drug=g.n_drug, n_prot=g.n_prot, n_et=g.n_et,
                         drug_feat_dim=0)
    w0 = weights.make(model_of(config["model"]).param_spec(config, gs), seed,
                      device)
    neg = draw_test_negatives(raw, traffic, seed)
    args = (config["model"], raw, traffic, config["lr"], w0, seed, steps, neg,
            device)
    low, ref = follow(*args, control="tf32"), follow(*args)
    return dict(check.numbers(low, ref), readings=check.readings(low, ref))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from tipbench.lib import faults

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    os.environ["TIP_CACHE_DIR"] = run.CACHE_DIR
    files = run.cell_files(run.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                           args.workload)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    def emit(kind, seed, values, t0):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "s": time.perf_counter() - t0,
                          **values}), flush=True)

    ctx = run.prepare(files, torch.device("cuda"))

    def values(out):
        return dict({k: c["value"] for k, c in out["checks"].items()},
                    readings=out["readings"])

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        emit("program", seed, values(run.run(files, seed, 0.0, False, "cuda",
                                             ctx=ctx)), t0)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        emit("control", seed, control_numbers(files, seed, "cuda"), t0)
    for name in [f for f in args.faults.split(",") if f]:
        for seed in seeds(args.fault_seeds):
            t0 = time.perf_counter()
            emit(name, seed, values(run.run(
                files, seed, 0.0, False, "cuda", plant=faults.FAULTS[name],
                ctx=ctx)), t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
