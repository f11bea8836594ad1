"""CLI entry: ``python -m tip_tpu_torch.models --variant dr-df [...]``.

Trains and evaluates one of the reference's experiment variants (DR-DF,
DR-NN, PR-HMP-NN, PP-GAE) on the GPU (``cuda``) unless ``--cpu`` is given;
without a GPU and without ``--cpu`` it stops with an error.  ``--synthetic``
trains on a small random tri-graph; otherwise the Decagon files are read
from ``--data-dir`` (or ``$TIP_DATA_DIR``), ``--et-band LOW,HIGH`` keeps the
relations whose symmetric nnz lies in (LOW, HIGH), and the packed graph
comes from the npz cache (data/cache.py).  ``$JAX_DEFAULT_MATMUL_PRECISION``
set to ``float32`` or ``highest`` asks for exact float32 matmuls, as it does
of the JAX package's CLI: DR-DF and DR-NN then take the float32 pages.
``--report PATH`` writes the named per-relation metrics of the D-D variants
(analysis/report.py:write_report; names from ``--data-dir``).
``--backend {auto,xla,pallas}`` routes DR-DF's and DR-NN's sparse ops as
the JAX package's flag does ('auto' is 'pallas', the kernels, on every
device; 'xla' launches none).  ``main`` returns the result of
``train_variant``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from tip_tpu_torch.models.runner import VARIANTS


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Train a TIP model variant (PyTorch/CUDA)")
    parser.add_argument("--variant", required=True, choices=VARIANTS)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=1111)
    parser.add_argument("--eval-every", type=int, default=0)
    parser.add_argument("--data-dir", default=None, help="Decagon data dir")
    parser.add_argument(
        "--et-band", default=None, metavar="LOW,HIGH",
        help="train only relations with nnz in (LOW, HIGH) (cut_data "
             "analog)")
    parser.add_argument("--mono", action="store_true",
                        help="use [identity | mono] drug features "
                             "(reference: model/ddm-*.py mono=True)")
    parser.add_argument(
        "--feat-norm", choices=["ones", "sqrt"], default="ones",
        help="drug-feature row normalization: 'ones' is the reference's "
             "active line (model/ddm-df_rgcn.py:28), which diverges with "
             "mono features; 'sqrt' is its commented alternative (line 29) "
             "that trains")
    dims = parser.add_argument_group(
        "dims", "DDConfig dimension overrides (dr-df / dr-nn only)")
    for flag in ("n-embed", "n-hid1", "n-hid2", "num-base"):
        dims.add_argument(f"--{flag}", type=int, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="tiny random graph")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the GPU")
    parser.add_argument("--backend", choices=["auto", "xla", "pallas"],
                        default="auto")
    parser.add_argument("--kernel-dtype", choices=["float32", "bfloat16"],
                        default="float32")
    parser.add_argument("--out", default=None,
                        help="write final metrics JSON here")
    parser.add_argument(
        "--report", default=None,
        help="write named per-relation metric report (json/csv) here")
    args = parser.parse_args(argv)

    from tip_tpu_torch.analysis.report import write_report
    from tip_tpu_torch.data import (
        build_trigraph, cached_trigraph, synthetic_trigraph,
    )
    from tip_tpu_torch.data.decagon import DEFAULT_DATA_DIR, load_decagon_band
    from tip_tpu_torch.models.runner import build_variant, train_variant
    from tip_tpu_torch.train.model import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.synthetic:
        raw = synthetic_trigraph()
        data = build_trigraph(raw, seed=args.seed)
    else:
        raw = load_decagon_band(args.data_dir, args.et_band, args.mono)
        data = cached_trigraph(raw, seed=args.seed)
    if args.feat_norm == "sqrt" and data.drug_feat is not None:
        data = dataclasses.replace(
            data, d_norm=np.sqrt(data.drug_feat.sum(axis=1)).astype(np.float32))
    dim_over = {name: getattr(args, name)
                for name in ("n_embed", "n_hid1", "n_hid2", "num_base")
                if getattr(args, name) is not None}
    model, graph, test = build_variant(
        args.variant, data, device, kernel_dtype=args.kernel_dtype,
        matmul_precision=os.environ.get("JAX_DEFAULT_MATMUL_PRECISION",
                                        "default"),
        dims=dim_over or None, backend=args.backend)
    _, result = train_variant(model, graph, test, epochs=args.epochs,
                              lr=args.lr, seed=args.seed,
                              eval_every=args.eval_every)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"variant": args.variant, "final": result["final"],
                       "history": result["history"]}, f)
    if args.report and args.variant != "pp-gae":
        write_report(args.report, result, raw.et_ids,
                     args.data_dir or DEFAULT_DATA_DIR, rank_comparison=False)
    return result


if __name__ == "__main__":
    main()
