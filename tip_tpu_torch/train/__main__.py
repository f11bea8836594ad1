"""CLI entry: ``python -m tip_tpu_torch.train [--mode cat|add] [...]``.

Runs on the GPU (``cuda``) unless ``--cpu`` is given; without a GPU and
without ``--cpu`` it stops with an error.  ``--synthetic`` trains on a
small random tri-graph; otherwise the Decagon files are read from
``--data-dir`` (or ``$TIP_DATA_DIR``), ``--et-band LOW,HIGH`` keeps the
relations whose symmetric nnz lies in (LOW, HIGH), and the packed graph
comes from the npz cache (data/cache.py: ``$TIP_CACHE_DIR``, else
``~/.cache/tip_tpu_torch``).  ``$JAX_DEFAULT_MATMUL_PRECISION``
set to ``float32`` or ``highest`` asks for exact float32 matmuls, as it does
of the JAX package's CLI: a float32 kernel dtype then takes the float32
pages.  ``--checkpoint-dir``/``--checkpoint-every`` write checkpoints,
``--resume`` continues from one, ``--remat`` recomputes the encoder in
the backward, ``--profile-dir`` records a trace of epochs 2-4
(train/loop.py:train).  ``--backend {auto,xla,pallas}`` routes the sparse
ops as the JAX package's flag does: 'pallas' through the hand-written
kernels on the card (their plain versions with ``--cpu``), 'xla' through
the ports of the JAX package's XLA branches, which launch no kernel;
'auto' is 'pallas' here on every device (train/model.py:resolve_backend
says why it differs from the JAX package's).  ``--report PATH`` writes the named per-relation
metrics (analysis/report.py:write_report; json or csv), with
``type_{id}`` names and the plain summary where the data directory has no name maps.  The
names and Decagon's ranks are read from ``--data-dir``, where the JAX
package's CLI reads them from its default directory whatever
``--data-dir`` says.  ``main`` returns the result of ``train``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from tip_tpu_torch.config import add_config_flags, configs_from_args


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Train TIP on the Decagon tri-graph (PyTorch/CUDA)")
    add_config_flags(parser)
    parser.add_argument("--data-dir", default=None, help="Decagon data dir")
    parser.add_argument(
        "--et-band", default=None, metavar="LOW,HIGH",
        help="train only relations with nnz in (LOW, HIGH) (cut_data "
             "analog)")
    parser.add_argument("--synthetic", action="store_true",
                        help="tiny random graph")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the GPU")
    parser.add_argument("--mono", action="store_true",
                        help="use mono side-effect drug features")
    parser.add_argument(
        "--feat-norm", choices=["ones", "sqrt"], default="ones",
        help="drug-feature row normalization: 'ones' = the reference's "
             "shipped d_norm; 'sqrt' = the square roots of the drug "
             "features' row sums")
    parser.add_argument(
        "--backend", choices=["auto", "xla", "pallas"], default="auto",
        help="sparse-ops route (auto: pallas, the kernels, on every device)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of epochs 2-4 "
                             "here")
    parser.add_argument(
        "--resume", default=None, metavar="DIR_OR_PREFIX",
        help="resume from a checkpoint: a --checkpoint-dir (latest epoch "
             "picked) or a path prefix like runs/ck/ep49")
    parser.add_argument(
        "--split-seed", type=int, default=None,
        help="90/10 split seed (default: the training seed)")
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
    from tip_tpu_torch.train.loop import train
    from tip_tpu_torch.train.model import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg, tcfg = configs_from_args(args)
    split_seed = tcfg.seed if args.split_seed is None else args.split_seed
    if args.synthetic:
        raw = synthetic_trigraph()
        data = build_trigraph(raw, split_rate=tcfg.split_rate,
                              seed=split_seed)
    else:
        raw = load_decagon_band(args.data_dir, args.et_band, args.mono)
        data = cached_trigraph(raw, split_rate=tcfg.split_rate,
                               seed=split_seed)
    if args.feat_norm == "sqrt" and data.drug_feat is not None:
        d_norm = np.sqrt(data.drug_feat.sum(axis=1)).astype(np.float32)
        data = dataclasses.replace(data, d_norm=d_norm)
    _, result = train(cfg, tcfg, data, device=device,
                      matmul_precision=os.environ.get(
                          "JAX_DEFAULT_MATMUL_PRECISION", "default"),
                      resume=args.resume, profile_dir=args.profile_dir,
                      backend=args.backend)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"final": result["final"], "history": result["history"]},
                      f)
    if args.report:
        write_report(args.report, result, raw.et_ids,
                     args.data_dir or DEFAULT_DATA_DIR, rank_comparison=True)
    return result


if __name__ == "__main__":
    main()
