"""One training runner for the non-TIP model families (port of
tip_tpu/models/runner.py): ``python -m tip_tpu_torch.models --variant
{dr-df,dr-nn,pr-hmp-nn,pp-gae}`` reproduces the reference's four-variant
table.

The loop is train/loop.py's: ``torch.optim.Adam`` with optax's eps
placement, each epoch's negatives keyed by ``step_seed(seed, epoch)``, a
device sync on every step's loss (honest step times) and
``FloatingPointError`` on a non-finite loss.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from tip_tpu_torch.convert import leaves
from tip_tpu_torch.data.packing import TriGraphData
from tip_tpu_torch.models.dd import DDConfig, DDModel, make_dd_graph_arrays
from tip_tpu_torch.models.pd import PDConfig, PDModel, make_pd_graph_arrays
from tip_tpu_torch.models.pp import PPConfig, PPModel, make_pp_graph_arrays
from tip_tpu_torch.ops.matmul import set_matmul_precision
from tip_tpu_torch.train.loop import step_seed
from tip_tpu_torch.train.model import (
    make_test_arrays,
    preferred_dense_dtype,
    resolve_backend,
    resolve_device,
)

VARIANTS = ("dr-df", "dr-nn", "pr-hmp-nn", "pp-gae")


def build_variant(variant: str, data: TriGraphData, device=None,
                  kernel_dtype: str = "float32",
                  matmul_precision: str = "default",
                  dims: Optional[dict] = None, backend: str = "auto"):
    """(model, graph, test) of one reference experiment variant on
    ``device`` (default ``cuda``; raises without a GPU unless 'cpu').
    ``backend`` (train/model.py:resolve_backend) routes DR-DF's and DR-NN's
    sparse ops: 'pallas' (the default 'auto') through the kernels, 'xla'
    through the JAX package's XLA branches; PR-HMP-NN and PP-GAE run no
    kernel either way.

    ``dims`` overrides DDConfig's dimension fields (n_embed, n_hid1, n_hid2,
    num_base) for dr-df / dr-nn.  Their graph takes the layout
    ``preferred_dense_dtype`` picks for ``kernel_dtype`` and
    ``matmul_precision`` (the JAX package's
    ``jax_default_matmul_precision``): the strips within the dense budget,
    the float32 pages where float32 matmuls are pinned or a count passes
    256, the chunked buffers beyond the budget."""
    dev = resolve_device(device)
    if variant in ("dr-df", "dr-nn"):
        cfg = DDConfig(decoder="distmult" if variant == "dr-df" else "nn",
                       kernel_dtype=kernel_dtype, **(dims or {}))
        dense_dtype = preferred_dense_dtype(data, kernel_dtype,
                                            matmul_precision)
        graph, gs = make_dd_graph_arrays(
            data, dev, dense_dtype=dense_dtype, decoder=cfg.decoder,
            sampled=cfg.negatives == "sampled")
        return (DDModel.for_data(cfg, gs, dev, backend=backend), graph,
                make_test_arrays(data, dev))
    resolve_backend(backend)  # validated; the flat models have one route
    if variant == "pr-hmp-nn":
        graph, test = make_pd_graph_arrays(data, dev)
        return PDModel.for_data(PDConfig(), data, dev), graph, test
    if variant == "pp-gae":
        graph, test = make_pp_graph_arrays(data, dev)
        return PPModel.for_data(PPConfig(), data, dev), graph, test
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def train_variant(model, graph, test, epochs: int = 100, lr: float = 0.01,
                  seed: int = 1111, log: Optional[Callable[[str], None]] = print,
                  eval_every: int = 0):
    """Adam full-graph loop (reference: model/ddm-nn.py:199-229) on the
    model's device; returns (params, {"final", "history", "per_relation"})."""
    set_matmul_precision()
    gen = torch.Generator().manual_seed(seed)
    params = model.init(gen)
    for p in leaves(params):
        p.requires_grad_(True)
    test_neg = model.sample_test_negatives(gen, test)
    opt = torch.optim.Adam(leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    history = []
    t_start = time.time()
    for epoch in range(epochs):
        t0 = time.time()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, graph, step_seed(seed, epoch))
        loss.backward()
        opt.step()
        loss = float(loss.detach())  # waits for the device: honest step time
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at epoch {epoch}")
        rec = {"epoch": epoch, "loss": loss, "sec": round(time.time() - t0, 4)}
        if eval_every and (epoch + 1) % eval_every == 0:
            _, avg = model.evaluate(params, graph, test, test_neg)
            rec.update({k: round(float(v), 4) for k, v in avg.items()})
        history.append(rec)
        if log:
            log(json.dumps(rec))
    per_rel, avg = model.evaluate(params, graph, test, test_neg)
    final = {k: float(v) for k, v in avg.items()}
    final["train_time_sec"] = time.time() - t_start
    if log:
        log("On test set: auprc:{auprc:.4f}   auroc:{auroc:.4f}   "
            "ap@50:{ap:.4f}".format(**final))
    return params, {
        "final": final,
        "history": history,
        "per_relation": {k: v.cpu().numpy() for k, v in per_rel.items()},
    }
