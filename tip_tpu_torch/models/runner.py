"""One training runner for the non-TIP model families (port of
tip_tpu/models/runner.py): ``python -m tip_tpu_torch.models --variant
{dr-df,dr-nn,pr-hmp-nn,pp-gae}`` reproduces the reference's four-variant
table; ``--variant decagon`` trains Decagon (models/decagon.py) and
``--variant compgcn`` CompGCN (models/compgcn.py: DistMult score, ``mult``
composition, one layer 100 -> 200, kernels B16, B12 and B1's wide
instance over the int8 strips), which the JAX package does not have.

The loop is train/loop.py's (``start_run``, ``train_step``,
``finish_run``): Adam with optax's eps placement, each epoch's negatives
keyed by ``step_seed(seed, epoch)``, a device sync on every step's loss
(honest step times) and ``FloatingPointError`` on a non-finite loss.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np

from tip_tpu_torch import trace
from tip_tpu_torch.data.packing import TriGraphData
from tip_tpu_torch.models.compgcn import (
    CompGCNConfig,
    CompGCNModel,
    make_compgcn_graph_arrays,
)
from tip_tpu_torch.models.dd import DDConfig, DDModel, make_dd_graph_arrays
from tip_tpu_torch.models.decagon import (
    DecagonConfig,
    DecagonModel,
    make_decagon_graph_arrays,
)
from tip_tpu_torch.models.pd import PDConfig, PDModel, make_pd_graph_arrays
from tip_tpu_torch.models.pp import PPConfig, PPModel, make_pp_graph_arrays
from tip_tpu_torch.ops.matmul import set_matmul_precision
from tip_tpu_torch.train.loop import (
    finish_run,
    start_run,
    step_seed,
    train_step,
)
from tip_tpu_torch.train.model import (
    make_test_arrays,
    preferred_dense_dtype,
    resolve_backend,
    resolve_device,
)

VARIANTS = ("dr-df", "dr-nn", "pr-hmp-nn", "pp-gae", "decagon", "compgcn")


def build_variant(variant: str, data: TriGraphData, device=None,
                  kernel_dtype: str = "float32",
                  matmul_precision: str = "default",
                  dims: Optional[dict] = None, backend: str = "auto"):
    """(model, graph, test) of one reference experiment variant on
    ``device`` (default ``cuda``; raises without a GPU unless 'cpu').
    ``backend`` (train/model.py:resolve_backend) routes every variant's
    kernels (PP-GAE's dense encode: kernel B12, or the float32 product of
    the upcast (A+I)); PR-HMP-NN runs no kernel either way.

    ``dims`` overrides DDConfig's dimension fields (n_embed, n_hid1, n_hid2,
    num_base) for dr-df / dr-nn.  Their graph takes the layout
    ``preferred_dense_dtype`` picks for ``kernel_dtype`` and
    ``matmul_precision`` (the JAX package's
    ``jax_default_matmul_precision``).

    decagon: ``dims`` overrides DecagonConfig's n_hid1, n_hid2; the D-D
    side takes the strips' uint8 pages ('strips_pages', kernels B14 and
    B13) within the dense budget, where float32 matmuls are pinned too
    (B14's operand then float32); beyond the budget it raises (no chunked
    route).

    compgcn: ``dims`` overrides CompGCNConfig's init_dim, gcn_dim; the D-D
    side takes the int8 strips ('strips': kernels B16 and B1), which it
    needs: where float32 matmuls are pinned or the graph is past the dense
    budget it raises."""
    dev = resolve_device(device)
    if variant == "compgcn":
        dense_dtype = preferred_dense_dtype(data, kernel_dtype,
                                            matmul_precision)
        if dense_dtype != "bfloat16":
            raise ValueError(
                "CompGCN runs on the int8 strips: this graph takes the "
                f"{dense_dtype or 'chunked'!r} layout (float32 matmuls "
                "pinned, or past the dense budget)")
        graph, gs = make_compgcn_graph_arrays(data, dev)
        model = CompGCNModel.for_data(CompGCNConfig(**(dims or {})), gs, dev,
                                      backend=backend)
        return model, graph, make_test_arrays(data, dev)
    if variant in ("decagon", "dr-df", "dr-nn"):
        dense_dtype = preferred_dense_dtype(data, kernel_dtype,
                                            matmul_precision)
        if variant == "decagon":
            if dense_dtype is None:
                raise ValueError("Decagon runs on the dense D-D layouts; "
                                 "this graph is past the dense budget (the "
                                 "chunked layout has no Decagon route)")
            graph, gs = make_decagon_graph_arrays(data, dev)
            model = DecagonModel.for_data(
                DecagonConfig(**(dims or {})), gs, dev, backend=backend,
                rel_precision="float32" if dense_dtype == "float32"
                else "bfloat16")
        else:
            cfg = DDConfig(decoder="distmult" if variant == "dr-df" else "nn",
                           kernel_dtype=kernel_dtype, **(dims or {}))
            graph, gs = make_dd_graph_arrays(
                data, dev, dense_dtype=dense_dtype, decoder=cfg.decoder,
                sampled=cfg.negatives == "sampled")
            model = DDModel.for_data(cfg, gs, dev, backend=backend)
        return model, graph, make_test_arrays(data, dev)
    resolve_backend(backend)  # validated; PR-HMP-NN has one route
    if variant == "pr-hmp-nn":
        graph, test = make_pd_graph_arrays(data, dev)
        return PDModel.for_data(PDConfig(), data, dev), graph, test
    if variant == "pp-gae":
        graph, test = make_pp_graph_arrays(data, dev)
        return (PPModel.for_data(PPConfig(), data, dev, backend=backend),
                graph, test)
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def train_variant(model, graph, test, epochs: int = 100, lr: float = 0.01,
                  seed: int = 1111, log: Optional[Callable[[str], None]] = print,
                  eval_every: int = 0):
    """Adam full-graph loop (reference: model/ddm-nn.py:199-229) on the
    model's device; returns (params, train/loop.py:finish_run's dict)."""
    spans_before = trace.totals()
    set_matmul_precision()
    params, test_neg, opt = start_run(model, test, seed, lr)

    def evaluate():
        return model.evaluate(params, graph, test, test_neg)

    history = []
    t_start = time.time()
    for epoch in range(epochs):
        t0 = time.time()
        loss = float(train_step(model, opt, params, graph,
                                step_seed(seed, epoch)))  # honest step time
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at epoch {epoch}")
        rec = {"epoch": epoch, "loss": loss, "sec": round(time.time() - t0, 4)}
        if eval_every and (epoch + 1) % eval_every == 0:
            _, avg = evaluate()
            rec.update({k: round(float(v), 4) for k, v in avg.items()})
        history.append(rec)
        if log:
            log(json.dumps(rec))
    return params, finish_run(evaluate, history, t_start, spans_before, log)
