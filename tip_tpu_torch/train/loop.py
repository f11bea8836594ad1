"""Training loop: Adam on full-graph steps, periodic and final evaluation,
per-step timing (port of tip_tpu/train/loop.py:135-252).

``torch.optim.Adam`` places eps as optax.adam does (outside the square
root of the bias-corrected second moment).  Each step's negative field is
keyed by a seed that is a pure function of (TrainConfig.seed, epoch), as
the JAX loop folds the epoch into its key.  Losses stay on the device
until a sync point (``sync_every``), so only those steps wait for the
device.  Checkpoint save, restore and resume are a later slice.
"""

from __future__ import annotations

import json
import time
from typing import Callable

import numpy as np
import torch

from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.convert import leaves
from tip_tpu_torch.data.packing import TriGraphData
from tip_tpu_torch.ops.matmul import set_matmul_precision
from tip_tpu_torch.train.model import (
    TIP,
    make_graph_arrays,
    make_test_arrays,
    preferred_dense_dtype,
    resolve_device,
)


def step_seed(seed: int, epoch: int) -> int:
    """The negative-field seed of one epoch (uint32)."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def train(cfg: ModelConfig, tcfg: TrainConfig, data: TriGraphData,
          log: Callable[[str], None] = print, device=None,
          matmul_precision: str = "default"):
    """Train TIP on a packed tri-graph on ``device`` (default ``cuda``;
    raises without a GPU unless ``device='cpu'``).  The D-D layout is the
    one ``preferred_dense_dtype`` picks for ``cfg.kernel_dtype`` and
    ``matmul_precision`` (which stands for the JAX package's
    ``jax_default_matmul_precision``: "float32" or "highest" with a
    float32 kernel dtype asks for the float32 pages).  The graph is packed
    for ``cfg.decoder`` (the NN decoder's: the encoder's layout and the
    chunk buffers of its sampled loss).  Returns
    (params, {"final", "history", "per_relation"})."""
    dev = resolve_device(device)
    if tcfg.checkpoint_dir or tcfg.remat:
        raise NotImplementedError("checkpoint_dir and remat: checkpointing "
                                  "and rematerialisation are later slices")
    set_matmul_precision()
    dense_dtype = preferred_dense_dtype(data, cfg.kernel_dtype,
                                        matmul_precision)
    graph, gs = make_graph_arrays(data, dev, dense_dtype=dense_dtype,
                                  sampled=cfg.negatives == "sampled",
                                  decoder=cfg.decoder)
    model = TIP.for_data(cfg, data, gs, dev)
    test = make_test_arrays(data, dev)

    gen = torch.Generator().manual_seed(tcfg.seed)
    params = model.init(gen)
    for p in leaves(params):
        p.requires_grad_(True)
    test_neg = model.sample_test_negatives(gen, test)
    opt = torch.optim.Adam(leaves(params), lr=tcfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)

    history, pending = [], []  # pending: (epoch, device loss, sec)

    def sync_pending():
        for ep, dl, dt in pending:
            lv = float(dl)
            if not np.isfinite(lv):
                log(json.dumps({"epoch": ep, "loss": lv,
                                "error": "non-finite loss; stopping"}))
                raise FloatingPointError(f"non-finite loss {lv} at epoch {ep}")
            rec = {"epoch": ep, "loss": lv, "sec": round(dt, 4)}
            history.append(rec)
            if tcfg.log_every and ep % tcfg.log_every == 0:
                log(json.dumps(rec))
        pending.clear()

    def evaluate():
        return model.evaluate(params, graph, test, test_neg)

    t_start = time.time()
    for epoch in range(tcfg.epochs):
        t0 = time.time()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, graph, step_seed(tcfg.seed, epoch))
        loss.backward()
        opt.step()
        loss = loss.detach()
        sync = tcfg.sync_every <= 1 or (epoch + 1) % tcfg.sync_every == 0
        if sync:
            loss = float(loss)  # waits for the device: honest step time
        pending.append((epoch, loss, time.time() - t0))
        if sync:
            sync_pending()
        if tcfg.eval_every and (epoch + 1) % tcfg.eval_every == 0:
            sync_pending()
            _, avg = evaluate()
            history[-1].update({k: round(float(v), 4) for k, v in avg.items()})
    sync_pending()

    per_rel, avg = evaluate()
    final = {k: float(v) for k, v in avg.items()}
    final["train_time_sec"] = time.time() - t_start
    log("On test set: auprc:{auprc:.4f}   auroc:{auroc:.4f}   "
        "ap@50:{ap:.4f}".format(**final))
    return params, {
        "final": final,
        "history": history,
        "per_relation": {k: v.cpu().numpy() for k, v in per_rel.items()},
    }
