"""Training loop: Adam on full-graph steps, periodic and final evaluation,
per-step timing, checkpoints and resume, and a profiler hook (port of
tip_tpu/train/loop.py).

``torch.optim.Adam`` places eps as optax.adam does (outside the square
root of the bias-corrected second moment).  Each step's negative field is
keyed by a seed that is a pure function of (TrainConfig.seed, epoch), as
the JAX loop folds the epoch into its key, so a resumed run replays the
seeds of an uninterrupted one.  Losses stay on the device until a sync
point (``sync_every``), so only those steps wait for the device.

Checkpoints are ``{path}.npz`` in the JAX package's npz layout (its
fallback where orbax is missing; orbax itself imports jax): ``step``,
``p{i}`` the params' leaves in :func:`convert.leaves` order (the
sorted-key flatten order of ``jax.tree``), ``o{i}`` Adam's state in the
flatten order of ``optax.adam(lr).init(params)``: count, then the mu
leaves, then the nu leaves (convert.py maps them onto
``torch.optim.Adam``'s step, exp_avg and exp_avg_sq).  So a checkpoint of
either package restores in the other.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.convert import (
    adam_from_optax_leaves,
    adam_to_optax_leaves,
    leaves,
)
from tip_tpu_torch.data.packing import TriGraphData
from tip_tpu_torch.ops.matmul import set_matmul_precision
from tip_tpu_torch.train.model import (
    TIP,
    make_graph_arrays,
    make_test_arrays,
    preferred_dense_dtype,
    resolve_device,
)

PROFILE_EPOCHS = (2, 4)  # the first and last epoch the profiler records
TRACE_FILE = "trace.json"  # the Chrome trace under profile_dir


@dataclass
class TrainState:
    """Parameters (nested dicts of tensors), the Adam over their leaves,
    and the number of steps taken."""

    params: dict
    opt: torch.optim.Adam
    step: int = 0


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write params, Adam's state and the step to ``{path}.npz`` (the
    module docstring's layout)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pflat = [p.detach().cpu().numpy() for p in leaves(state.params)]
    oflat = adam_to_optax_leaves(state.opt, state.params)
    np.savez(f"{path}.npz", step=state.step,
             **{f"p{i}": x for i, x in enumerate(pflat)},
             **{f"o{i}": x for i, x in enumerate(oflat)})


def restore_checkpoint(path: str, template: dict, opt=None):
    """Restore (params, step) or, with ``opt``, (params, opt, step) from
    ``{path}.npz``.

    The leaves of ``template`` take the checkpoint's values in place (an
    optimizer built on them keeps its references) and ``template`` is
    returned; a leaf whose shape differs raises ``ValueError``.  ``opt``
    (a ``torch.optim.Adam`` over the template's leaves) takes the saved
    Adam state; a checkpoint without one restores the params and leaves
    ``opt`` fresh, with a warning.  A prefix with only a ``.orbax``
    directory (the JAX package's orbax checkpoint) raises: this package
    cannot read orbax."""
    if not os.path.exists(f"{path}.npz"):
        if os.path.exists(f"{path}.orbax"):
            raise ValueError(f"{path}.orbax is an orbax checkpoint, which "
                             "this package cannot read (orbax imports jax); "
                             "save it as npz (the JAX package does where "
                             "orbax is missing)")
        raise FileNotFoundError(f"no checkpoint at {path}.npz")
    ps = leaves(template)
    with np.load(f"{path}.npz") as zf:
        n_p = sum(k.startswith("p") for k in zf.files)
        if n_p != len(ps):
            raise ValueError(f"checkpoint has {n_p} param leaves, template "
                             f"{len(ps)}; wrong template or checkpoint")
        flat = [zf[f"p{i}"] for i in range(n_p)]
        for have, want in zip(flat, ps):
            if have.shape != tuple(want.shape):
                raise ValueError(f"checkpoint leaf shape {have.shape} != "
                                 f"template {tuple(want.shape)}; wrong "
                                 "template or checkpoint")
        oflat = [zf[f"o{i}"] for i in range(
            sum(k.startswith("o") for k in zf.files))]
        step = int(zf["step"])
    with torch.no_grad():
        for have, p in zip(flat, ps):
            p.copy_(torch.from_numpy(have))
    if opt is None:
        return template, step
    opt.state.clear()
    if oflat:
        adam_from_optax_leaves(opt, template, oflat)
    else:
        warnings.warn(f"{path}.npz holds no optimizer state: the params are "
                      "restored and Adam starts fresh")
    return template, opt, step


def latest_checkpoint(ckpt_dir: str) -> str:
    """Newest checkpoint path-prefix in a directory ('ep{N}' by N, else
    'final'); accepts a direct prefix path too."""
    if any(os.path.exists(f"{ckpt_dir}{ext}") for ext in (".orbax", ".npz")):
        return ckpt_dir
    eps = []
    for name in os.listdir(ckpt_dir):
        base = name.removesuffix(".orbax").removesuffix(".npz")
        if base.startswith("ep") and base[2:].isdigit():
            eps.append((int(base[2:]), base))
    if eps:
        return os.path.join(ckpt_dir, max(eps)[1])
    final = os.path.join(ckpt_dir, "final")
    if any(os.path.exists(f"{final}{ext}") for ext in (".orbax", ".npz")):
        return final
    raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")


def step_seed(seed: int, epoch: int) -> int:
    """The negative-field seed of one epoch (uint32)."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def train(cfg: ModelConfig, tcfg: TrainConfig, data: TriGraphData,
          log: Callable[[str], None] = print, device=None,
          matmul_precision: str = "default", resume: Optional[str] = None,
          profile_dir: Optional[str] = None, backend: str = "auto"):
    """Train TIP on a packed tri-graph on ``device`` (default ``cuda``;
    raises without a GPU unless ``device='cpu'``).  The D-D layout is the
    one ``preferred_dense_dtype`` picks for ``cfg.kernel_dtype`` and
    ``matmul_precision`` (which stands for the JAX package's
    ``jax_default_matmul_precision``: "float32" or "highest" with a
    float32 kernel dtype asks for the float32 pages).  The graph is packed
    for ``cfg.decoder`` (the NN decoder's: the encoder's layout and the
    chunk buffers of its sampled loss).

    ``resume``: a checkpoint path-prefix, or a directory whose latest one
    is taken (:func:`latest_checkpoint`); params, Adam's state and the
    step are restored after the initial draws (the test negatives stay
    the same) and training continues at that epoch.  With
    ``tcfg.checkpoint_dir`` a checkpoint ``ep{epoch}`` is written every
    ``tcfg.checkpoint_every`` epochs and ``final`` at the end, outside the
    steps' timing.  ``tcfg.remat`` recomputes the encoder in the backward.
    ``profile_dir``: a torch.profiler trace of epochs 2-4 (CPU, and CUDA
    on the card), written there as the Chrome trace :data:`TRACE_FILE`
    (stopped at the loop's end where the run has fewer epochs).
    ``backend`` (train/model.py:resolve_backend): 'auto' and 'pallas' run
    the hand-written kernels on the card, 'xla' the JAX package's XLA
    branches (no kernel).  Returns (params, {"final", "history",
    "per_relation"})."""
    dev = resolve_device(device)
    set_matmul_precision()
    dense_dtype = preferred_dense_dtype(data, cfg.kernel_dtype,
                                        matmul_precision)
    graph, gs = make_graph_arrays(data, dev, dense_dtype=dense_dtype,
                                  sampled=cfg.negatives == "sampled",
                                  decoder=cfg.decoder)
    model = TIP.for_data(cfg, data, gs, dev, backend=backend)
    test = make_test_arrays(data, dev)

    gen = torch.Generator().manual_seed(tcfg.seed)
    params = model.init(gen)
    for p in leaves(params):
        p.requires_grad_(True)
    test_neg = model.sample_test_negatives(gen, test)
    opt = torch.optim.Adam(leaves(params), lr=tcfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    state = TrainState(params=params, opt=opt)
    if resume:
        ck = latest_checkpoint(resume)
        _, _, state.step = restore_checkpoint(ck, params, opt)
        log(json.dumps({"resumed_from": ck, "epoch": state.step}))

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

    prof = None

    def stop_profile():
        nonlocal prof
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
            prof = None

    t_start = time.time()
    try:
        for epoch in range(state.step, tcfg.epochs):
            if profile_dir and epoch == PROFILE_EPOCHS[0]:
                os.makedirs(profile_dir, exist_ok=True)
                activities = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            t0 = time.time()
            opt.zero_grad(set_to_none=True)
            loss = model.loss(params, graph, step_seed(tcfg.seed, epoch),
                              remat=tcfg.remat)
            loss.backward()
            opt.step()
            loss = loss.detach()
            sync = tcfg.sync_every <= 1 or (epoch + 1) % tcfg.sync_every == 0
            if sync:
                loss = float(loss)  # waits for the device: honest step time
            pending.append((epoch, loss, time.time() - t0))
            state.step += 1
            if sync:
                sync_pending()
            if epoch == PROFILE_EPOCHS[1]:
                stop_profile()
            if tcfg.eval_every and (epoch + 1) % tcfg.eval_every == 0:
                sync_pending()
                _, avg = evaluate()
                history[-1].update({k: round(float(v), 4)
                                    for k, v in avg.items()})
            if tcfg.checkpoint_dir and tcfg.checkpoint_every and (
                    (epoch + 1) % tcfg.checkpoint_every == 0):
                sync_pending()
                save_checkpoint(os.path.join(tcfg.checkpoint_dir,
                                             f"ep{epoch}"), state)
        sync_pending()
    finally:
        stop_profile()

    per_rel, avg = evaluate()
    final = {k: float(v) for k, v in avg.items()}
    final["train_time_sec"] = time.time() - t_start
    log("On test set: auprc:{auprc:.4f}   auroc:{auroc:.4f}   "
        "ap@50:{ap:.4f}".format(**final))
    if tcfg.checkpoint_dir:
        save_checkpoint(os.path.join(tcfg.checkpoint_dir, "final"), state)
    return params, {
        "final": final,
        "history": history,
        "per_relation": {k: v.cpu().numpy() for k, v in per_rel.items()},
    }
