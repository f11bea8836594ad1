"""Faults planted under the timed path, to show that the comparison that
decides ``correct`` fails them (tipbench/tests, tipbench/calibrate.py).
Each takes the step object and the packed graph after set-up and returns
what undoes it.

* ``unchanged``: the optimizer's step returns the state unchanged.
* ``half_batch``: the loss leaves out the train edges of the upper half of
  the relations and takes the mean over the rest.
* ``altered``: one answer altered where it is produced: the encoder's
  output row of drug 0 comes out zero.
* ``altered_metric``: the evaluation's answer altered where it is
  produced: relation 0's AUPRC comes out 0.01 higher.
"""

from __future__ import annotations

from unittest import mock

import torch


def _shadow(model, name: str, make):
    """``model.<name>`` replaced by ``make(method)`` (an instance attribute
    of the frozen dataclass shadows its method); returns the undo."""
    object.__setattr__(model, name, make(getattr(model, name)))
    return lambda: object.__delattr__(model, name)


def unchanged(ts, data):
    step = ts.opt.step
    ts.opt.step = lambda *a, **k: None

    def undo():
        ts.opt.step = step
    return undo


def altered(ts, data):
    def make(encode):
        def wrong(*args, **kwargs):
            z = encode(*args, **kwargs)
            keep = torch.ones(z.shape[0], 1, dtype=z.dtype, device=z.device)
            keep[0] = 0
            return z * keep
        return wrong
    return _shadow(ts.model, "encode", make)


def half_batch(ts, data):
    """The loss over relations [0, R/2) only, divided by their edges."""
    r = data.n_et
    h = r // 2
    kept = int(data.dd_train.range_list[h - 1][1])
    scale = data.dd_train.n_edges / kept
    layout = ts.model.gs.dd_layout
    if layout == "chunked":
        ct = ts.graph["dd_chunk_type"].long()
        chunk = ts.graph["dd_src2d"].shape[1]
        keep = (ct < h).repeat_interleave(chunk).to(ts.graph["dd_valid"].dtype)

        def make(loss):
            def half(params, graph, seed, **kw):
                graph = dict(graph, dd_valid=graph["dd_valid"] * keep)
                return loss(params, graph, seed, **kw) * scale
            return half
        return _shadow(ts.model, "loss", make)
    target = {"strips": "tip_tpu_torch.train.model.dense_bce_sym_sum",
              "pages": "tip_tpu_torch.train.model.dense_bce_sum",
              "strips_pages": "tip_tpu_torch.models.dd.dense_bce_nn_sum"}[
                  layout]
    module, name = target.rsplit(".", 1)
    orig = getattr(__import__(module, fromlist=[name]), name)

    if layout == "strips_pages":
        def half(w1, w2, h1, h2, pages, q, seed, u24=None):
            return orig(w1[:h], w2[:h], h1, h2, pages[:h], q[:h], seed) * scale
    else:
        def half(w, z, pages, q, seed, u24=None):
            return orig(w[:h], z, pages[:h], q[:h], seed) * scale

    patch = mock.patch(target, half)
    patch.start()
    return patch.stop


def altered_metric(ts, data):
    def make(evaluate):
        def wrong(*args, **kwargs):
            per_rel, avg = evaluate(*args, **kwargs)
            auprc = per_rel["auprc"].clone()
            auprc[0] += 0.01
            return dict(per_rel, auprc=auprc), avg
        return wrong
    return _shadow(ts.model, "evaluate", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "altered_metric": altered_metric}
