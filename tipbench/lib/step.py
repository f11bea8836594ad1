"""The training step a cell times, as the entry's loop runs it.

The program has no step function a caller can take (train/loop.py:train
and models/runner.py:train_variant run theirs inline), so this object
repeats their step: ``opt.zero_grad(set_to_none=True)``, the model's
``loss(params, graph, step_seed(seed, k))``, ``backward``,
``torch.optim.Adam.step`` (lr, betas (0.9, 0.999), eps 1e-8, as both
loops build it), and the loss fetched to the host every step
(``sync_every=1``).  ``loss_kwargs``, the traffic file's "train" group,
reaches the model's ``loss`` as keywords (``{"remat": true}`` recomputes
TIP's encoder in the backward, as ``TrainConfig.remat`` makes the loop
do).  ``evaluate`` is the model's own full evaluation,
ending with the per-relation metrics on the host.

Built once in set-up; the warm-up steps and the window drive the same
object.
"""

from __future__ import annotations

import numpy as np
import torch


class TrainStep:
    def __init__(self, model, graph: dict, test: dict, params: dict,
                 lr: float, seed: int, step_seed, leaves,
                 loss_kwargs: dict | None = None):
        self.model, self.graph, self.test = model, graph, test
        self.loss_kwargs = dict(loss_kwargs or {})
        self.params = params
        self.leaves = leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)
        self.opt = torch.optim.Adam(self.leaves, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.seed, self.step_seed = seed, step_seed
        self.test_neg = None
        self.neg_order = None

    def __call__(self, k: int) -> float:
        self.opt.zero_grad(set_to_none=True)
        loss = self.model.loss(self.params, self.graph,
                               self.step_seed(self.seed, k),
                               **self.loss_kwargs)
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def evaluate(self) -> dict:
        per_rel, _ = self.model.evaluate(self.params, self.graph, self.test,
                                         self.test_neg)
        return {k: v.cpu().numpy() for k, v in per_rel.items()}

    def set_test_negatives(self, src, dst, rel) -> None:
        """Place the benchmark's negatives (sorted by relation) at the
        positions of each relation's test edges in the program's test
        arrays; raises where the counts a relation differ."""
        et = self.test["et"].cpu().numpy()
        order = np.argsort(et, kind="stable")
        if not np.array_equal(et[order], rel):
            raise ValueError("the program's test edges a relation differ from "
                             "the split the negatives were drawn for")
        s, d = np.empty_like(src), np.empty_like(dst)
        s[order], d[order] = src, dst
        self.neg_order = order  # negative i sits at position order[i]
        dev = self.test["et"].device
        self.test_neg = {"src": torch.from_numpy(s).to(dev),
                         "dst": torch.from_numpy(d).to(dev)}

    def graph_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.graph.values()
                   if isinstance(t, torch.Tensor))
