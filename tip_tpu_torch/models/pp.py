"""P-P GAE: two-layer GCN encoder + inner-product link decoder.

Port of tip_tpu/models/pp.py: identity protein features -> GCN(n, 32) ->
relu -> GCN(32, 16), score(u, v) = sigmoid(z_u . z_v), BCE against one
untyped uniform negative per positive.  The encoder runs over the dense
int8 (A+I) where it fits and has no duplicate edges (the ``dense``
layout), else over the COO cached normalization (``coo``); ``pp_layout``
decides, for the graph and the model alike.  The dense encode runs kernel
B12 (ops/pp_aggregate.py) under ``backend="pallas"``, the float32 product
of the upcast (A+I) under ``"xla"``; the COO encode is plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tip_tpu_torch.data.packing import TriGraphData, dense_pp_fits
from tip_tpu_torch.metrics import grouped_ranking_metrics, macro_average
from tip_tpu_torch.models.pd import pair_bitmap
from tip_tpu_torch.nn.encoders import (
    pp_encoder_apply,
    pp_encoder_apply_dense,
    pp_encoder_init,
)
from tip_tpu_torch.sampling import bitmap_tensor, typed_negative_sampling
from tip_tpu_torch.ops.dense_bce_sym import softplus
from tip_tpu_torch.train.model import (
    pp_arrays,
    resolve_backend,
    resolve_device,
)


@dataclass(frozen=True)
class PPConfig:
    hid1: int = 32
    hid2: int = 16


def pp_layout(data: TriGraphData) -> str:
    """'dense' where data/packing.py:dense_pp_fits lets the P-P side ship
    the int8 (A+I) (train/model.py:pp_arrays), else 'coo'."""
    return ("dense" if dense_pp_fits(data.pp_norm_index, data.n_prot)
            else "coo")


def make_pp_graph_arrays(data: TriGraphData, device=None):
    """The P-P training graph of :func:`pp_layout` plus the pair bitmaps of
    both splits, on ``device``."""
    n = data.n_prot

    def t(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(device)

    graph = {
        "train_src": t(data.pp_train[0]),
        "train_dst": t(data.pp_train[1]),
        "pair_bitmap": bitmap_tensor(pair_bitmap(data.pp_train, n), device),
    }
    graph.update(pp_arrays(data, device, pp_layout(data) == "dense"))
    test = {
        "src": t(data.pp_test[0]),
        "dst": t(data.pp_test[1]),
        "pair_bitmap": bitmap_tensor(pair_bitmap(data.pp_test, n), device),
    }
    return graph, test


@dataclass(frozen=True)
class PPModel:
    cfg: PPConfig
    n_prot: int
    layout: str  # pp_layout of the graph
    device: torch.device
    backend: str = "pallas"  # train/model.py:resolve_backend

    @staticmethod
    def for_data(cfg: PPConfig, data: TriGraphData, device=None,
                 backend: str = "auto") -> "PPModel":
        if data.n_prot * data.n_prot >= 2**31:
            raise ValueError("protein pair key space exceeds int32")
        return PPModel(cfg=cfg, n_prot=data.n_prot, layout=pp_layout(data),
                       device=resolve_device(device),
                       backend=resolve_backend(backend))

    def init(self, gen: torch.Generator) -> dict:
        return {"encoder": pp_encoder_init(gen, self.n_prot, self.cfg.hid1,
                                           self.cfg.hid2, device=self.device)}

    def encode(self, params, graph):
        if self.layout == "dense":
            return pp_encoder_apply_dense(params["encoder"], None,
                                          graph["pp_a1"], graph["pp_dinv"],
                                          self.backend)
        return pp_encoder_apply(params["encoder"], None, graph["pp_norm_index"],
                                graph["pp_norm_weight"], self.n_prot)

    @staticmethod
    def _logits(z, src, dst):
        return torch.sum(z[src] * z[dst], dim=-1)

    def _sample(self, gen, n_samples: int, bitmap):
        et = torch.zeros(n_samples, dtype=torch.int64, device=bitmap.device)
        return typed_negative_sampling(gen, et, bitmap, self.n_prot)

    def loss(self, params, graph, seed: int):
        """Mean positive BCE + mean negative BCE; ``seed`` keys one untyped
        negative per train edge, drawn on the model's device."""
        z = self.encode(params, graph)
        gen = torch.Generator(device=z.device).manual_seed(seed)
        ns, nd = self._sample(gen, graph["train_src"].shape[0],
                              graph["pair_bitmap"])
        pos = self._logits(z, graph["train_src"], graph["train_dst"])
        neg = self._logits(z, ns, nd)
        return torch.mean(softplus(-pos)) + torch.mean(softplus(neg))

    def sample_test_negatives(self, gen: torch.Generator, test):
        ns, nd = self._sample(gen, test["src"].shape[0], test["pair_bitmap"])
        return {"src": ns, "dst": nd}

    @torch.no_grad()
    def evaluate(self, params, graph, test, test_neg):
        z = self.encode(params, graph)
        pos = torch.sigmoid(self._logits(z, test["src"], test["dst"]))
        neg = torch.sigmoid(self._logits(z, test_neg["src"], test_neg["dst"]))
        et = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
        per = grouped_ranking_metrics(pos, neg, et, 1)
        return per, macro_average(per)
