"""P-D-only model (PR-HMP-NN): hierarchy encoder + per-relation NN decoder.

Port of tip_tpu/models/pd.py: drugs are embedded from their protein
targets alone (protein embedding table -> the P->D mean hierarchy conv),
and D-D side-effect edges are scored with the flat NN decoder.  Negatives
are untyped: one uniform corruption per positive, checked against the
positives of all relations through an any-relation pair bitmap (drawn as
relation 0 of a bitmap over the n^2 (dst, src) keys).  Plain PyTorch: no
kernel runs on this path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tip_tpu_torch.data.packing import TriGraphData, build_key_bitmap
from tip_tpu_torch.metrics import grouped_ranking_metrics, macro_average
from tip_tpu_torch.nn.decoders import nn_decoder_apply, nn_decoder_init
from tip_tpu_torch.nn.encoders import hier_encoder_apply, hier_encoder_init
from tip_tpu_torch.ops.dense_bce_sym import softplus
from tip_tpu_torch.sampling import bitmap_tensor, typed_negative_sampling
from tip_tpu_torch.train.model import resolve_device


@dataclass(frozen=True)
class PDConfig:
    embed_dim: int = 32  # protein embedding (reference: test/pd_net.py:58)
    target_dim: int = 16  # drug dim out of the hierarchy conv
    l1_dim: int = 8  # NN decoder hidden (reference: test/pd_net.py:86)


def pair_bitmap(edge_index: np.ndarray, n_nodes: int) -> np.ndarray:
    """Bitmap of the (dst * n + src) keys of an edge list, any relation."""
    src, dst = edge_index.astype(np.int64)
    return build_key_bitmap(np.unique(dst * n_nodes + src), n_nodes * n_nodes)


def make_pd_graph_arrays(data: TriGraphData, device=None):
    """Flat arrays (no padding or chunking: the model is small) plus the
    any-relation pair bitmaps of both splits, on ``device``."""
    n = data.n_drug

    def t(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(device)

    graph = {
        "dp_src": t(data.dp_edge_index[0]),
        "dp_dst": t(data.dp_edge_index[1]),
        "dp_deg": torch.from_numpy(data.dp_drug_deg).to(device),
        "dd_src": t(data.dd_train.edge_index[0]),
        "dd_dst": t(data.dd_train.edge_index[1]),
        "dd_et": t(data.dd_train.edge_type),
        "pair_bitmap": bitmap_tensor(pair_bitmap(data.dd_train.edge_index, n),
                                     device),
    }
    test = {
        "src": t(data.dd_test.edge_index[0]),
        "dst": t(data.dd_test.edge_index[1]),
        "et": t(data.dd_test.edge_type),
        "pair_bitmap": bitmap_tensor(pair_bitmap(data.dd_test.edge_index, n),
                                     device),
    }
    return graph, test


@dataclass(frozen=True)
class PDModel:
    cfg: PDConfig
    n_drug: int
    n_prot: int
    n_et: int
    device: torch.device

    @staticmethod
    def for_data(cfg: PDConfig, data: TriGraphData, device=None) -> "PDModel":
        return PDModel(cfg=cfg, n_drug=data.n_drug, n_prot=data.n_prot,
                       n_et=data.n_et, device=resolve_device(device))

    def init(self, gen: torch.Generator) -> dict:
        cfg, dev = self.cfg, self.device
        return {
            "encoder": hier_encoder_init(gen, self.n_prot, cfg.embed_dim,
                                         cfg.target_dim, device=dev),
            "decoder": nn_decoder_init(gen, cfg.target_dim, self.n_et,
                                       cfg.l1_dim, device=dev),
        }

    def encode(self, params, graph):
        return hier_encoder_apply(params["encoder"], graph, self.n_drug)

    def _sample(self, gen, n_samples: int, bitmap):
        # untyped: relation 0 over the any-relation pair bitmap
        et = torch.zeros(n_samples, dtype=torch.int64, device=bitmap.device)
        return typed_negative_sampling(gen, et, bitmap, self.n_drug)

    def loss(self, params, graph, seed: int):
        """Mean positive BCE + mean negative BCE; ``seed`` keys one untyped
        negative per train edge, drawn on the model's device."""
        z = self.encode(params, graph)
        gen = torch.Generator(device=z.device).manual_seed(seed)
        ns, nd = self._sample(gen, graph["dd_src"].shape[0],
                              graph["pair_bitmap"])
        dec = params["decoder"]
        pos = nn_decoder_apply(dec, z, graph["dd_src"], graph["dd_dst"],
                               graph["dd_et"], sigmoid=False)
        neg = nn_decoder_apply(dec, z, ns, nd, graph["dd_et"], sigmoid=False)
        return torch.mean(softplus(-pos)) + torch.mean(softplus(neg))

    def sample_test_negatives(self, gen: torch.Generator, test):
        ns, nd = self._sample(gen, test["src"].shape[0], test["pair_bitmap"])
        return {"src": ns, "dst": nd}

    @torch.no_grad()
    def evaluate(self, params, graph, test, test_neg):
        z = self.encode(params, graph)
        dec = params["decoder"]
        pos = nn_decoder_apply(dec, z, test["src"], test["dst"], test["et"])
        neg = nn_decoder_apply(dec, z, test_neg["src"], test_neg["dst"],
                               test["et"])
        per_rel = grouped_ranking_metrics(pos, neg, test["et"], self.n_et)
        return per_rel, macro_average(per_rel)
