"""TIP model assembly on the dense bf16 layout: tri-graph encoder, DistMult
decoder, the fused symmetric dense BCE, and evaluation.

Port of tip_tpu/train/model.py:52-67, 116-259 and 277-578, restricted to
the layout ``make_graph_arrays`` ships by default on a feasible graph: the
symmetric int8 strips ``dd_adj_sym`` with their thresholds ``dd_neg_q8``,
and the int8 (A+I) P-P matrix ``pp_a1`` with its diagonal ``pp_dinv``.
Parameters are nested dicts of tensors in the JAX package's layout; every
method is a plain function of (params, graph).  Graphs the JAX package
would route to the float32 full pages, the chunked kernels or the COO
P-P path raise here: those are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.data.packing import (
    TriGraphData,
    dense_pp_feasible,
    dense_pp_parts,
    dense_relation_adj,
    max_multiplicity,
    poisson_neg_thresholds_sym,
    sym_strip_pack,
)
from tip_tpu_torch.metrics import grouped_ranking_metrics, macro_average
from tip_tpu_torch.nn import (
    distmult_apply,
    distmult_init,
    fm_encoder_apply,
    fm_encoder_init,
)
from tip_tpu_torch.ops.dense_bce_sym import dense_bce_sym_sum
from tip_tpu_torch.sampling import bitmap_tensor, typed_negative_sampling

LATER_SLICE = ("the float32 full-page path (kernel B2), the chunked path and "
               "the COO P-P path are later slices of the port")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; raises without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(the CLI's --cpu) to run on the CPU")
    return dev


@dataclass(frozen=True)
class GraphStatic:
    """Static metadata of a packed tri-graph."""

    n_drug: int
    n_prot: int
    n_et: int
    dd_n_valid: int  # directed train edges: the loss denominator
    drug_feat_dim: int = 0  # 0 => identity drug features


def dense_rgcn_feasible(n_drug: int, n_et: int, itemsize: int = 2) -> bool:
    """Whether the [n_et, n_drug, n_drug] dense adjacency fits ~2.5 GB."""
    return n_et * n_drug * n_drug * itemsize <= 2.5e9


def preferred_dense_dtype(data: TriGraphData) -> Optional[str]:
    """'bfloat16' where the JAX package picks the bf16 strip layout (counts
    exact in bf16 and the adjacency feasible), else 'float32' or None."""
    m = None
    for cand, itemsize, limit in (("bfloat16", 2, 256),
                                  ("float32", 4, 2**24)):
        if not dense_rgcn_feasible(data.n_drug, data.n_et, itemsize):
            continue
        if m is None:
            m = max_multiplicity(data.dd_train, data.n_drug)
        if m <= limit:
            return cand
    return None


def make_graph_arrays(data: TriGraphData, device=None):
    """Pack the training graph into tensors on ``device`` + static metadata.

    Ships only what the dense-strip path reads: the D-D strips and their
    thresholds, the in-degrees, the dense P-P parts and the P->D edges
    (not the full ``dd_adj_t`` pages the JAX package keeps beside them)."""
    if preferred_dense_dtype(data) != "bfloat16":
        raise NotImplementedError(
            "this graph needs the float32 or chunked D-D layout; " + LATER_SLICE)
    if not dense_pp_feasible(data.n_prot):
        raise NotImplementedError(
            "dense P-P (A+I) is infeasible for this graph; " + LATER_SLICE)
    da = dense_relation_adj(data.dd_train, data.n_drug)
    try:
        strips = sym_strip_pack(da)
    except ValueError as e:
        raise NotImplementedError(
            f"symmetric strips cannot be built ({e}); " + LATER_SLICE) from e
    del da
    try:
        a1, dinv = dense_pp_parts(data.pp_norm_index, data.n_prot)
    except ValueError as e:
        raise NotImplementedError(f"{e}; " + LATER_SLICE) from e

    def t(x):
        return torch.from_numpy(x).to(device)

    graph = {
        "dd_deg": t(data.dd_train_deg),
        "dd_adj_sym": t(strips),
        "dd_neg_q8": t(poisson_neg_thresholds_sym(data.dd_train, data.n_drug)),
        "pp_a1": t(a1),
        "pp_dinv": t(dinv),
        "dp_src": t(data.dp_edge_index[0].astype("int64")),
        "dp_dst": t(data.dp_edge_index[1].astype("int64")),
        "dp_deg": t(data.dp_drug_deg),
    }
    if data.drug_feat is not None:
        graph["drug_feat"] = t(data.drug_feat)
    if data.d_norm is not None:
        graph["d_norm"] = t(data.d_norm)
    gs = GraphStatic(
        n_drug=data.n_drug, n_prot=data.n_prot, n_et=data.n_et,
        dd_n_valid=data.dd_train.n_edges,
        drug_feat_dim=0 if data.drug_feat is None else data.drug_feat.shape[1],
    )
    return graph, gs


def make_test_arrays(data: TriGraphData, device=None) -> dict:
    src, dst = data.dd_test.edge_index
    return {
        "src": torch.from_numpy(src.astype("int64")).to(device),
        "dst": torch.from_numpy(dst.astype("int64")).to(device),
        "et": torch.from_numpy(data.dd_test.edge_type.astype("int64")).to(device),
        "bitmap": bitmap_tensor(data.dd_test_bitmap, device),
    }


@dataclass(frozen=True)
class TIP:
    """Static model description; parameters live in explicit dicts."""

    cfg: ModelConfig
    gs: GraphStatic
    device: torch.device

    @staticmethod
    def for_data(cfg: ModelConfig, data: TriGraphData, gs: GraphStatic,
                 device=None) -> "TIP":
        if cfg.decoder != "distmult" or cfg.negatives == "sampled":
            raise NotImplementedError(
                "the port trains DistMult with the fused Poissonized "
                "negatives; the NN decoder and sampled negatives are later "
                "slices")
        return TIP(cfg=cfg, gs=gs, device=resolve_device(device))

    def init(self, gen: torch.Generator) -> dict:
        gs = self.gs
        return {
            "encoder": fm_encoder_init(gen, self.cfg, gs.n_drug, gs.n_prot,
                                       gs.n_et, gs.drug_feat_dim or None,
                                       device=self.device),
            "decoder": distmult_init(gen, self.cfg.n_hid2, gs.n_et,
                                     device=self.device),
        }

    def encode(self, params, graph):
        """Drug embeddings z [n_drug, n_hid2] from the training graph."""
        return fm_encoder_apply(params["encoder"], graph, self.cfg, self.gs,
                                x_drug=graph.get("drug_feat"),
                                d_norm=graph.get("d_norm"))

    def score(self, params, z, src, dst, et, sigmoid: bool = True):
        return distmult_apply(params["decoder"], z, src, dst, et, sigmoid)

    def loss(self, params, graph, seed: int, u24=None):
        """Mean BCE over the train edges: positives plus Poissonized
        negatives from the fused symmetric dense BCE (kernel B1).  ``seed``
        keys the negative field; ``u24`` (CPU only) replaces it."""
        z = self.encode(params, graph)
        total = dense_bce_sym_sum(params["decoder"]["weight"], z,
                                  graph["dd_adj_sym"], graph["dd_neg_q8"],
                                  seed, u24=u24)
        return total / float(self.gs.dd_n_valid)

    def sample_test_negatives(self, gen: torch.Generator, test):
        src, dst = typed_negative_sampling(gen, test["et"], test["bitmap"],
                                           self.gs.n_drug)
        return {"src": src, "dst": dst}

    @torch.no_grad()
    def evaluate(self, params, graph, test, test_neg):
        """Per-relation + macro AUPRC/AUROC/AP on the test split; the
        encoder runs on the train graph and test edges are only scored."""
        z = self.encode(params, graph)
        pos = self.score(params, z, test["src"], test["dst"], test["et"])
        neg = self.score(params, z, test_neg["src"], test_neg["dst"],
                         test["et"])
        per_rel = grouped_ranking_metrics(pos, neg, test["et"], self.gs.n_et)
        return per_rel, macro_average(per_rel)
