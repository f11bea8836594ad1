"""Decagon (Zitnik, Agrawal and Leskovec, "Modeling polypharmacy side effects
with graph convolutional networks", Bioinformatics 34(13):i457, 2018;
github.com/mims-harvard/decagon): a multi-type graph convolution over the
tri-graph and the DEDICOM decoder of the D-D side-effect relations.

Encoder, for node type i (drug, protein) and source type j, in the code's
order (``deep/layers.py``: ``GraphConvolutionSparseMulti``,
``GraphConvolutionMulti``):

    m_ij = l2norm_rows( sum_{r in rel(i, j)} A_hat_r X_j W_r )
    layer 1: H_i = relu(sum_j m_ij)      layer 2: Z_i = sum_j m_ij

Square adjacencies (P-P, each D-D relation) are D_r^-1/2 (A_r + I)
D_r^-1/2, one self loop and degree a relation; the P-D and D-P ones
rowsum^-1/2 A colsum^-1/2 (``preprocessing.preprocess_graph``).  Inputs
are one-hot, so layer 1's W_r are tables.  Decoder: relation r scores
(dst i, src j) as z_i D_r R D_r z_j^T, D_r a learned diagonal and R one
global [h2, h2] matrix (``DEDICOMDecoder``).

Routes: the D-D convolution is kernel B14 (ops/rel_aggregate.py) over the
uint8 pages, the P-P GCN kernel B12 (ops/pp_aggregate.py), the loss kernel
B13 (ops/dense_bce_dedicom.py) over the same pages with the full
3-threshold Poissonized estimator.  Where float32 matmuls are pinned
(``rel_precision="float32"``) B14's forward keeps its operand float32 in
three exact bf16 terms (the float32 product), from the same pages; B13 is
float32 either way.  ``backend="xla"`` runs the plain versions and launches
no kernel.  Departures from the source, as the benchmark's configuration
states them: the loss covers the D-D relations only (so layer 2 computes
the drug rows alone: protein rows feed nothing), no dropout, full-graph
Adam steps, Poissonized negatives, drug features one-hot only, and one
table and one diagonal a relation: the source also runs each D-D
relation's and the P-P graph's transpose as edge types of their own, whose
tables, on symmetric adjacencies, only ever appear summed with the
relation's own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tip_tpu_torch import trace
from tip_tpu_torch.data.packing import TriGraphData, dense_pp_fits
from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.nn.gcn import gcn_conv_apply, gcn_conv_apply_dense
from tip_tpu_torch.ops.dense_bce_dedicom import dense_bce_dedicom_sum
from tip_tpu_torch.ops.rel_aggregate import rel_aggregate
from tip_tpu_torch.ops.segment import weighted_gather_sum
from tip_tpu_torch.train.model import (
    DDFamily,
    GraphStatic,
    dense_dd_arrays,
    graph_static,
    pp_arrays,
    resolve_backend,
    resolve_device,
    to_device,
)

PRECISIONS = ("bfloat16", "float32")  # of the D-D contraction's operand


@dataclass(frozen=True)
class DecagonConfig:
    n_hid1: int = 64  # published hidden1
    n_hid2: int = 32  # published hidden2


def l2norm_rows(x: torch.Tensor) -> torch.Tensor:
    """tf.nn.l2_normalize(x, dim=1): x / sqrt(max(sum x^2, 1e-12))."""
    return x * torch.rsqrt(torch.clamp((x * x).sum(1, keepdim=True),
                                       min=1e-12))


def relation_scales(edges, n_drug: int) -> np.ndarray:
    """s [R, n] float32 = (deg + 1)^-1/2, deg_t[i] the directed train
    edges of relation t into drug i (the row sums of its count page): s_t
    (A_t + I) s_t = D^-1/2 (A + I) D^-1/2."""
    key = edges.edge_type.astype(np.int64) * n_drug + edges.edge_index[1]
    deg = np.bincount(key, minlength=edges.n_et * n_drug).astype(np.float64)
    return (1.0 / np.sqrt(deg + 1.0)).astype(np.float32).reshape(
        edges.n_et, n_drug)


def dp_weights(dp_edge_index: np.ndarray, n_drug: int,
               n_prot: int) -> np.ndarray:
    """Edge weights rowsum^-1/2 colsum^-1/2 of the drug-protein adjacency,
    the same in both directions; [E] float32 for edges (protein, drug)."""
    prot, drug = dp_edge_index.astype(np.int64)
    deg_d = np.bincount(drug, minlength=n_drug).astype(np.float64)
    deg_p = np.bincount(prot, minlength=n_prot).astype(np.float64)
    return (1.0 / np.sqrt(deg_d[drug] * deg_p[prot])).astype(np.float32)


@trace.spanned("device_graph")
def make_decagon_graph_arrays(data: TriGraphData, device=None):
    """The tri-graph's tensors for Decagon on ``device`` + static metadata.

    Packs the D-D side as DR-NN's strips + uint8 pages do
    (train/model.py:dense_dd_arrays) and keeps the uint8 pages
    ``dd_adj_u8``, which B14 and B13 read at either precision (no route
    reads the strips: they are not shipped).  Beside them: the relations'
    thresholds ``dd_neg_q`` and scales ``dd_rel_s``, the P-P side dense
    (int8 (A+I) and D^-1/2, kernel B12) where data/packing.py:dense_pp_fits
    allows, else its normalized COO edges, and the drug-protein edges with
    their weights."""
    if data.drug_feat is not None:
        raise ValueError("Decagon's drug inputs are one-hot; pack without "
                         "drug features")
    layout, dd = dense_dd_arrays(data, "bfloat16", "cpu", decoder="nn")
    if layout != "strips_pages":
        raise ValueError(f"the D-D pages packed as {layout!r} (a count past "
                         "127, or asymmetric pages); Decagon reads uint8 "
                         "pages")
    graph = {k: v.to(device) for k, v in dd.items() if k != "dd_adj_sym"}
    graph.update(
        dd_rel_s=to_device(relation_scales(data.dd_train, data.n_drug), device),
        dp_prot=to_device(data.dp_edge_index[0].astype("int64"), device),
        dp_drug=to_device(data.dp_edge_index[1].astype("int64"), device),
        dp_w=to_device(dp_weights(data.dp_edge_index, data.n_drug,
                                  data.n_prot), device))
    dense_pp = dense_pp_fits(data.pp_norm_index, data.n_prot)
    graph.update(pp_arrays(data, device, dense_pp))
    return graph, graph_static(data, graph, dd_chunk=0, pp_window=0,
                               dd_layout=layout, dd_decoder="dedicom",
                               pp_layout="dense" if dense_pp else "coo")


@dataclass(frozen=True)
class DecagonModel(DDFamily):
    cfg: DecagonConfig
    rel_precision: str = "bfloat16"  # "float32" where float32 matmuls are pinned

    @staticmethod
    def for_data(cfg: DecagonConfig, gs: GraphStatic, device=None,
                 backend: str = "auto",
                 rel_precision: str = "bfloat16") -> "DecagonModel":
        if gs.dd_layout != "strips_pages" or gs.dd_decoder != "dedicom":
            raise ValueError(f"Decagon runs on a graph from "
                             f"make_decagon_graph_arrays; got the "
                             f"{gs.dd_layout!r} layout packed for "
                             f"{gs.dd_decoder!r}")
        if rel_precision not in PRECISIONS:
            raise ValueError(f"rel_precision must be one of {PRECISIONS}, got "
                             f"{rel_precision!r}")
        return DecagonModel(cfg=cfg, gs=gs, device=resolve_device(device),
                            backend=resolve_backend(backend),
                            rel_precision=rel_precision)

    def init(self, gen: torch.Generator) -> dict:
        """Glorot tables and weights, as the source's
        ``weight_variable_glorot`` (a relation's diagonal is a [h2, 1]
        glorot column there: kept as [R, h2, 1])."""
        cfg, gs, dev = self.cfg, self.gs, self.device
        h1, h2, r = cfg.n_hid1, cfg.n_hid2, gs.n_et

        def glorot(*shape):
            return init.glorot_uniform(gen, shape, device=dev)

        return {
            "decoder": {"global": glorot(h2, h2), "local": glorot(r, h2, 1)},
            "layer1": {"dd": glorot(r, gs.n_drug, h1),
                       "dp": glorot(gs.n_drug, h1),
                       "pd": glorot(gs.n_prot, h1),
                       "pp": glorot(gs.n_prot, h1)},
            "layer2": {"dd": glorot(r, h1, h2), "pd": glorot(h1, h2)},
        }

    def _rel_conv(self, graph, y):
        """sum_t A_hat_t y_t over the D-D relations (span ``rel_conv``)."""
        with trace.span("rel_conv"):
            return rel_aggregate(graph["dd_adj_u8"], graph["dd_rel_s"], y,
                                 plain=self.backend == "xla",
                                 exact=self.rel_precision == "float32")

    def _pp_conv(self, graph, table):
        """A_hat_pp table over the P-P graph (B12 on the dense side)."""
        if "pp_a1" in graph:
            return gcn_conv_apply_dense({"weight": table}, None,
                                        graph["pp_a1"], graph["pp_dinv"],
                                        backend=self.backend)
        return gcn_conv_apply({"weight": table}, None, graph["pp_norm_index"],
                              graph["pp_norm_weight"], self.gs.n_prot)

    def _to_drugs(self, graph, x_prot):
        return weighted_gather_sum(x_prot, graph["dp_prot"], graph["dp_drug"],
                                   graph["dp_w"], self.gs.n_drug)

    def _to_proteins(self, graph, x_drug):
        return weighted_gather_sum(x_drug, graph["dp_drug"], graph["dp_prot"],
                                   graph["dp_w"], self.gs.n_prot)

    @trace.spanned("encode")
    def encode(self, params, graph):
        """Drug embeddings z [n_drug, n_hid2]."""
        p1, p2 = params["layer1"], params["layer2"]
        h_drug = torch.relu(l2norm_rows(self._to_drugs(graph, p1["pd"]))
                            + l2norm_rows(self._rel_conv(graph, p1["dd"])))
        h_prot = torch.relu(l2norm_rows(self._pp_conv(graph, p1["pp"]))
                            + l2norm_rows(self._to_proteins(graph, p1["dp"])))
        y = torch.matmul(h_drug, p2["dd"])  # [R, n_drug, n_hid2]
        return (l2norm_rows(self._to_drugs(graph, h_prot @ p2["pd"]))
                + l2norm_rows(self._rel_conv(graph, y)))

    @staticmethod
    def _dec(params):
        dec = params["decoder"]
        return dec["local"][..., 0], dec["global"]

    def score(self, params, z, src, dst, et, sigmoid: bool = True):
        """DEDICOM logits (or probabilities) of (src, dst, relation)."""
        dvec, rmat = self._dec(params)
        d = dvec[et.long()]
        logits = torch.sum(((z[dst.long()] * d) @ rmat) * (z[src.long()] * d),
                           -1)
        return torch.sigmoid(logits) if sigmoid else logits

    def _loss_sum(self, params, graph, z, seed: int, u24):
        """The BCE sum over the D-D train edges and the Poissonized
        negatives of the full pages (kernel B13).  ``u24`` (CPU only)
        replaces the cells' random bits."""
        dvec, rmat = self._dec(params)
        with trace.span("dedicom_bce"):
            return dense_bce_dedicom_sum(
                dvec, rmat, z, graph["dd_adj_u8"], graph["dd_neg_q"], seed,
                u24=u24, plain=self.backend == "xla")
