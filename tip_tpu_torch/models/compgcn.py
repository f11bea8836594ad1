"""CompGCN (Vashishth, Sanyal, Nitin and Talukdar, "Composition-based
Multi-Relational Graph Convolutional Networks", ICLR 2020,
arXiv:1911.03082; github.com/malllabiisc/CompGCN) with the DistMult score
and the ``mult`` composition, over the tri-graph as one knowledge graph.

The graph.  Entities are the n_drug drugs followed by the n_prot proteins.
K = R + 2 relations: the R D-D relations (each train pair in both
directions), P-P (both directions) and D-P as the triples (drug, dp,
protein).  The "in" list T holds those triples, the "out" list T^-1 each
triple reversed under relation r + K.  A triple (h, r, t) carries t's
message to h, normalised in direction d by deg_d(h)^-1/2 deg_d(t)^-1/2,
deg_d(v) the triples of that direction's list whose head is v (0 where a
degree is 0).

The layer (one, ``gcn_layer`` 1), with X [N, init_dim] the learned entity
table, Z [2K, init_dim] the learned relation table, z_loop the self-loop
relation and W_I, W_O, W_S, W_rel [init_dim, gcn_dim]:

    P_d = sum_{(h, r, t) in T_d} norm_d(h, t) (x_t * z_r)   (into row h)
    H   = tanh(BN((P_in W_I + P_out W_O + (X * z_loop) W_S) / 3))
    Z'  = Z W_rel

BN over all N rows with batch statistics (eps 1e-5), its scale stored as
its offset from 1 (``bn_scale_delta``, zero at the start: Adam's update
reads the gradient alone, so the trajectory is the scale's).  DistMult
scores (i, r, j) as sum_k H_ik Z'_rk H_jk; ``encode`` returns H's drug
rows.

Routes: the D-D messages are kernel B16 (ops/rel_scaled.py) over the int8
strips, the in and out directions in one 2 init_dim-wide pass (U = [s_in X
| s_out X] of the drugs, rounded to bf16, and z_r = [Z_r | Z_{r+K}]); the
P-P messages kernel B12 (ops/pp_aggregate.py) over the int8 A without I,
on the operand [s_in (X_p * z_pp) | s_out (X_p * z_pp^-1)] rounded to
bf16; the D-P messages ``weighted_gather_sum`` both ways; the loss B1 at d = gcn_dim
(its wide instance) over the same strips, ``train.model.dense_bce_sym_sum``
by that module-level name.  ``backend="xla"`` runs the plain versions and
launches no kernel.  Spans: ``kg_conv`` around the layer, ``rel_scaled``
around each B16 call.

Departures from the source, in the benchmark configuration's words
(tipbench/configs/compgcn.json ``assumed``):

  * dataset: the synthetic tri-graph (the Decagon files are not in the
    repository);
  * graph: the tri-graph as one KG of R + 2 relations;
  * loss: the loss over the D-D pages with drug tails only; the source's
    1-N scoring ranks all entities;
  * inverse_queries: one diagonal per relation; the source also scores
    each triple's inverse query with Z'_{r+K}, a second BCE plane over the
    same symmetric cells, which the reference estimator's one plane per
    page cannot express;
  * negatives: Poissonized full-page negatives instead of 1-N BCE;
  * label_smoothing: none (0.1 in the source);
  * entity_bias: no per-entity decoder bias, which is zero-initialised in
    the source;
  * dropout: off (gcn_drop 0.1, hid_drop 0.3);
  * batching: full-graph Adam steps; the source steps every 128 queries,
    each running the whole-graph convolution;
  * batch_norm: BN on batch statistics in evaluation too; every batch is
    the whole entity set;
  * bn_scale: BN's scale stored as an offset from 1;
  * message_direction: the source (PyG's flow) sends a triple's subject's
    message to its object and counts each direction's degrees over the
    subjects; here, as specified, the head receives.  On the symmetric D-D
    and P-P sides that is a relabelling (W_I with W_O, z_r with
    z_{r+K}); on the D-P side the degree factors count the other end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tip_tpu_torch import trace
from tip_tpu_torch.data.packing import TriGraphData, dense_pp_feasible
from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.ops.dense_bce_sym import dense_bce_sym_sum_xla
from tip_tpu_torch.ops.pp_aggregate import pp_aggregate, pp_aggregate_plain
from tip_tpu_torch.ops.rel_scaled import rel_scaled
from tip_tpu_torch.ops.segment import weighted_gather_sum
from tip_tpu_torch.train import model as train_model
from tip_tpu_torch.train.model import (
    DDFamily,
    GraphStatic,
    dense_dd_arrays,
    graph_static,
    resolve_backend,
    resolve_device,
    to_device,
)

BN_EPS = 1e-5
SCORE_CHUNK = 1 << 16  # triples a step of ``score``


@dataclass(frozen=True)
class CompGCNConfig:
    init_dim: int = 100  # published init_dim
    gcn_dim: int = 200  # published gcn_dim


def inv_sqrt(deg: np.ndarray) -> np.ndarray:
    """deg^-1/2 as float32, 0 where the degree is 0."""
    deg = deg.astype(np.float64)
    return np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)),
                    0.0).astype(np.float32)


def kg_scales(data: TriGraphData):
    """(s_in, s_out) [N] float32: deg^-1/2 of each direction's heads.  In
    T a drug heads its D-D edges and its D-P triples, a protein its P-P
    edges; in T^-1 a drug heads its D-D edges (both directions are in T),
    a protein its P-P edges and its drugs' reversed D-P triples."""
    n_d, n_p = data.n_drug, data.n_prot
    dd = np.bincount(data.dd_train.edge_index[1], minlength=n_d)
    pp = np.bincount(data.pp_train[1], minlength=n_p)
    prot, drug = data.dp_edge_index.astype(np.int64)
    dp_d = np.bincount(drug, minlength=n_d)
    dp_p = np.bincount(prot, minlength=n_p)
    deg_in = np.concatenate([dd + dp_d, pp])
    deg_out = np.concatenate([dd, pp + dp_p])
    return inv_sqrt(deg_in), inv_sqrt(deg_out)


@trace.spanned("device_graph")
def make_compgcn_graph_arrays(data: TriGraphData, device=None):
    """The tri-graph's tensors for CompGCN on ``device`` + static metadata.

    The D-D side as TIP-cat's strips layout (train/model.py:
    dense_dd_arrays: the int8 strips ``dd_adj_sym`` and the thresholds
    ``dd_neg_q8``), which both B16 and the loss read; the direction scales
    ``kg_s_in``, ``kg_s_out`` [N]; the P-P side as the int8 A without I,
    ``pp_a`` (kernel B12; raises past the dense P-P budget); the
    drug-protein edges ``dp_prot``, ``dp_drug``
    with each direction's weights ``dp_w_in`` (s_in[drug] s_in[prot]) and
    ``dp_w_out`` (s_out[prot] s_out[drug])."""
    if data.drug_feat is not None:
        raise ValueError("CompGCN learns its entity table; pack without drug "
                         "features")
    layout, dd = dense_dd_arrays(data, "bfloat16", "cpu")
    if layout != "strips":
        raise ValueError(f"the D-D pages packed as {layout!r} (a count past "
                         "127, or asymmetric pages); CompGCN reads the int8 "
                         "strips")
    graph = {k: v.to(device) for k, v in dd.items()}
    s_in, s_out = kg_scales(data)
    n_d = data.n_drug
    prot, drug = data.dp_edge_index.astype(np.int64)
    graph.update(
        kg_s_in=to_device(s_in, device), kg_s_out=to_device(s_out, device),
        dp_prot=to_device(prot, device), dp_drug=to_device(drug, device),
        dp_w_in=to_device(s_in[drug] * s_in[n_d + prot], device),
        dp_w_out=to_device(s_out[n_d + prot] * s_out[drug], device))
    if not dense_pp_feasible(data.n_prot):
        raise ValueError(f"the int8 P-P matrix of {data.n_prot} proteins is "
                         "past the dense budget; CompGCN reads it (B12)")
    src, dst = data.pp_train.astype(np.int64)
    a = np.zeros((data.n_prot, data.n_prot), np.int8)
    a[dst, src] = 1
    graph["pp_a"] = to_device(a, device)
    return graph, graph_static(data, graph, dd_chunk=0, pp_window=0,
                               dd_layout=layout, dd_decoder="distmult",
                               pp_layout="dense")


def batch_norm(x: torch.Tensor, scale_delta: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """Batch normalisation over the rows with batch statistics (biased
    variance, eps 1e-5), scale 1 + scale_delta, shift ``shift``."""
    xc = x - x.mean(0)
    var = (xc * xc).mean(0)
    return xc * torch.rsqrt(var + BN_EPS) * (1.0 + scale_delta) + shift


@dataclass(frozen=True)
class CompGCNModel(DDFamily):
    cfg: CompGCNConfig

    @staticmethod
    def for_data(cfg: CompGCNConfig, gs: GraphStatic, device=None,
                 backend: str = "auto") -> "CompGCNModel":
        if gs.dd_layout != "strips" or gs.dd_decoder != "distmult":
            raise ValueError(f"CompGCN runs on a graph from "
                             f"make_compgcn_graph_arrays; got the "
                             f"{gs.dd_layout!r} layout packed for "
                             f"{gs.dd_decoder!r}")
        return CompGCNModel(cfg=cfg, gs=gs, device=resolve_device(device),
                            backend=resolve_backend(backend))

    @property
    def n_rel(self) -> int:
        """K: the D-D relations, P-P and D-P."""
        return self.gs.n_et + 2

    def init(self, gen: torch.Generator) -> dict:
        """xavier_normal_ matrices (std sqrt(2 / (fan_in + fan_out)), a
        2-D [a, b] tensor's fans b and a), BN's scale offset and shift
        zero, as the source's ``get_param`` and ``BatchNorm1d``."""
        cfg, gs, dev = self.cfg, self.gs, self.device
        d0, d1 = cfg.init_dim, cfg.gcn_dim
        n = gs.n_drug + gs.n_prot

        def xavier(*shape):
            return init.normal(gen, shape, math.sqrt(2.0 / sum(shape)),
                               device=dev)

        zeros = dict(dtype=torch.float32, device=dev)
        return {
            "decoder": {"rel": xavier(2 * self.n_rel, d0),
                        "w_rel": xavier(d0, d1)},
            "encoder": {"ent": xavier(n, d0), "w_in": xavier(d0, d1),
                        "w_out": xavier(d0, d1), "w_loop": xavier(d0, d1),
                        "loop_rel": xavier(1, d0),
                        "bn_scale_delta": torch.zeros(d1, **zeros),
                        "bn_shift": torch.zeros(d1, **zeros)},
        }

    def _dd_messages(self, graph, x_drug, rel):
        """(s_in sum_r (A_r U_in) * z_r, s_out sum_r (A_r U_out) * z_{r+K})
        over the D-D relations, U = s * X_drug: kernel B16, both directions
        in one pass."""
        n_d, r, k = self.gs.n_drug, self.gs.n_et, self.n_rel
        s_in, s_out = graph["kg_s_in"][:n_d, None], graph["kg_s_out"][:n_d, None]
        u = torch.cat([s_in * x_drug, s_out * x_drug], dim=1)
        z = torch.cat([rel[:r], rel[k:k + r]], dim=1)
        out = rel_scaled(graph["dd_adj_sym"], u, z,
                         plain=self.backend == "xla")
        d0 = x_drug.shape[1]
        return s_in * out[:, :d0], s_out * out[:, d0:]

    def _pp_messages(self, graph, x_prot, rel):
        """(s_in A_pp U_in, s_out A_pp U_out), U_in = s_in (X_p * z_pp),
        U_out = s_out (X_p * z_{pp+K}): B12, both directions in one pass,
        its operand rounded to bf16."""
        n_d, k = self.gs.n_drug, self.n_rel
        s_in, s_out = graph["kg_s_in"][n_d:, None], graph["kg_s_out"][n_d:, None]
        pp = k - 2
        u = torch.cat([s_in * (x_prot * rel[pp]),
                       s_out * (x_prot * rel[k + pp])], dim=1)
        ub = u.to(torch.bfloat16)
        if self.backend == "xla":
            agg = pp_aggregate_plain(graph["pp_a"], ub)
        else:
            agg = pp_aggregate(graph["pp_a"], ub)
        d0 = x_prot.shape[1]
        return s_in * agg[:, :d0], s_out * agg[:, d0:]

    @trace.spanned("encode")
    def encode(self, params, graph):
        """Drug embeddings z [n_drug, gcn_dim]: the drug rows of H."""
        enc, rel = params["encoder"], params["decoder"]["rel"]
        gs, k = self.gs, self.n_rel
        n_d = gs.n_drug
        x = enc["ent"]
        x_d, x_p = x[:n_d], x[n_d:]
        with trace.span("kg_conv"):
            dd_in, dd_out = self._dd_messages(graph, x_d, rel)
            pp_in, pp_out = self._pp_messages(graph, x_p, rel)
            dp = k - 1
            to_d = weighted_gather_sum(x_p * rel[dp], graph["dp_prot"],
                                       graph["dp_drug"], graph["dp_w_in"],
                                       n_d)
            to_p = weighted_gather_sum(x_d * rel[k + dp], graph["dp_drug"],
                                       graph["dp_prot"], graph["dp_w_out"],
                                       gs.n_prot)
            p_in = torch.cat([dd_in + to_d, pp_in])
            p_out = torch.cat([dd_out, pp_out + to_p])
            pre = (p_in @ enc["w_in"] + p_out @ enc["w_out"]
                   + (x * enc["loop_rel"]) @ enc["w_loop"]) * (1.0 / 3.0)
            h = torch.tanh(batch_norm(pre, enc["bn_scale_delta"],
                                      enc["bn_shift"]))
            return h[:n_d]

    def _weight(self, params) -> torch.Tensor:
        """DistMult's relation rows: (Z W_rel)[:R], the D-D relations."""
        dec = params["decoder"]
        return dec["rel"][:self.gs.n_et] @ dec["w_rel"]

    def score(self, params, z, src, dst, et, sigmoid: bool = True):
        """DistMult logits (or probabilities) of (src, dst, relation), in
        chunks of SCORE_CHUNK triples: at d = 200 the gathered rows of the
        whole test split would take 0.75 GB each."""
        w = self._weight(params)
        src, dst, et = src.long(), dst.long(), et.long()
        logits = torch.cat([
            torch.sum(z[src[i:i + SCORE_CHUNK]] * z[dst[i:i + SCORE_CHUNK]]
                      * w[et[i:i + SCORE_CHUNK]], -1)
            for i in range(0, max(1, src.shape[0]), SCORE_CHUNK)])
        return torch.sigmoid(logits) if sigmoid else logits

    def _loss_sum(self, params, graph, z, seed: int, u24):
        """The BCE sum over the D-D train edges and the Poissonized
        negatives of the strips (kernel B1, its wide instance at d =
        gcn_dim).  ``u24`` (CPU only) replaces the cells' random bits."""
        bce = (dense_bce_sym_sum_xla if self.backend == "xla"
               else train_model.dense_bce_sym_sum)
        return bce(self._weight(params), z, graph["dd_adj_sym"],
                   graph["dd_neg_q8"], seed, u24=u24)
