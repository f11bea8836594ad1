"""D-D-only model: drug embedding -> two basis R-GCN layers -> DistMult
(DR-DF) or NN (DR-NN) decoder.

Port of tip_tpu/models/dd.py.  As in the reference variants, a ReLU also
follows the second R-GCN layer (``final_relu``).  The graph is packed in
one of four D-D layouts, recorded in ``GraphStatic.dd_layout``, and each
ships only what its route reads (train/model.py:dense_dd_arrays):

  * ``strips`` (DR-DF within the dense budget): the symmetric int8 strips
    for the M-first encoder and the fused symmetric dense BCE (kernel B1);
  * ``strips_pages`` (DR-NN within the dense budget): the strips for the
    encoder, plus the full uint8 relation pages and their 3-threshold field
    for the NN decoder's fused dense BCE (kernel B3);
  * ``pages`` (float32 pages where float32 matmuls are pinned or a count
    passes 256; bf16 pages where the strips cannot be built): the encoder
    contracts the full pages M-first; DR-DF's loss is the fused dense BCE
    over them (kernel B2), DR-NN's is B3 over the same pages, in their own
    dtype;
  * ``chunked`` (either decoder beyond the budget): the chunk-aligned
    buffers; the encoder runs on kernel B4, the loss draws one negative a
    slot (kernel B10) and scores positives and negatives with B8 (DistMult)
    or B9 (NN).

``negatives="sampled"`` on the dense layouts keeps their encoder and takes
the chunked loss, except that DR-DF scores its positives over the full
pages, as the JAX package does; DR-NN's strips then ship no pages, and the
layout is ``strips``.

``backend`` (train/model.py:resolve_backend): 'pallas' runs the kernels
named above on CUDA tensors (their plain versions on CPU tensors); 'xla'
the JAX package's XLA branches, which launch none.  As in the JAX
package, ``DDModel`` has no sharded (EP) route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tip_tpu_torch import trace
from tip_tpu_torch.data.packing import TriGraphData
from tip_tpu_torch.metrics import grouped_ranking_metrics, macro_average
from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.nn.decoders import (
    distmult_apply,
    distmult_apply_padded,
    distmult_dense_pos_bce_sum,
    distmult_init,
    nn_decoder_apply,
    nn_decoder_apply_padded,
    nn_decoder_init,
    nn_hiddens,
)
from tip_tpu_torch.nn.rgcn import (
    dense_rgcn_pair_apply,
    dense_rgcn_pair_apply_sym,
    rgcn_apply_padded,
    rgcn_init,
)
from tip_tpu_torch.ops.dense_bce import dense_bce_sum, dense_bce_sum_xla
from tip_tpu_torch.ops.dense_bce_nn import dense_bce_nn_sum, dense_bce_nn_sum_xla
from tip_tpu_torch.ops.dense_bce_sym import (
    dense_bce_sym_sum,
    dense_bce_sym_sum_xla,
    softplus,
)
from tip_tpu_torch.sampling import (
    typed_negative_sampling,
    typed_negative_sampling_chunked,
)
from tip_tpu_torch.train.model import (
    GraphStatic,
    check_negatives,
    chunk_arrays,
    dense_dd_arrays,
    resolve_backend,
    resolve_device,
)

LAYOUTS = {"distmult": ("strips", "pages", "chunked"),
           "nn": ("strips_pages", "pages", "chunked")}


@dataclass(frozen=True)
class DDConfig:
    n_embed: int = 16
    n_hid1: int = 32
    n_hid2: int = 16
    num_base: int = 16
    decoder: str = "distmult"  # 'distmult' (DR-DF) | 'nn' (DR-NN)
    nn_decoder_l1_dim: int = 16
    final_relu: bool = True  # reference: model/ddm-df_rgcn.py:59
    kernel_dtype: str = "float32"  # inputs of the chunked kernels B4, B8, B9
    # 'auto': the fused dense BCE on the strips or pages, sampled negatives
    # chunked
    negatives: str = "auto"

    def __post_init__(self) -> None:
        if self.decoder not in LAYOUTS:
            raise ValueError(f"unknown decoder {self.decoder!r}")
        if self.negatives not in ("auto", "poisson", "sampled"):
            raise ValueError(f"unknown negatives mode {self.negatives!r}")


@trace.spanned("device_graph")
def make_dd_graph_arrays(data: TriGraphData, device=None, chunk: int = 1024,
                         dense_dtype: Optional[str] = None,
                         decoder: str = "distmult", sampled: bool = False):
    """Pack the D-D training graph for ``decoder`` into tensors on
    ``device`` + static metadata.  ``dense_dtype="bfloat16"`` (which
    ``preferred_dense_dtype`` picks within the dense budget) ships the
    strips layout of the decoder, or the bf16 pages where the strips
    cannot be built; "float32" the float32 pages; None the chunked buffers
    with relation bins padded to ``chunk``.  ``sampled`` packs a dense
    layout for ``negatives="sampled"`` (the chunk buffers beside it)."""
    if decoder not in LAYOUTS:
        raise ValueError(f"unknown decoder {decoder!r}")
    if dense_dtype not in (None, "bfloat16", "float32"):
        raise ValueError(f"dense_dtype {dense_dtype!r}: None, 'bfloat16' or "
                         "'float32'")

    def t(x):
        return torch.from_numpy(x).to(device)

    graph = {"dd_deg": t(data.dd_train_deg)}
    layout = "chunked"
    if dense_dtype is not None:
        layout, dd = dense_dd_arrays(data, dense_dtype, device, sampled,
                                     decoder)
        graph.update(dd)
    if layout == "chunked" or sampled:
        graph.update(chunk_arrays(data, chunk, device))
    if data.drug_feat is not None:
        graph["drug_feat"] = t(data.drug_feat)
    if data.d_norm is not None:
        graph["d_norm"] = t(data.d_norm)
    gs = GraphStatic(
        n_drug=data.n_drug, n_prot=data.n_prot, n_et=data.n_et,
        dd_n_valid=data.dd_train.n_edges,
        drug_feat_dim=0 if data.drug_feat is None else data.drug_feat.shape[1],
        dd_chunk=chunk, pp_window=0, pp_n_windows=0,
        dd_n_chunks=graph["dd_src2d"].shape[0] if "dd_src2d" in graph else 0,
        dd_layout=layout, dd_sampled=sampled and layout != "chunked",
        dd_decoder=decoder, pp_layout="none",
    )
    return graph, gs


@dataclass(frozen=True)
class DDModel:
    """Static model description; parameters live in explicit dicts."""

    cfg: DDConfig
    gs: GraphStatic
    device: torch.device
    backend: str = "pallas"

    @staticmethod
    def for_data(cfg: DDConfig, gs: GraphStatic, device=None,
                 backend: str = "auto") -> "DDModel":
        if gs.dd_sampled and gs.dd_layout == "strips":
            # either decoder's sampled loss reads the chunk buffers; DR-DF's
            # positives also read the pages, which DR-NN's strips lack
            routed = cfg.decoder == "nn" or gs.dd_decoder == "distmult"
        else:
            routed = gs.dd_layout in LAYOUTS[cfg.decoder]
        if not routed:
            raise ValueError(f"a {gs.dd_layout!r} graph has no route for the "
                             f"{cfg.decoder} decoder; pack it with "
                             f"decoder={cfg.decoder!r}")
        check_negatives(cfg.negatives, gs)
        return DDModel(cfg=cfg, gs=gs, device=resolve_device(device),
                       backend=resolve_backend(backend))

    def init(self, gen: torch.Generator) -> dict:
        cfg, gs, dev = self.cfg, self.gs, self.device
        params = {
            "embed": init.normal(gen, (gs.drug_feat_dim or gs.n_drug,
                                       cfg.n_embed), device=dev),
            "rgcn1": rgcn_init(gen, cfg.n_embed, cfg.n_hid1, gs.n_et,
                               cfg.num_base, after_relu=False, device=dev),
            "rgcn2": rgcn_init(gen, cfg.n_hid1, cfg.n_hid2, gs.n_et,
                               cfg.num_base, after_relu=True, device=dev),
        }
        if cfg.decoder == "distmult":
            params["decoder"] = distmult_init(gen, cfg.n_hid2, gs.n_et,
                                              device=dev)
        else:
            params["decoder"] = nn_decoder_init(gen, cfg.n_hid2, gs.n_et,
                                                cfg.nn_decoder_l1_dim,
                                                device=dev)
        return params

    @trace.spanned("encode")
    def encode(self, params, graph):
        """Drug embeddings z [n_drug, n_hid2] from the training graph."""
        x = params["embed"]
        if "drug_feat" in graph:
            x = graph["drug_feat"] @ x
        if "d_norm" in graph:
            x = x / graph["d_norm"][:, None]
        with trace.span("rgcn"):
            x = self._rgcn_pair(params, graph, x)
        return torch.relu(x) if self.cfg.final_relu else x

    def _rgcn_pair(self, params, graph, x):
        """Both R-GCN layers on the layout's D-D buffers."""
        gs = self.gs
        if gs.dd_layout == "chunked":
            dd = (graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"],
                  graph["dd_deg"], gs.n_drug, gs.n_et)
            kw = dict(kernel_dtype=self.cfg.kernel_dtype, backend=self.backend)
            x = torch.relu(rgcn_apply_padded(params["rgcn1"], x, *dd, **kw))
            return rgcn_apply_padded(params["rgcn2"], x, *dd, **kw)
        if gs.dd_layout == "pages":
            return dense_rgcn_pair_apply(params["rgcn1"], params["rgcn2"], x,
                                         graph["dd_adj_t"], graph["dd_deg"])
        return dense_rgcn_pair_apply_sym(params["rgcn1"], params["rgcn2"], x,
                                         graph["dd_adj_sym"], graph["dd_deg"])

    def score(self, params, z, src, dst, et, sigmoid: bool = True):
        if self.cfg.decoder == "distmult":
            return distmult_apply(params["decoder"], z, src, dst, et, sigmoid)
        return nn_decoder_apply(params["decoder"], z, src, dst, et, sigmoid)

    def score_padded(self, params, z, src2d, dst2d, chunk_type,
                     sigmoid: bool = True):
        """Flat scores [n_chunks * chunk] of a chunk-aligned buffer."""
        apply = (distmult_apply_padded if self.cfg.decoder == "distmult"
                 else nn_decoder_apply_padded)
        return apply(params["decoder"], z, src2d, dst2d, chunk_type, sigmoid,
                     kernel_dtype=self.cfg.kernel_dtype, backend=self.backend)

    def loss(self, params, graph, seed: int, u24=None):
        """Mean BCE over the train edges.  ``seed`` (uint32) keys the
        negatives; ``u24`` (CPU only) replaces their random bits: the cell
        field of B1, B2 or B3 on the dense layouts, the sampler's draws on
        the chunked layout and with ``negatives="sampled"``."""
        with trace.span("forward"):
            z = self.encode(params, graph)
            with trace.span("loss"):
                total = self._loss_sum(params, graph, z, seed, u24)
                return trace.backward_span(total / float(self.gs.dd_n_valid))

    def _loss_sum(self, params, graph, z, seed: int, u24):
        """The BCE sum over the train edges (:meth:`loss`)."""
        gs, cfg = self.gs, self.cfg
        dec = params["decoder"]
        if gs.dd_layout != "chunked" and cfg.negatives != "sampled":
            xla = self.backend == "xla"
            if cfg.decoder == "nn":
                h1, h2 = nn_hiddens(dec, z)
                pages = graph["dd_adj_u8" if gs.dd_layout == "strips_pages"
                              else "dd_adj_t"]
                bce_nn = dense_bce_nn_sum_xla if xla else dense_bce_nn_sum
                return bce_nn(dec["w1_l2"], dec["w2_l2"], h1, h2, pages,
                              graph["dd_neg_q"], seed, u24=u24)
            if gs.dd_layout == "strips":
                bce_sym = dense_bce_sym_sum_xla if xla else dense_bce_sym_sum
                return bce_sym(dec["weight"], z, graph["dd_adj_sym"],
                               graph["dd_neg_q8"], seed, u24=u24)
            bce = dense_bce_sum_xla if xla else dense_bce_sum
            return bce(dec["weight"], z, graph["dd_adj_t"],
                       graph["dd_neg_q"], seed, u24=u24)
        ct = graph["dd_chunk_type"]
        neg_src2d, neg_dst2d = typed_negative_sampling_chunked(
            seed, ct, graph["dd_bitmap"], gs.n_drug, gs.n_et, gs.dd_chunk,
            u24=u24, backend=self.backend)
        valid = graph["dd_valid"]
        if gs.dd_layout != "chunked" and cfg.decoder == "distmult":
            pos_sum = distmult_dense_pos_bce_sum(
                dec["weight"], z, graph["dd_adj_t"],
                kernel_dtype=cfg.kernel_dtype)
        else:
            pos = self.score_padded(params, z, graph["dd_src2d"],
                                    graph["dd_dst2d"], ct, sigmoid=False)
            pos_sum = torch.sum(softplus(-pos) * valid)
        neg = self.score_padded(params, z, neg_src2d, neg_dst2d, ct,
                                sigmoid=False)
        return pos_sum + torch.sum(softplus(neg) * valid)

    def sample_test_negatives(self, gen: torch.Generator, test):
        src, dst = typed_negative_sampling(gen, test["et"], test["bitmap"],
                                           self.gs.n_drug)
        return {"src": src, "dst": dst}

    @torch.no_grad()
    def evaluate(self, params, graph, test, test_neg):
        """Per-relation + macro AUPRC/AUROC/AP on the test split."""
        with trace.span("eval"):
            z = self.encode(params, graph)
            with trace.span("score"):
                pos = self.score(params, z, test["src"], test["dst"],
                                 test["et"])
                neg = self.score(params, z, test_neg["src"], test_neg["dst"],
                                 test["et"])
            with trace.span("rank"):
                per_rel = grouped_ranking_metrics(pos, neg, test["et"],
                                                  self.gs.n_et)
                return per_rel, macro_average(per_rel)
