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

``backend``: train/model.py:resolve_backend.  As in the JAX package,
``DDModel`` has no sharded (EP) route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tip_tpu_torch import trace
from tip_tpu_torch.data.packing import TriGraphData
from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.nn.decoders import nn_hiddens
from tip_tpu_torch.nn.rgcn import rgcn_init, rgcn_pair_on_layout
from tip_tpu_torch.ops.dense_bce_nn import dense_bce_nn_sum, dense_bce_nn_sum_xla
from tip_tpu_torch.train.model import (
    DDFamily,
    GraphStatic,
    check_negatives,
    dd_loss_sum,
    pack_dd,
    resolve_backend,
    resolve_device,
    to_device,
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
    """The D-D training graph for ``decoder`` on ``device`` + static
    metadata: train/model.py:pack_dd's D-D side by ``dense_dtype`` (which
    ``preferred_dense_dtype`` picks) and ``sampled``, relation bins padded
    to ``chunk``, and no P-P side."""
    return pack_dd({"dd_deg": to_device(data.dd_train_deg, device)}, data,
                   device, chunk, dense_dtype, sampled, decoder, pp_window=0,
                   pp_layout="none")


@dataclass(frozen=True)
class DDModel(DDFamily):
    cfg: DDConfig

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
        return {
            "embed": init.normal(gen, (gs.drug_feat_dim or gs.n_drug,
                                       cfg.n_embed), device=dev),
            "rgcn1": rgcn_init(gen, cfg.n_embed, cfg.n_hid1, gs.n_et,
                               cfg.num_base, after_relu=False, device=dev),
            "rgcn2": rgcn_init(gen, cfg.n_hid1, cfg.n_hid2, gs.n_et,
                               cfg.num_base, after_relu=True, device=dev),
            "decoder": self.decoder_init(gen),
        }

    @trace.spanned("encode")
    def encode(self, params, graph):
        """Drug embeddings z [n_drug, n_hid2] from the training graph."""
        x = params["embed"]
        if "drug_feat" in graph:
            x = graph["drug_feat"] @ x
        if "d_norm" in graph:
            x = x / graph["d_norm"][:, None]
        with trace.span("rgcn"):
            x = rgcn_pair_on_layout(params["rgcn1"], params["rgcn2"], x,
                                    graph, self.gs, self.cfg.kernel_dtype,
                                    self.backend)
        return torch.relu(x) if self.cfg.final_relu else x

    def _loss_sum(self, params, graph, z, seed: int, u24):
        """The BCE sum over the train edges: DR-NN's fused dense BCE
        (kernel B3, ``u24`` its cell field) on the dense layouts with
        ``negatives`` auto or poisson, else TIP's routes
        (train/model.py:dd_loss_sum)."""
        gs, cfg = self.gs, self.cfg
        if (cfg.decoder == "nn" and gs.dd_layout != "chunked"
                and cfg.negatives != "sampled"):
            dec = params["decoder"]
            h1, h2 = nn_hiddens(dec, z)
            pages = graph["dd_adj_u8" if gs.dd_layout == "strips_pages"
                          else "dd_adj_t"]
            bce_nn = (dense_bce_nn_sum_xla if self.backend == "xla"
                      else dense_bce_nn_sum)
            return bce_nn(dec["w1_l2"], dec["w2_l2"], h1, h2, pages,
                          graph["dd_neg_q"], seed, u24=u24)
        return dd_loss_sum(self, params, graph, z, seed, u24)
