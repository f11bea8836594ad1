"""TIP model assembly: tri-graph encoder, DistMult decoder, the training
loss on either D-D layout, and evaluation.

Port of tip_tpu/train/model.py:52-67, 116-259 and 277-578 for the two
layouts ``make_graph_arrays`` ships on one device:

  * **dense strips** (``dense_dtype="bfloat16"``, which
    :func:`preferred_dense_dtype` picks for a graph within the dense
    budget): the symmetric int8 strips ``dd_adj_sym`` with their
    thresholds ``dd_neg_q8``; the loss is the fused symmetric dense BCE
    with Poissonized negatives (kernel B1);
  * **chunked** (``dense_dtype=None``, picked beyond the dense budget):
    the chunk-aligned D-D buffers ``dd_src2d``/``dd_dst2d``/``dd_valid``/
    ``dd_chunk_type`` with the membership bitmap ``dd_bitmap``; the loss
    draws one negative per slot (kernel B10) and scores positives and
    negatives with the DistMult SDDMM (kernel B8); the encoder's R-GCN
    runs on kernel B4.

The P-P side is dense (``pp_a1``, ``pp_dinv``) where ``pp_dense`` ships
it, else windowed (``ppw_*``, kernel B5).  Parameters are nested dicts of
tensors in the JAX package's layout; every method is a plain function of
(params, graph).  Graphs the JAX package would route to the float32 full
pages raise here, naming that slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.data.packing import (
    TriGraphData,
    bitmap_stride_bits,
    dense_pp_feasible,
    dense_pp_parts,
    dense_relation_adj,
    max_multiplicity,
    pad_typed_edges,
    pad_windowed_edges,
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
from tip_tpu_torch.nn.decoders import distmult_apply_padded
from tip_tpu_torch.ops.dense_bce_sym import dense_bce_sym_sum, softplus
from tip_tpu_torch.sampling import (
    bitmap_tensor,
    typed_negative_sampling,
    typed_negative_sampling_chunked,
)

LATER_SLICE = ("the float32 full-page path (kernel B2) is a later slice of "
               "the port")
POISSON_NEEDS_DENSE = (
    "negatives='poisson' was pinned but the fused dense BCE path cannot run "
    "here (it needs the dense adjacency pages and the distmult decoder, and "
    "under shard_map an EP-partitioned graph); use negatives='auto' to allow "
    "the sampled fallback")


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
    dd_chunk: int = 1024
    dd_n_chunks: int = 0
    pp_window: int = 1024
    pp_n_windows: int = 0
    # 'strips' (kernel B1) | 'chunked' (B4, B8 or B9, B10) | 'strips_pages'
    # (strips for the encoder, full pages for the NN decoder's loss, B3;
    # models/dd.py only)
    dd_layout: str = "strips"
    # 'dense' (pp_a1, pp_dinv) | 'windowed' (ppw_*, B5) | 'none' (no P-P
    # side: models/dd.py)
    pp_layout: str = "dense"


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


def make_graph_arrays(data: TriGraphData, device=None, dd_chunk: int = 1024,
                      pp_window: int = 1024, pp_chunk: int = 512,
                      dense_dtype: Optional[str] = None,
                      pp_dense: Optional[bool] = None):
    """Pack the training graph into tensors on ``device`` + static metadata.

    ``dense_dtype="bfloat16"`` ships the D-D symmetric strips and their
    thresholds (not the full ``dd_adj_t`` pages the JAX package keeps
    beside them); None ships the chunked D-D buffers (relation bins padded
    to ``dd_chunk``) and the train bitmap; "float32" (the full pages)
    raises.  ``pp_dense`` (default: ``dense_dtype is not None``) ships the
    dense int8 (A+I) P-P parts where feasible and free of duplicates, else
    the P-P edges windowed by ``pp_window`` and padded to ``pp_chunk``."""
    if dense_dtype not in (None, "bfloat16"):
        raise NotImplementedError(
            f"dense_dtype={dense_dtype!r} needs the float32 full pages; "
            + LATER_SLICE)
    padded = pad_typed_edges(data.dd_train, data.n_drug, chunk=dd_chunk)
    n_chunks = padded.chunk_type.shape[0]

    def t(x):
        return torch.from_numpy(x).to(device)

    graph = {
        "dd_deg": t(data.dd_train_deg),
        "dp_src": t(data.dp_edge_index[0].astype("int64")),
        "dp_dst": t(data.dp_edge_index[1].astype("int64")),
        "dp_deg": t(data.dp_drug_deg),
    }
    if dense_dtype is None:
        graph.update(
            dd_src2d=t(padded.src.reshape(n_chunks, dd_chunk)),
            dd_dst2d=t(padded.dst.reshape(n_chunks, dd_chunk)),
            dd_valid=t(padded.valid.astype("float32")),
            dd_chunk_type=t(padded.chunk_type),
            dd_bitmap=bitmap_tensor(data.dd_train_bitmap, device),
        )
    else:
        da = dense_relation_adj(data.dd_train, data.n_drug)
        try:
            strips = sym_strip_pack(da)
        except ValueError as e:
            raise NotImplementedError(
                f"symmetric strips cannot be built ({e}); " + LATER_SLICE
            ) from e
        del da
        graph["dd_adj_sym"] = t(strips)
        graph["dd_neg_q8"] = t(poisson_neg_thresholds_sym(data.dd_train,
                                                          data.n_drug))
    if pp_dense is None:
        pp_dense = dense_dtype is not None
    a1 = None
    if pp_dense and dense_pp_feasible(data.n_prot):
        try:
            a1, dinv = dense_pp_parts(data.pp_norm_index, data.n_prot)
        except ValueError:  # duplicate P-P edges: 0/1 cannot hold them
            pass
    if a1 is not None:
        graph["pp_a1"] = t(a1)
        graph["pp_dinv"] = t(dinv)
    wpp = pad_windowed_edges(data.pp_norm_index, data.pp_norm_weight,
                             data.n_prot, window=pp_window, chunk=pp_chunk)
    if a1 is None:
        npp = wpp.chunk_window.shape[0]
        graph.update(
            ppw_src=t(wpp.src.reshape(npp, pp_chunk)),
            ppw_dstl=t(wpp.dst_local.reshape(npp, pp_chunk)),
            ppw_w=t(wpp.weight.reshape(npp, pp_chunk)),
            ppw_chunk_window=t(wpp.chunk_window),
        )
    if data.drug_feat is not None:
        graph["drug_feat"] = t(data.drug_feat)
    if data.d_norm is not None:
        graph["d_norm"] = t(data.d_norm)
    gs = GraphStatic(
        n_drug=data.n_drug, n_prot=data.n_prot, n_et=data.n_et,
        dd_n_valid=padded.n_valid,
        drug_feat_dim=0 if data.drug_feat is None else data.drug_feat.shape[1],
        dd_chunk=dd_chunk, dd_n_chunks=n_chunks, pp_window=pp_window,
        pp_n_windows=wpp.n_windows,
        dd_layout="strips" if dense_dtype else "chunked",
        pp_layout="windowed" if a1 is None else "dense",
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
        if cfg.decoder != "distmult":
            raise NotImplementedError(
                "the port trains the DistMult decoder; the NN decoder is a "
                "later slice")
        if data.n_et * bitmap_stride_bits(data.n_drug) >= 2**31:
            raise ValueError(
                "relation-strided key space exceeds int32; enable x64 keys")
        if gs.dd_layout == "chunked" and cfg.negatives == "poisson":
            raise ValueError(POISSON_NEEDS_DENSE)
        if gs.dd_layout == "strips" and cfg.negatives == "sampled":
            raise NotImplementedError(
                "sampled negatives on the strip layout score their positives "
                "against the full pages; " + LATER_SLICE)
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

    def score_padded(self, params, z, src2d, dst2d, chunk_type, sigmoid=True):
        """Flat scores [n_chunks * chunk] of a chunk-aligned buffer."""
        return distmult_apply_padded(params["decoder"], z, src2d, dst2d,
                                     chunk_type, sigmoid,
                                     kernel_dtype=self.cfg.kernel_dtype)

    def loss(self, params, graph, seed: int, u24=None):
        """Mean BCE over the train edges.  ``seed`` (uint32) keys the
        negatives; ``u24`` (CPU only) replaces their random bits.

        Strip layout: positives plus Poissonized negatives from the fused
        symmetric dense BCE (kernel B1; ``u24`` is its cell field).
        Chunked layout: one sampled negative per slot (kernel B10; ``u24``
        is the sampler's [n_chunks, 1, draws * chunk] draws), positives and
        negatives scored by the DistMult SDDMM (kernel B8), softplus terms
        masked by ``dd_valid``."""
        gs = self.gs
        z = self.encode(params, graph)
        if gs.dd_layout == "strips":
            total = dense_bce_sym_sum(params["decoder"]["weight"], z,
                                      graph["dd_adj_sym"], graph["dd_neg_q8"],
                                      seed, u24=u24)
            return total / float(gs.dd_n_valid)
        ct = graph["dd_chunk_type"]
        neg_src2d, neg_dst2d = typed_negative_sampling_chunked(
            seed, ct, graph["dd_bitmap"], gs.n_drug, gs.n_et, gs.dd_chunk,
            u24=u24)
        valid = graph["dd_valid"]
        pos = self.score_padded(params, z, graph["dd_src2d"],
                                graph["dd_dst2d"], ct, sigmoid=False)
        neg = self.score_padded(params, z, neg_src2d, neg_dst2d, ct,
                                sigmoid=False)
        total = (torch.sum(softplus(-pos) * valid)
                 + torch.sum(softplus(neg) * valid))
        return total / float(gs.dd_n_valid)

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
