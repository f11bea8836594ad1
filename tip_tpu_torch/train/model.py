"""TIP model assembly: tri-graph encoder, DistMult or NN decoder, the
training loss on each D-D layout, and evaluation.

Port of tip_tpu/train/model.py:52-67, 76-259 and 277-578 for the three
layouts ``make_graph_arrays`` ships on one device:

  * **dense strips** (``dense_dtype="bfloat16"``, which
    :func:`preferred_dense_dtype` picks for a graph within the dense
    budget): the symmetric int8 strips ``dd_adj_sym`` with their
    thresholds ``dd_neg_q8``; the loss is the fused symmetric dense BCE
    with Poissonized negatives (kernel B1);
  * **full pages** (``dense_dtype="float32"``, picked where the caller
    pins float32 matmuls or a count passes bf16's exact range, and
    ``"bfloat16"`` where the strips cannot be built): the unpadded count
    pages ``dd_adj_t`` with their thresholds ``dd_neg_q``; the encoder's
    R-GCN pair contracts them M-first, the loss is the fused dense BCE
    over the pages (kernel B2);
  * **chunked** (``dense_dtype=None``, picked beyond the dense budget):
    the chunk-aligned D-D buffers ``dd_src2d``/``dd_dst2d``/``dd_valid``/
    ``dd_chunk_type`` with the membership bitmap ``dd_bitmap``; the loss
    draws one negative per slot (kernel B10) and scores positives and
    negatives with the DistMult SDDMM (kernel B8); the encoder's R-GCN
    runs on kernel B4.

The loss routes are :func:`dd_loss_sum`'s, which DR-DF/DR-NN
(models/dd.py) share: sampled negatives (``negatives="sampled"``) on the
strips or the pages take the chunked layout's route (B10, B8) with the
positives over the full pages, and the NN decoder takes it on every
layout (B10, B9), as the JAX package's TIP does.  The P-P side is dense
(``pp_a1``, ``pp_dinv``) where ``pp_dense`` ships it, else windowed
(``ppw_*``, kernel B5).  :class:`DDFamily` holds the rest TIP shares
with models/dd.py and models/decagon.py: the loss frame, the evaluation,
the test negatives and the decoder.  Parameters are nested dicts of
tensors in the JAX package's layout; every method is a plain function of
(params, graph).

Sharded (port of tip_tpu/train/model.py:326-554): ``encode`` and ``loss``
take a ``mesh`` (parallel/mesh.py) where the JAX package takes
``axis_name``; ``graph`` is then this rank's view (parallel/sharded.py).
Chunked: each rank samples and scores its own chunks with the rank folded
into the seed, and the loss sums are summed over the ranks before dividing
by the global edge count.  Relation-partitioned (EP, parallel/ep.py,
``gs.ep_r_max`` > 0), on any layout: the rank's ``att`` and decoder rows
are its relations' ([1, r_max, ...] leaves); the R-GCN contracts the
rank's block of strips or pages, or bins the rank's chunks over its local
relations (kernel B4 with R = r_max), and sums over the ranks; the fused
dense BCE (B1 on the strips, B2 on the pages) scores the rank's block and
its total is summed over the ranks before the division; the sampled route
draws by GLOBAL relation id (B10 reads the global bitmap) and scores by
local row (B8, B9).  B1's and B2's cell field is keyed by (seed, relation,
row, col): under EP the relation is the rank's local slot and the seed is
folded with the rank, so every rank draws its own stream, the counterpart
of the JAX package's device-folded key.  The unsharded eval of an EP graph
runs on its slot-ordered strips or pages (M is the same in any relation
order), or, without them, gathers ``att`` back to global order through
``ep_slot``.

``backend`` (:func:`resolve_backend`): 'pallas' runs the hand-written CUDA
kernels on CUDA tensors and their plain versions on CPU tensors; 'xla'
runs ports of the JAX package's XLA branches (segment sums, gathers, the
flat sampler, the COO P-P GCN, the ppermute ring), which launch no kernel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from tip_tpu_torch import trace
from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.data.packing import (
    PAGE_EXACT_MAX,
    TriGraphData,
    bitmap_stride_bits,
    cast_dense_adj,
    dense_pp_fits,
    dense_pp_parts,
    dense_relation_adj,
    max_multiplicity,
    pad_typed_edges,
    pad_windowed_edges,
    poisson_neg_thresholds,
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
from tip_tpu_torch.nn.decoders import (
    distmult_apply_padded,
    distmult_dense_pos_bce_sum,
    nn_decoder_apply,
    nn_decoder_apply_padded,
    nn_decoder_init,
)
from tip_tpu_torch.ops.dense_bce import dense_bce_sum, dense_bce_sum_xla
from tip_tpu_torch.ops.dense_bce_sym import (
    dense_bce_sym_sum,
    dense_bce_sym_sum_xla,
    softplus,
)
from tip_tpu_torch.parallel.collectives import psum
from tip_tpu_torch.parallel.ep import _DECODER_REL_LEAVES
from tip_tpu_torch.sampling import (
    bitmap_tensor,
    typed_negative_sampling,
    typed_negative_sampling_chunked,
)

PAGE_ITEMSIZE = {"bfloat16": 2, "float32": 4}
POISSON_NEEDS_DENSE = (
    "negatives='poisson' was pinned but the fused dense BCE path cannot run "
    "here (it needs the dense adjacency pages and the distmult decoder, and "
    "under shard_map an EP-partitioned graph); use negatives='auto' to allow "
    "the sampled fallback")


def fold_seed(seed: int, index: int) -> int:
    """A uint32 seed for rank ``index`` (``jax.random.fold_in``'s role)."""
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, index])
               .generate_state(1)[0])


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
    # 'strips' (kernel B1) | 'pages' (full pages, B2; B3 for DR-NN)
    # | 'chunked' (B4, B8 or B9, B10) | 'strips_pages' (strips for the
    # encoder, uint8 full pages for DR-NN's loss, B3; models/dd.py; Decagon
    # ships the uint8 pages alone, models/decagon.py)
    dd_layout: str = "strips"
    # strips or pages packed for sampled negatives (dense_dd_arrays)
    dd_sampled: bool = False
    # the decoder whose loss the D-D side was packed for
    dd_decoder: str = "distmult"
    # 'dense' (pp_a1, pp_dinv) | 'windowed' (ppw_*, B5, with the COO
    # edges of backend="xla") | 'coo' (pp_norm_*: models/decagon.py) |
    # 'none' (no P-P side: models/dd.py, or a sharded graph whose P-P side
    # is the ring)
    pp_layout: str = "dense"
    # > 0: the protein rows ring-sharded over the mesh's ring axis
    # (parallel/ring.py:add_ring_pp)
    pp_ring_shards: int = 0
    # > 0: the relation rows EP-partitioned, r_max a rank
    # (parallel/ep.py:ep_shard_graph)
    ep_r_max: int = 0


def dense_rgcn_feasible(n_drug: int, n_et: int, itemsize: int = 2) -> bool:
    """Whether the [n_et, n_drug, n_drug] dense adjacency fits ~2.5 GB."""
    return n_et * n_drug * n_drug * itemsize <= 2.5e9


def preferred_dense_dtype(data: TriGraphData, kernel_dtype: str = "float32",
                          matmul_precision: str = "default") -> Optional[str]:
    """Page dtype of the dense D-D layout the JAX package picks, or None
    (the chunked layout).

    bf16 pages (the strips where they can be built) are preferred whatever
    the kernel dtype: their counts are exact up to 256 and default-precision
    matmuls round to bf16 anyway.  ``matmul_precision`` stands for
    ``jax_default_matmul_precision``: a float32 kernel dtype with
    "float32" or "highest" asks for exact float32 matmuls, so only float32
    pages are tried.  Otherwise bf16, then ``kernel_dtype``; each where
    the pages fit the dense budget and hold the largest count exactly."""
    f32_matmuls = (kernel_dtype == "float32"
                   and matmul_precision in ("float32", "highest"))
    candidates = ((kernel_dtype,) if f32_matmuls
                  else ("bfloat16", kernel_dtype))
    m = None
    for cand in candidates:
        if not dense_rgcn_feasible(data.n_drug, data.n_et,
                                   PAGE_ITEMSIZE[cand]):
            continue
        if m is None:
            m = max_multiplicity(data.dd_train, data.n_drug)
        if m <= PAGE_EXACT_MAX[cand]:
            return cand
    return None


def to_device(x: np.ndarray, device=None) -> torch.Tensor:
    return torch.from_numpy(x).to(device)


def pages_tensor(da, dtype: str, device=None) -> torch.Tensor:
    """The count pages [R, n, n] (dense_relation_adj) as a tensor of page
    dtype ``dtype`` on ``device``, cast exactly (cast_dense_adj)."""
    pages = torch.from_numpy(cast_dense_adj(da, dtype))
    if dtype == "bfloat16":
        pages = pages.view(torch.bfloat16)
    return pages.to(device)


def dense_dd_arrays(data: TriGraphData, dense_dtype: str, device=None,
                    sampled: bool = False, decoder: str = "distmult"):
    """(layout, tensors) of the dense D-D layouts, shipping what the route
    reads.

    The encoder reads the int8 strips ``dd_adj_sym`` where a bf16
    ``dense_dtype`` can build them ('strips'), else the full count pages
    ``dd_adj_t`` in ``dense_dtype`` ('pages'), as the JAX package falls
    back.  The Poissonized loss reads the strips' thresholds ``dd_neg_q8``
    (kernel B1) or the pages' ``dd_neg_q`` (kernel B2); the NN decoder's
    (kernel B3, DR-NN) reads ``dd_neg_q`` and the full pages: ``dd_adj_t``
    in its own dtype on the pages, uint8 pages ``dd_adj_u8`` beside the
    strips (whose counts are at most 127), the layout then being
    'strips_pages'.  With ``sampled`` the Poissonized inputs stay home;
    DistMult then scores its positives over ``dd_adj_t`` (shipped beside
    the strips too), the NN decoder over the chunk buffers, which the
    caller ships (:func:`chunk_arrays`)."""
    da = dense_relation_adj(data.dd_train, data.n_drug)
    out, layout = {}, "pages"
    if dense_dtype == "bfloat16":
        try:
            out["dd_adj_sym"] = to_device(sym_strip_pack(da), device)
            layout = "strips"
        except ValueError:  # asymmetric pages or counts past int8
            pass
    if layout == "pages" or (sampled and decoder == "distmult"):
        out["dd_adj_t"] = pages_tensor(da, dense_dtype, device)
    if not sampled:
        if layout == "strips" and decoder == "distmult":
            out["dd_neg_q8"] = to_device(poisson_neg_thresholds_sym(
                data.dd_train, data.n_drug), device)
        else:
            out["dd_neg_q"] = to_device(poisson_neg_thresholds(
                data.dd_train, data.n_drug), device)
        if decoder == "nn" and layout == "strips":
            out["dd_adj_u8"] = to_device(cast_dense_adj(da, "uint8"), device)
            layout = "strips_pages"
    return layout, out


def check_negatives(negatives: str, gs: GraphStatic) -> None:
    """Raise unless the graph was packed for the ``negatives`` route of a
    model whose dense layouts take the Poissonized route by default."""
    if gs.dd_layout == "chunked":
        if negatives == "poisson":
            raise ValueError(POISSON_NEEDS_DENSE)
    elif gs.dd_sampled != (negatives == "sampled"):
        raise ValueError(
            f"negatives={negatives!r} on a {gs.dd_layout!r} graph packed "
            f"with sampled={gs.dd_sampled}: sampled negatives read the chunk "
            "buffers, the others the Poissonized thresholds; pack with "
            f"sampled={negatives == 'sampled'}")


def chunk_arrays(data: TriGraphData, dd_chunk: int, device=None) -> dict:
    """The chunk-aligned D-D buffers and the train bitmap: the chunked
    layout, and the sampled-negative route beside the strips or pages."""
    padded = pad_typed_edges(data.dd_train, data.n_drug, chunk=dd_chunk)
    n_chunks = padded.chunk_type.shape[0]
    return {
        "dd_src2d": to_device(padded.src.reshape(n_chunks, dd_chunk), device),
        "dd_dst2d": to_device(padded.dst.reshape(n_chunks, dd_chunk), device),
        "dd_valid": to_device(padded.valid.astype("float32"), device),
        "dd_chunk_type": to_device(padded.chunk_type, device),
        "dd_bitmap": bitmap_tensor(data.dd_train_bitmap, device),
    }


def pp_arrays(data: TriGraphData, device, dense: bool) -> dict:
    """The P-P side on ``device``: with ``dense`` (which
    data/packing.py:dense_pp_fits decides) the int8 (A+I) and D^-1/2 of
    data/packing.py:dense_pp_parts, else the normalized COO edges."""
    if dense:
        a1, dinv = dense_pp_parts(data.pp_norm_index, data.n_prot)
        return {"pp_a1": to_device(a1, device),
                "pp_dinv": to_device(dinv, device)}
    return {
        "pp_norm_index": to_device(data.pp_norm_index.astype("int64"), device),
        "pp_norm_weight": to_device(data.pp_norm_weight, device)}


def graph_static(data: TriGraphData, graph: dict, **layout) -> GraphStatic:
    """The GraphStatic of ``data`` packed into ``graph``; ``layout``: the
    fields its packer chose."""
    return GraphStatic(
        n_drug=data.n_drug, n_prot=data.n_prot, n_et=data.n_et,
        dd_n_valid=data.dd_train.n_edges,
        drug_feat_dim=0 if data.drug_feat is None else data.drug_feat.shape[1],
        dd_n_chunks=graph["dd_src2d"].shape[0] if "dd_src2d" in graph else 0,
        **layout)


def pack_dd(graph: dict, data: TriGraphData, device, dd_chunk: int,
            dense_dtype: Optional[str], sampled: bool, decoder: str,
            **layout):
    """(graph, GraphStatic): ``graph`` (which holds ``dd_deg``) plus the
    D-D side of the training graph and the drug inputs on ``device``;
    ``layout``: the other sides' GraphStatic fields.  The D-D side is the dense layout of
    ``dense_dtype`` for ``decoder`` (:func:`dense_dd_arrays`), or with None
    the chunked buffers, relation bins padded to ``dd_chunk``
    (:func:`chunk_arrays`), which ``sampled`` ships beside a dense one."""
    if dense_dtype not in (None, "bfloat16", "float32"):
        raise ValueError(f"dense_dtype {dense_dtype!r}: None, 'bfloat16' or "
                         "'float32'")
    if decoder not in ("distmult", "nn"):
        raise ValueError(f"unknown decoder {decoder!r}")
    dd_layout = "chunked"
    if dense_dtype is not None:
        dd_layout, dd = dense_dd_arrays(data, dense_dtype, device, sampled,
                                        decoder)
        graph.update(dd)
    if dd_layout == "chunked" or sampled:
        graph.update(chunk_arrays(data, dd_chunk, device))
    if data.drug_feat is not None:
        graph["drug_feat"] = to_device(data.drug_feat, device)
    if data.d_norm is not None:
        graph["d_norm"] = to_device(data.d_norm, device)
    return graph, graph_static(
        data, graph, dd_chunk=dd_chunk, dd_layout=dd_layout,
        dd_sampled=sampled and dd_layout != "chunked", dd_decoder=decoder,
        **layout)


@trace.spanned("device_graph")
def make_graph_arrays(data: TriGraphData, device=None, dd_chunk: int = 1024,
                      pp_window: int = 1024, pp_chunk: int = 512,
                      dense_dtype: Optional[str] = None,
                      pp_dense: Optional[bool] = None, sampled: bool = False,
                      decoder: str = "distmult"):
    """Pack the training graph into tensors on ``device`` + static metadata.

    The D-D side by ``dense_dtype`` and ``sampled`` (:func:`pack_dd`).
    ``decoder="nn"`` packs for TIP's NN decoder, which takes the sampled
    route on every layout: the encoder's strips or pages, the chunk
    buffers and the bitmap, nothing more (``sampled`` is implied).
    ``pp_dense`` (default: ``dense_dtype is not None``) ships the dense
    int8 (A+I) P-P parts where data/packing.py:dense_pp_fits allows, else
    the P-P edges windowed by ``pp_window`` and padded to ``pp_chunk``
    (kernel B5) and the COO edges (``backend="xla"``)."""
    if pp_dense is None:
        pp_dense = dense_dtype is not None
    pp_dense = pp_dense and dense_pp_fits(data.pp_norm_index, data.n_prot)
    graph, gs = pack_dd(
        {"dd_deg": to_device(data.dd_train_deg, device),
         "dp_src": to_device(data.dp_edge_index[0].astype("int64"), device),
         "dp_dst": to_device(data.dp_edge_index[1].astype("int64"), device),
         "dp_deg": to_device(data.dp_drug_deg, device)},
        data, device, dd_chunk, dense_dtype, sampled or decoder == "nn",
        decoder, pp_window=pp_window, pp_n_windows=-(-data.n_prot // pp_window),
        pp_layout="dense" if pp_dense else "windowed")
    if not pp_dense:  # the windowed buffers of kernel B5 beside the COO edges
        wpp = pad_windowed_edges(data.pp_norm_index, data.pp_norm_weight,
                                 data.n_prot, window=pp_window, chunk=pp_chunk)
        npp = wpp.chunk_window.shape[0]
        graph.update(
            ppw_src=to_device(wpp.src.reshape(npp, pp_chunk), device),
            ppw_dstl=to_device(wpp.dst_local.reshape(npp, pp_chunk), device),
            ppw_w=to_device(wpp.weight.reshape(npp, pp_chunk), device),
            ppw_chunk_window=to_device(wpp.chunk_window, device))
    graph.update(pp_arrays(data, device, pp_dense))
    return graph, gs


def relation_ordered(graph: dict, n_drug: int) -> dict:
    """The graph with its chunk buffers in relation order: chunks by global
    type, inert pad chunks (dst = n_drug) after their relation's real ones,
    each relation's chunks in the order they had (a stable sort).  An EP
    graph's chunks are device-major; its unsharded eval bins them in
    relation order, one run a relation, as kernel B4 wants."""
    pad = (graph["dd_dst2d"][:, 0] >= n_drug).long()
    order = torch.argsort(graph["dd_chunk_type"].long() * 2 + pad,
                          stable=True)
    chunk = graph["dd_src2d"].shape[1]
    return dict(graph, dd_src2d=graph["dd_src2d"][order],
                dd_dst2d=graph["dd_dst2d"][order],
                dd_chunk_type=graph["dd_chunk_type"][order],
                dd_valid=graph["dd_valid"].reshape(-1, chunk)[order]
                .reshape(-1))


def make_test_arrays(data: TriGraphData, device=None) -> dict:
    src, dst = data.dd_test.edge_index
    return {
        "src": to_device(src.astype("int64"), device),
        "dst": to_device(dst.astype("int64"), device),
        "et": to_device(data.dd_test.edge_type.astype("int64"), device),
        "bitmap": bitmap_tensor(data.dd_test_bitmap, device),
    }


BACKENDS = ("auto", "xla", "pallas")


def resolve_backend(requested: str = "auto") -> str:
    """The sparse-op route: 'pallas' (the hand-written kernels on CUDA
    tensors, their plain versions on CPU tensors) or 'xla' (the JAX
    package's XLA branches, no kernel).  'auto' is 'pallas' on every
    device.  The JAX package's 'auto' picks 'xla' off the TPU, because
    there its Pallas kernels run only on the TPU (interpret mode elsewhere
    is a test harness); the port's kernels run on the card and their plain
    versions on the CPU, so 'pallas' runs everywhere and 'auto' never
    takes 'xla' on a CUDA device: only a caller that names 'xla' gets it."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown backend {requested!r}: one of {BACKENDS}")
    return "pallas" if requested == "auto" else requested


@dataclass(frozen=True)
class DDFamily:
    """The contract of the D-D model families (TIP, models/dd.py,
    models/decagon.py), static descriptions whose parameters live in
    explicit dicts.  A family writes ``init``, ``encode(params, graph,
    **kw)`` and ``_loss_sum(params, graph, z, seed, u24, **kw)`` (its BCE
    sum over the train edges); it inherits the loss frame, the test
    negatives, the evaluation and the DistMult or NN decoder.  ``loss``
    and ``evaluate`` call ``self.encode``, so an instance attribute of
    that name replaces it."""

    cfg: Any
    gs: GraphStatic
    device: torch.device
    backend: str = "pallas"

    def decoder_init(self, gen: torch.Generator) -> dict:
        cfg, gs = self.cfg, self.gs
        if cfg.decoder == "distmult":
            return distmult_init(gen, cfg.n_hid2, gs.n_et, device=self.device)
        return nn_decoder_init(gen, cfg.n_hid2, gs.n_et, cfg.nn_decoder_l1_dim,
                               device=self.device)

    def score(self, params, z, src, dst, et, sigmoid: bool = True):
        """Scores of (src, dst, relation) triples, flat (the eval's)."""
        apply = (distmult_apply if self.cfg.decoder == "distmult"
                 else nn_decoder_apply)
        return apply(params["decoder"], z, src, dst, et, sigmoid)

    def score_padded(self, params, z, src2d, dst2d, chunk_type, sigmoid=True):
        """Flat scores [n_chunks * chunk] of a chunk-aligned buffer (kernel
        B8 for DistMult, B9 for the NN decoder; gathers with 'xla')."""
        apply = (distmult_apply_padded if self.cfg.decoder == "distmult"
                 else nn_decoder_apply_padded)
        return apply(params["decoder"], z, src2d, dst2d, chunk_type, sigmoid,
                     kernel_dtype=self.cfg.kernel_dtype, backend=self.backend)

    def loss(self, params, graph, seed: int, u24=None, **kw):
        """Mean BCE over the train edges.  ``seed`` (uint32) keys the
        negatives, ``u24`` (CPU only) replaces their random bits; ``kw``
        reach ``encode`` and ``_loss_sum`` (TIP's ``mesh`` and ``remat``)."""
        with trace.span("forward"):
            z = self.encode(params, graph, **kw)
            with trace.span("loss"):
                total = self._loss_sum(params, graph, z, seed, u24, **kw)
                return trace.backward_span(total / float(self.gs.dd_n_valid))

    def sample_test_negatives(self, gen: torch.Generator, test):
        src, dst = typed_negative_sampling(gen, test["et"], test["bitmap"],
                                           self.gs.n_drug)
        return {"src": src, "dst": dst}

    @torch.no_grad()
    def evaluate(self, params, graph, test, test_neg):
        """Per-relation + macro AUPRC/AUROC/AP on the test split; the
        encoder runs on the train graph and test edges are only scored."""
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


def fused_dd_route(model) -> bool:
    """Whether the fused dense BCE serves the model's D-D layout, decoder
    and negatives (:func:`dd_loss_sum`)."""
    cfg = model.cfg
    return (model.gs.dd_layout != "chunked" and cfg.decoder == "distmult"
            and cfg.negatives != "sampled")


def dd_loss_sum(model, params, graph, z, seed: int, u24=None,
                fused: bool = True, score_ct=None, pages_pos: bool = True):
    """The BCE sum over the train edges of a D-D model with a DistMult or
    NN decoder (TIP, DR-DF, DR-NN), by route.

    Fused (:func:`fused_dd_route`, where ``fused``): positives plus
    Poissonized negatives from the fused dense BCE, kernel B1 on the
    strips, B2 on the pages (``u24`` is its cell field), each by its
    module-level name here, or its plain twin under ``backend="xla"``.
    Otherwise: one sampled negative per slot (kernel B10, by the global
    relation ids of ``dd_chunk_type``, the bitmap's layout; ``u24`` is the
    sampler's [n_chunks, 1, draws * chunk] draws) scored by the decoder's
    SDDMM (kernel B8 or B9) binned by ``score_ct`` (default
    ``dd_chunk_type``), positives scored by it over the chunk buffers,
    except DistMult's on the dense layouts where ``pages_pos``, which are
    scored over the full pages; softplus terms of slots masked by
    ``dd_valid``."""
    gs, cfg = model.gs, model.cfg
    if fused and fused_dd_route(model):
        w = params["decoder"]["weight"]
        xla = model.backend == "xla"
        if gs.dd_layout == "strips":
            bce = dense_bce_sym_sum_xla if xla else dense_bce_sym_sum
            return bce(w, z, graph["dd_adj_sym"], graph["dd_neg_q8"], seed,
                       u24=u24)
        bce = dense_bce_sum_xla if xla else dense_bce_sum
        return bce(w, z, graph["dd_adj_t"], graph["dd_neg_q"], seed, u24=u24)
    if cfg.negatives == "poisson":
        raise ValueError(POISSON_NEEDS_DENSE)
    ct = graph["dd_chunk_type"]
    neg_src2d, neg_dst2d = typed_negative_sampling_chunked(
        seed, ct, graph["dd_bitmap"], gs.n_drug, gs.n_et, gs.dd_chunk,
        u24=u24, backend=model.backend)
    if score_ct is None:
        score_ct = ct
    valid = graph["dd_valid"]
    if (pages_pos and gs.dd_layout != "chunked"
            and cfg.decoder == "distmult"):
        pos_sum = distmult_dense_pos_bce_sum(
            params["decoder"]["weight"], z, graph["dd_adj_t"],
            kernel_dtype=cfg.kernel_dtype)
    else:
        pos = model.score_padded(params, z, graph["dd_src2d"],
                                 graph["dd_dst2d"], score_ct, sigmoid=False)
        pos_sum = torch.sum(softplus(-pos) * valid)
    neg = model.score_padded(params, z, neg_src2d, neg_dst2d, score_ct,
                             sigmoid=False)
    return pos_sum + torch.sum(softplus(neg) * valid)


@dataclass(frozen=True)
class TIP(DDFamily):
    cfg: ModelConfig

    @staticmethod
    def for_data(cfg: ModelConfig, data: TriGraphData, gs: GraphStatic,
                 device=None, backend: str = "auto") -> "TIP":
        if data.n_et * bitmap_stride_bits(data.n_drug) >= 2**31:
            raise ValueError(
                "relation-strided key space exceeds int32; enable x64 keys")
        if cfg.decoder == "nn":
            # the fused dense BCEs are DistMult-only: the NN decoder takes
            # the sampled route on every layout (the JAX package raises
            # this when its loss finds no fused route)
            if cfg.negatives == "poisson":
                raise ValueError(POISSON_NEEDS_DENSE)
            if gs.dd_layout != "chunked" and not gs.dd_sampled:
                raise ValueError(
                    f"the NN decoder scores sampled negatives, which read the "
                    f"chunk buffers a {gs.dd_layout!r} graph packed for the "
                    "Poissonized route does not ship; pack with decoder='nn'")
        else:
            if gs.dd_layout != "chunked" and gs.dd_decoder != "distmult":
                raise ValueError(
                    f"a {gs.dd_layout!r} graph packed for the "
                    f"{gs.dd_decoder} decoder lacks what DistMult's loss "
                    "reads; pack with decoder='distmult'")
            check_negatives(cfg.negatives, gs)
        return TIP(cfg=cfg, gs=gs, device=resolve_device(device),
                   backend=resolve_backend(backend))

    def init(self, gen: torch.Generator) -> dict:
        gs = self.gs
        return {
            "encoder": fm_encoder_init(gen, self.cfg, gs.n_drug, gs.n_prot,
                                       gs.n_et, gs.drug_feat_dim or None,
                                       device=self.device),
            "decoder": self.decoder_init(gen),
        }

    def _ep_encoder_view(self, enc_params, graph, mesh):
        """(params, graph, gs) of an EP graph as fm_encoder_apply takes them.

        Under a mesh the rank's ``att`` [1, r_max, B] is its relation
        block: the strips and pages of the rank's view hold the same local
        rows; the chunked layer bins by the view's chunk bins over
        R = r_max and takes the rows in bin order (parallel/ep.py:
        local_bins).  Unsharded (the eval): the strips or pages are in slot
        order and M = sum_t att[t] DA[t] is the same in any relation order
        (padding slots: zero rows against zero pages), so ``att`` is
        reshaped to slot order as it is; without them ``att`` is gathered
        back to global order through ``ep_slot`` and the chunks are put in
        relation order (:func:`relation_ordered`)."""
        gs = self.gs
        if mesh is not None:
            if gs.dd_layout == "chunked":
                if "dd_chunk_bin" not in graph:
                    raise ValueError("an EP rank view without chunk bins: "
                                     "place it with place_graph(graph, mesh, "
                                     "gs)")
                rel = graph["ep_bin_rel"]
                graph = dict(graph, dd_chunk_type=graph["dd_chunk_bin"])

                def fix(att):
                    return att[0][rel]
            else:
                def fix(att):
                    return att[0]
            gs = dataclasses.replace(gs, n_et=gs.ep_r_max)
        elif gs.dd_layout != "chunked":
            def fix(att):
                return att.reshape(-1, att.shape[-1])
        else:
            slot = graph["ep_slot"].long()
            graph = relation_ordered(graph, gs.n_drug)

            def fix(att):
                return att.reshape(-1, att.shape[-1])[slot]
        out = dict(enc_params)
        for name in ("rgcn1", "rgcn2"):
            out[name] = dict(enc_params[name],
                             att=fix(enc_params[name]["att"]))
        return out, graph, gs

    def _ep_decoder_view(self, dec_params, graph, mesh):
        """The relation-row decoder leaves of EP params (DistMult
        ``weight``; the NN decoder's ``w1_l2``/``w2_l2``) as the scorers
        take them: under a mesh the rank's rows in bin order (the view's
        ``ep_bin_rel``), unsharded the global order through ``ep_slot``."""
        if mesh is not None:
            rel = graph["ep_bin_rel"]

            def fix(w):
                return w[0][rel]
        else:
            slot = graph["ep_slot"].long()

            def fix(w):
                return w.reshape(-1, w.shape[-1])[slot]
        return dict(dec_params, **{k: fix(dec_params[k])
                                   for k in _DECODER_REL_LEAVES
                                   if k in dec_params})

    def encode(self, params, graph, mesh=None, remat: bool = False):
        """Drug embeddings z [n_drug, n_hid2] from the training graph (this
        rank's view of it under ``mesh``; z is replicated).  ``remat``
        keeps none of the encoder's intermediates for the backward, which
        runs the whole encoder again (its kernels launch twice), as
        ``jax.checkpoint`` in the JAX package: memory for compute.  The
        recompute does not stop early, so under ``mesh`` it repeats every
        collective of the encoder (the R-GCN sums, the ring P-P GCN's
        kernel B11 steps or row gather, the hierarchy's sum) on every rank
        in the same order; the EP view of the parameters and the graph is
        taken outside the recomputed region."""
        enc_params, gs = params["encoder"], self.gs
        if gs.ep_r_max:
            enc_params, graph, gs = self._ep_encoder_view(enc_params, graph,
                                                          mesh)

        def enc(p):
            with trace.span("encode"):
                return fm_encoder_apply(p, graph, self.cfg, gs,
                                        x_drug=graph.get("drug_feat"),
                                        d_norm=graph.get("d_norm"), mesh=mesh,
                                        backend=self.backend)

        if not remat:
            return enc(enc_params)
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return torch.utils.checkpoint.checkpoint(enc, enc_params,
                                                     use_reentrant=False)

    def _loss_sum(self, params, graph, z, seed: int, u24, mesh=None,
                  remat: bool = False):
        """This rank's BCE sum over its train edges (:func:`dd_loss_sum`),
        summed over the ranks under ``mesh``, where ``graph`` is this
        rank's view and the seed is folded with the rank (``u24``: this
        rank's slice of the draws).  ``remat`` is :meth:`encode`'s."""
        gs = self.gs
        if mesh is not None:
            seed = fold_seed(seed, mesh.rank)
        fused, score_ct = (mesh is None) != (gs.ep_r_max > 0), None
        if gs.ep_r_max and fused and fused_dd_route(self):
            # the rank's decoder rows, in the order of its pages
            dec = params["decoder"]
            params = dict(params, decoder=dict(dec, weight=dec["weight"][0]))
        elif gs.ep_r_max:  # the sampled route, by rows in bin order
            if mesh is None:
                graph = relation_ordered(graph, gs.n_drug)
            else:
                score_ct = graph["dd_chunk_bin"]
            params = dict(params, decoder=self._ep_decoder_view(
                params["decoder"], graph, mesh))
        total = dd_loss_sum(self, params, graph, z, seed, u24, fused,
                            score_ct, pages_pos=not gs.ep_r_max)
        return total if mesh is None else psum(total)

    @torch.no_grad()
    def evaluate(self, params, graph, test, test_neg):
        """An EP graph is evaluated whole (parallel/ep.py:gather_params)."""
        if self.gs.ep_r_max:
            params = dict(params, decoder=self._ep_decoder_view(
                params["decoder"], graph, None))
        return super().evaluate(params, graph, test, test_neg)
