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

Sampled negatives (``negatives="sampled"``) on the strips or the pages
draw and score their negatives as the chunked layout does (B10, B8) and
score the positives over the full pages (plain PyTorch);
``make_graph_arrays(..., sampled=True)`` ships the chunk buffers, the
bitmap and the pages beside the strips.  The NN decoder
(``decoder="nn"``) takes that sampled route on every layout, as the JAX
package's TIP does (its fused dense BCEs are DistMult-only): B10 draws,
the NN-decoder SDDMM (kernel B9) scores the positives over the chunk
buffers and the negatives over the draws; ``make_graph_arrays(...,
decoder="nn")`` ships the encoder's layout, the chunk buffers and the
bitmap, and nothing else of the D-D side.  The
P-P side is dense (``pp_a1``, ``pp_dinv``) where ``pp_dense`` ships it,
else windowed (``ppw_*``, kernel B5).  Parameters are nested dicts of
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
from typing import Optional

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
    dense_pp_feasible,
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
    # encoder, uint8 full pages for DR-NN's loss, B3; models/dd.py only)
    dd_layout: str = "strips"
    # strips or pages packed for sampled negatives (dense_dd_arrays)
    dd_sampled: bool = False
    # the decoder whose loss the D-D side was packed for
    dd_decoder: str = "distmult"
    # 'dense' (pp_a1, pp_dinv) | 'windowed' (ppw_*, B5) | 'none' (no P-P
    # side: models/dd.py, or a sharded graph whose P-P side is the ring)
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

    def t(x):
        return torch.from_numpy(x).to(device)

    out, layout = {}, "pages"
    if dense_dtype == "bfloat16":
        try:
            out["dd_adj_sym"] = t(sym_strip_pack(da))
            layout = "strips"
        except ValueError:  # asymmetric pages or counts past int8
            pass
    if layout == "pages" or (sampled and decoder == "distmult"):
        out["dd_adj_t"] = pages_tensor(da, dense_dtype, device)
    if not sampled:
        if layout == "strips" and decoder == "distmult":
            out["dd_neg_q8"] = t(poisson_neg_thresholds_sym(data.dd_train,
                                                            data.n_drug))
        else:
            out["dd_neg_q"] = t(poisson_neg_thresholds(data.dd_train,
                                                       data.n_drug))
        if decoder == "nn" and layout == "strips":
            out["dd_adj_u8"] = t(cast_dense_adj(da, "uint8"))
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

    def t(x):
        return torch.from_numpy(x).to(device)

    return {
        "dd_src2d": t(padded.src.reshape(n_chunks, dd_chunk)),
        "dd_dst2d": t(padded.dst.reshape(n_chunks, dd_chunk)),
        "dd_valid": t(padded.valid.astype("float32")),
        "dd_chunk_type": t(padded.chunk_type),
        "dd_bitmap": bitmap_tensor(data.dd_train_bitmap, device),
    }


@trace.spanned("device_graph")
def make_graph_arrays(data: TriGraphData, device=None, dd_chunk: int = 1024,
                      pp_window: int = 1024, pp_chunk: int = 512,
                      dense_dtype: Optional[str] = None,
                      pp_dense: Optional[bool] = None, sampled: bool = False,
                      decoder: str = "distmult"):
    """Pack the training graph into tensors on ``device`` + static metadata.

    ``dense_dtype="bfloat16"`` ships the D-D symmetric strips, or, where
    they cannot be built (an asymmetric page, a count past int8), the full
    bf16 pages as the JAX package falls back; "float32" ships the full
    float32 pages (:func:`dense_dd_arrays`); None ships the chunked D-D
    buffers (relation bins padded to ``dd_chunk``) and the train bitmap.
    ``sampled`` packs the strips or pages for ``negatives="sampled"``: the
    chunk buffers and the bitmap beside them, and no Poissonized
    thresholds.  ``decoder="nn"`` packs for TIP's NN decoder, which takes
    the sampled route on every layout: the encoder's strips or pages, the
    chunk buffers and the bitmap, nothing more (``sampled`` is implied).
    ``pp_dense`` (default: ``dense_dtype is not None``) ships
    the dense int8 (A+I) P-P parts where feasible and free of duplicates,
    else the P-P edges windowed by ``pp_window`` and padded to
    ``pp_chunk`` (kernel B5) and the COO edges (``backend="xla"``)."""
    if dense_dtype not in (None, "bfloat16", "float32"):
        raise ValueError(f"dense_dtype {dense_dtype!r}: None, 'bfloat16' or "
                         "'float32'")
    if decoder not in ("distmult", "nn"):
        raise ValueError(f"unknown decoder {decoder!r}")
    sampled = sampled or decoder == "nn"

    def t(x):
        return torch.from_numpy(x).to(device)

    graph = {
        "dd_deg": t(data.dd_train_deg),
        "dp_src": t(data.dp_edge_index[0].astype("int64")),
        "dp_dst": t(data.dp_edge_index[1].astype("int64")),
        "dp_deg": t(data.dp_drug_deg),
    }
    layout = "chunked"
    if dense_dtype is not None:
        layout, dd = dense_dd_arrays(data, dense_dtype, device, sampled,
                                     decoder)
        graph.update(dd)
    if layout == "chunked" or sampled:
        graph.update(chunk_arrays(data, dd_chunk, device))
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
            # the COO edges of backend="xla" (nn/encoders.py)
            pp_norm_index=t(data.pp_norm_index.astype("int64")),
            pp_norm_weight=t(data.pp_norm_weight),
        )
    if data.drug_feat is not None:
        graph["drug_feat"] = t(data.drug_feat)
    if data.d_norm is not None:
        graph["d_norm"] = t(data.d_norm)
    gs = GraphStatic(
        n_drug=data.n_drug, n_prot=data.n_prot, n_et=data.n_et,
        dd_n_valid=data.dd_train.n_edges,
        drug_feat_dim=0 if data.drug_feat is None else data.drug_feat.shape[1],
        dd_chunk=dd_chunk, pp_window=pp_window,
        dd_n_chunks=graph["dd_src2d"].shape[0] if "dd_src2d" in graph else 0,
        pp_n_windows=wpp.n_windows, dd_layout=layout,
        dd_sampled=sampled and layout != "chunked", dd_decoder=decoder,
        pp_layout="windowed" if a1 is None else "dense",
    )
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
        "src": torch.from_numpy(src.astype("int64")).to(device),
        "dst": torch.from_numpy(dst.astype("int64")).to(device),
        "et": torch.from_numpy(data.dd_test.edge_type.astype("int64")).to(device),
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
class TIP:
    """Static model description; parameters live in explicit dicts."""

    cfg: ModelConfig
    gs: GraphStatic
    device: torch.device
    backend: str = "pallas"

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
            "decoder": (
                distmult_init(gen, self.cfg.n_hid2, gs.n_et, device=self.device)
                if self.cfg.decoder == "distmult" else
                nn_decoder_init(gen, self.cfg.n_hid2, gs.n_et,
                                self.cfg.nn_decoder_l1_dim, device=self.device)),
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

    def loss(self, params, graph, seed: int, u24=None, mesh=None,
             remat: bool = False):
        """Mean BCE over the train edges.  ``seed`` (uint32) keys the
        negatives; ``u24`` replaces their random bits: the fused dense
        BCEs' cell field (CPU only), or the sampler's draws (kernel B10
        reads them on the card; not the xla route's).

        DistMult on the strips or pages with ``negatives`` auto or poisson:
        positives plus Poissonized negatives from the fused dense BCE,
        kernel B1 on the strips, B2 on the pages (``u24`` is its cell
        field).  Otherwise (the chunked layout, ``negatives="sampled"``, the
        NN decoder, or an EP graph unsharded): one sampled negative per
        slot (kernel B10; ``u24`` is the sampler's [n_chunks, 1, draws *
        chunk] draws) scored by the decoder's SDDMM (kernel B8 or B9),
        positives scored by it over the chunk buffers, except DistMult's on
        the dense layouts without EP, which are scored over the full pages;
        softplus terms of slots masked by ``dd_valid``.

        Under ``mesh``: the chunked layout, or any EP-laid one; ``graph``
        is this rank's view, the seed is folded with the rank (``u24``:
        this rank's slice of the draws), and the sums are summed over the
        ranks before the division, so every rank returns the same loss.
        ``remat``: see :meth:`encode`, with or without ``mesh``."""
        with trace.span("forward"):
            if mesh is not None:
                seed = fold_seed(seed, mesh.rank)
            z = self.encode(params, graph, mesh, remat=remat)
            with trace.span("loss"):
                total = self._loss_sum(params, graph, z, seed, u24, mesh)
                if mesh is not None:
                    total = psum(total)
                return trace.backward_span(total / float(self.gs.dd_n_valid))

    def _loss_sum(self, params, graph, z, seed: int, u24, mesh):
        """This rank's BCE sum over its train edges (:meth:`loss`)."""
        gs, cfg = self.gs, self.cfg
        ep = gs.ep_r_max > 0
        if (gs.dd_layout != "chunked" and cfg.decoder == "distmult"
                and cfg.negatives != "sampled" and (mesh is None) != ep):
            w = params["decoder"]["weight"]
            if ep:
                w = w[0]  # the rank's rows, in the order of its pages
            xla = self.backend == "xla"
            if gs.dd_layout == "strips":
                bce = dense_bce_sym_sum_xla if xla else dense_bce_sym_sum
                return bce(w, z, graph["dd_adj_sym"], graph["dd_neg_q8"],
                           seed, u24=u24)
            bce = dense_bce_sum_xla if xla else dense_bce_sum
            return bce(w, z, graph["dd_adj_t"], graph["dd_neg_q"], seed,
                       u24=u24)
        if cfg.negatives == "poisson":
            raise ValueError(POISSON_NEEDS_DENSE)
        dec_params, score_ct = params, graph["dd_chunk_type"]
        if ep:
            if mesh is None:
                graph = relation_ordered(graph, gs.n_drug)
                score_ct = graph["dd_chunk_type"]
            else:
                score_ct = graph["dd_chunk_bin"]
            dec_params = dict(params, decoder=self._ep_decoder_view(
                params["decoder"], graph, mesh))
        # sampled by GLOBAL relation id: the bitmap's layout
        neg_src2d, neg_dst2d = typed_negative_sampling_chunked(
            seed, graph["dd_chunk_type"], graph["dd_bitmap"], gs.n_drug,
            gs.n_et, gs.dd_chunk, u24=u24, backend=self.backend)
        valid = graph["dd_valid"]
        if gs.dd_layout == "chunked" or cfg.decoder == "nn" or ep:
            pos = self.score_padded(dec_params, z, graph["dd_src2d"],
                                    graph["dd_dst2d"], score_ct, sigmoid=False)
            pos_sum = torch.sum(softplus(-pos) * valid)
        else:
            pos_sum = distmult_dense_pos_bce_sum(
                params["decoder"]["weight"], z, graph["dd_adj_t"],
                kernel_dtype=cfg.kernel_dtype)
        neg = self.score_padded(dec_params, z, neg_src2d, neg_dst2d, score_ct,
                                sigmoid=False)
        return pos_sum + torch.sum(softplus(neg) * valid)

    def sample_test_negatives(self, gen: torch.Generator, test):
        src, dst = typed_negative_sampling(gen, test["et"], test["bitmap"],
                                           self.gs.n_drug)
        return {"src": src, "dst": dst}

    @torch.no_grad()
    def evaluate(self, params, graph, test, test_neg):
        """Per-relation + macro AUPRC/AUROC/AP on the test split; the
        encoder runs on the train graph and test edges are only scored.  An
        EP graph is evaluated whole: its params in the [n_dev, r_max, ...]
        layout (parallel/ep.py:gather_params), no mesh."""
        with trace.span("eval"):
            z = self.encode(params, graph)
            if self.gs.ep_r_max:
                params = dict(params, decoder=self._ep_decoder_view(
                    params["decoder"], graph, None))
            with trace.span("score"):
                pos = self.score(params, z, test["src"], test["dst"],
                                 test["et"])
                neg = self.score(params, z, test_neg["src"], test_neg["dst"],
                                 test["et"])
            with trace.span("rank"):
                per_rel = grouped_ranking_metrics(pos, neg, test["et"],
                                                  self.gs.n_et)
                return per_rel, macro_average(per_rel)
