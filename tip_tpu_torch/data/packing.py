"""Host-side graph packing: splits, type-binned sorting, degrees, the
symmetric int8 strip layout, negative thresholds, dense P-P parts, the
chunk-aligned D-D and windowed P-P edge buffers of the chunked layout, and
the relation-strided membership bitmaps.

A copy of what the port's training paths need from tip_tpu/data/packing.py
and tip_tpu/sampling/negative.py (bitmap layout).  The edge sort, the
in-degree count, the padded fill and the bitmap build run in the port's
native library (tip_tpu_torch/native, as the JAX package's do in
tip_tpu/native); the rest is numpy.  Every
output is bit-identical to the JAX package's on the same raw graph
(tests/test_torch_packing.py).  Layout recap:

  * **type-binned**: edges of relation ``t`` occupy the contiguous slice
    ``range_list[t] = (start, end)``;
  * **destination-sorted within each bin**, so ``type * n + dst`` is
    non-decreasing over the whole buffer;
  * the 90/10 split is a per-relation Bernoulli over the unique pairs, then
    both directions of every kept pair enter the same split.

One deliberate difference from the JAX package: :func:`dense_relation_adj`
counts relation by relation instead of with one ``[R * n * n]`` int64
``bincount`` (3.6 GB of host memory at Decagon shape); the result is the
same array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from tip_tpu_torch import native

SYM_BLOCK = 128  # square block edge of the symmetric strip layout

# One bitmap tile of the JAX sampler's layout: 8 x 128 uint32 words.  The
# port keeps the same relation stride so both packages share one bitmap.
_TILE_BITS = 8 * 128 * 32


@dataclass
class TypedEdges:
    """A type-binned edge buffer over a single node set.

    edge_index: [2, E] int32 (src, dst) — directed; undirected relations
        store both directions.
    edge_type:  [E] int32 — compact relation id in [0, n_et).
    range_list: [n_et, 2] int32 — (start, end) slice per relation.
    """

    edge_index: np.ndarray
    edge_type: np.ndarray
    range_list: np.ndarray

    @property
    def n_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def n_et(self) -> int:
        return int(self.range_list.shape[0])

    def counts(self) -> np.ndarray:
        return self.range_list[:, 1] - self.range_list[:, 0]


def _ranges_from_counts(counts: np.ndarray) -> np.ndarray:
    ends = np.cumsum(counts)
    starts = ends - counts
    return np.stack([starts, ends], axis=1).astype(np.int32)


def concat_typed(pair_list: List[np.ndarray]) -> TypedEdges:
    """Concatenate per-relation [2, nnz_t] pair arrays into one typed buffer."""
    counts = np.array([p.shape[1] for p in pair_list], dtype=np.int64)
    edge_index = (
        np.concatenate(pair_list, axis=1).astype(np.int32)
        if pair_list
        else np.zeros((2, 0), np.int32)
    )
    edge_type = np.repeat(np.arange(len(pair_list), dtype=np.int32), counts)
    return TypedEdges(edge_index, edge_type, _ranges_from_counts(counts))


def to_bidirected(pairs: np.ndarray) -> np.ndarray:
    """[2, m] pairs -> [2, 2m] with both directions."""
    return np.concatenate([pairs, pairs[::-1]], axis=1)


def split_typed_edges(
    pair_list: List[np.ndarray],
    p: float = 0.9,
    seed: int = 1111,
    bidirect: bool = True,
) -> Tuple[TypedEdges, TypedEdges]:
    """Per-relation Bernoulli(p) split of unique pairs, then mirror each side."""
    rng = np.random.default_rng(seed)
    train_list, test_list = [], []
    for pairs in pair_list:
        m = pairs.shape[1]
        keep = rng.random(m) < p
        tr, te = pairs[:, keep], pairs[:, ~keep]
        if bidirect:
            tr, te = to_bidirected(tr), to_bidirected(te)
        train_list.append(tr)
        test_list.append(te)
    return concat_typed(train_list), concat_typed(test_list)


def sort_typed_edges(edges: TypedEdges) -> TypedEdges:
    """Sort within each relation bin by (dst, src): the buffer is then
    globally sorted by the segment id ``type * n_nodes + dst``."""
    src, dst = edges.edge_index
    n_nodes = int(max(src.max(), dst.max())) + 1 if src.size else 1
    order = native.sort_edges_order(edges.edge_type, dst, src, n_nodes)
    return TypedEdges(
        edges.edge_index[:, order].copy(), edges.edge_type[order].copy(),
        edges.range_list,
    )


def in_degree(edge_index: np.ndarray, n_nodes: int) -> np.ndarray:
    """Total in-degree per destination across ALL relations (the R-GCN's
    mean-aggregation denominator), int64."""
    return native.bincount_i32(edge_index[1], n_nodes)


def encode_keys(edges: TypedEdges, n_nodes: int) -> np.ndarray:
    """Unique int64 key per edge, encoded (type, dst, src) to match the sort
    order of :func:`sort_typed_edges` — ascending over the sorted buffer."""
    src, dst = edges.edge_index.astype(np.int64)
    return (edges.edge_type.astype(np.int64) * n_nodes + dst) * n_nodes + src


def max_multiplicity(edges: TypedEdges, n_nodes: int) -> int:
    """Largest (type, dst, src) duplicate count."""
    keys = np.sort(encode_keys(edges, n_nodes))
    if keys.size == 0:
        return 0
    change = np.flatnonzero(np.diff(keys)) + 1
    bounds = np.concatenate([[0], change, [keys.size]])
    return int(np.max(np.diff(bounds)))


@dataclass
class PaddedTypedEdges:
    """Chunk-aligned padding of a TypedEdges buffer for the chunked kernels.

    Each relation bin is padded to a multiple of ``chunk`` (at least one
    chunk); padded slots get ``dst = n_nodes`` (one past the last valid
    node) and ``src = 0``.  ``chunk_type[i]`` is the relation owning chunk
    ``i``: no chunk straddles two relations.
    """

    src: np.ndarray  # [Ep] int32
    dst: np.ndarray  # [Ep] int32 (n_nodes for padding)
    chunk_type: np.ndarray  # [Ep // chunk] int32
    range_list: np.ndarray  # [n_et, 2] int32 ranges in the PADDED buffer
    valid: np.ndarray  # [Ep] bool
    chunk: int
    n_valid: int


def pad_typed_edges(edges: TypedEdges, n_nodes: int,
                    chunk: int = 512) -> PaddedTypedEdges:
    """Pad every relation bin of a type-binned buffer to whole chunks."""
    counts = edges.counts()
    padded_counts = np.maximum(1, -(-counts // chunk)) * chunk
    total = int(padded_counts.sum())
    new_ranges = _ranges_from_counts(padded_counts)
    src, dst, valid = native.pad_typed_fill(
        edges.edge_index[0], edges.edge_index[1], edges.range_list,
        new_ranges[:, 0], total, n_nodes)
    chunk_type = np.repeat(np.arange(edges.n_et, dtype=np.int32),
                           padded_counts // chunk)
    return PaddedTypedEdges(src=src, dst=dst, chunk_type=chunk_type,
                            range_list=new_ranges, valid=valid, chunk=chunk,
                            n_valid=edges.n_edges)


@dataclass
class WindowedEdges:
    """Destination-windowed, chunk-aligned edge buffer for the P-P SpMM.

    Edges are grouped by destination window (``dst // window``); each
    window's edge list is padded to a multiple of ``chunk`` (at least one
    chunk) so no chunk straddles a window.  ``dst_local`` is the in-window
    destination; ``window`` itself marks padding, whose weight is 0.
    """

    src: np.ndarray  # [Ep] int32 (padding: 0)
    dst_local: np.ndarray  # [Ep] int32 (padding: window)
    weight: np.ndarray  # [Ep] float32 (padding: 0)
    chunk_window: np.ndarray  # [n_chunks] int32, non-decreasing
    window: int
    chunk: int
    n_windows: int
    n_valid: int


def pad_windowed_edges(edge_index: np.ndarray, weight: Optional[np.ndarray],
                       n_nodes: int, window: int = 512,
                       chunk: int = 512) -> WindowedEdges:
    """Window a dst-sorted weighted edge list for the windowed SpMM."""
    src, dst = edge_index
    if np.any(np.diff(dst) < 0):
        raise ValueError("edges must be dst-sorted")
    if weight is None:
        weight = np.ones(src.shape[0], np.float32)
    n_windows = -(-n_nodes // window)
    counts = np.bincount(dst // window, minlength=n_windows)
    padded_counts = np.maximum(1, -(-counts // chunk)) * chunk
    total = int(padded_counts.sum())
    starts = np.cumsum(padded_counts) - padded_counts
    in_starts = np.cumsum(counts) - counts
    p_src = np.zeros(total, np.int32)
    p_dst = np.full(total, window, np.int32)
    p_w = np.zeros(total, np.float32)
    for wi in range(n_windows):
        n, s_in, s_out = counts[wi], in_starts[wi], starts[wi]
        p_src[s_out:s_out + n] = src[s_in:s_in + n]
        p_dst[s_out:s_out + n] = dst[s_in:s_in + n] - wi * window
        p_w[s_out:s_out + n] = weight[s_in:s_in + n]
    chunk_window = np.repeat(np.arange(n_windows, dtype=np.int32),
                             padded_counts // chunk)
    return WindowedEdges(src=p_src, dst_local=p_dst, weight=p_w,
                         chunk_window=chunk_window, window=window,
                         chunk=chunk, n_windows=n_windows,
                         n_valid=src.shape[0])


def dense_relation_adj(edges: TypedEdges, n_nodes: int) -> np.ndarray:
    """Dense per-relation adjacency DA [n_et, n_nodes(dst), n_nodes(src)]
    uint16: ``DA[t, d, s]`` counts directed edges s->d of relation t.

    Counted one relation bin at a time, so host memory stays at the output
    size; raises where a multiplicity does not fit uint16."""
    n_et = edges.n_et
    if int(edges.counts().sum()) != edges.n_edges:
        raise ValueError("range_list does not cover every edge")
    out = np.zeros((n_et, n_nodes, n_nodes), np.uint16)
    src, dst = edges.edge_index
    et = edges.edge_type
    for t in range(n_et):
        s, e = (int(x) for x in edges.range_list[t])
        if e == s:
            continue
        if np.any(et[s:e] != t):
            raise ValueError(f"edges of relation {t} are not binned at "
                             "range_list[t]")
        flat = dst[s:e].astype(np.int64) * n_nodes + src[s:e]
        counts = np.bincount(flat, minlength=n_nodes * n_nodes)
        if counts.max() >= 2**16:
            raise ValueError("edge multiplicity exceeds uint16")
        out[t] = counts.reshape(n_nodes, n_nodes)
    return out


def sym_block_layout(n_nodes: int, block: int = SYM_BLOCK):
    """(nb, [(I, J)] with I <= J): the stored upper block triangle of an
    [n, n] plane cut into nb = ceil(n / block) block rows."""
    nb = -(-n_nodes // block)
    return nb, [(i, j) for i in range(nb) for j in range(i, nb)]


def sym_strip_offsets(nb: int, block: int = SYM_BLOCK):
    """Column offset of each block-row strip in the packed strip layout:
    prefix sums of the decreasing strip widths (nb - I) * block."""
    widths = [(nb - i) * block for i in range(nb)]
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)
    return offs, widths


def nb_from_cols(totcols: int, block: int = SYM_BLOCK) -> int:
    """Number of block rows of a packed strip width NB * block."""
    n_blk = totcols // block
    nb = int(round(((8 * n_blk + 1) ** 0.5 - 1) / 2))
    if nb * (nb + 1) // 2 != n_blk or totcols % block:
        raise ValueError(f"{totcols} is not a triangular strip width")
    return nb


def sym_strip_pack(da: np.ndarray, block: int = SYM_BLOCK) -> np.ndarray:
    """Pack symmetric count pages [R, n, n] -> strips [R, block, NB*block]
    int8 (NB = nb(nb+1)/2 upper-triangle blocks, nb = ceil(n/block)).

    Strip I (columns sym_strip_offsets[I]..+width) is the contiguous
    upper-triangle tail of block-row I: its first ``block`` columns are the
    diagonal block (cells stand for themselves), the rest stand for
    themselves AND their mirrors.  Cells past n are zero.  Raises if any
    page is not symmetric or any count exceeds int8.
    """
    r, n, n2 = da.shape
    if n != n2:
        raise ValueError(f"pages must be square, got {da.shape}")
    nb, _ = sym_block_layout(n, block)
    if da.size and int(da.max()) > 127:
        raise ValueError("count exceeds int8; use the full dense layout")
    offs, _ = sym_strip_offsets(nb, block)
    out = np.zeros((r, block, int(offs[-1])), np.int8)
    pad = nb * block - n
    for t in range(r):  # per page to bound host memory
        page = np.pad(da[t], ((0, pad), (0, pad)))
        if not np.array_equal(page, page.T):
            raise ValueError(
                f"relation page {t} is not symmetric; the symmetric packed "
                "layout requires mirrored undirected edges"
            )
        for i in range(nb):
            out[t, :, offs[i]:offs[i + 1]] = page[
                i * block:(i + 1) * block, i * block:
            ]
    return out


def _per_relation_counts(edges: TypedEdges, n_nodes: int):
    """(m_t directed train edges, nonpos_t non-positive cells) per relation."""
    n_et = edges.n_et
    m = np.bincount(edges.edge_type, minlength=n_et).astype(np.float64)
    keys = encode_keys(edges, n_nodes)
    if keys.size:
        order = np.argsort(keys, kind="stable")
        first = np.concatenate([[True], np.diff(keys[order]) != 0])
        distinct = np.bincount(
            edges.edge_type[order][first], minlength=n_et
        ).astype(np.float64)
    else:
        distinct = np.zeros(n_et, np.float64)
    nonpos = np.maximum(float(n_nodes) ** 2 - distinct, 1.0)
    return m, nonpos


def _binom_tail_thresholds(m, p, kmax: int) -> np.ndarray:
    """floor(P(X >= k) * 2^24) for k = 1..kmax, X ~ Binomial(m, p), via the
    log-pmf recurrence in float64."""
    m = np.asarray(m, np.float64)
    p = np.asarray(p, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        log1mp = np.log1p(-p)
        pmf = np.exp(m * log1mp)  # P(X = 0)
        cdf = pmf.copy()
        qs = []
        for k in range(1, kmax + 1):
            qs.append(1.0 - cdf)
            # P(X = k) = P(X = k-1) * (m - k + 1)/k * p/(1-p)
            ratio = np.where(
                (m >= k) & (p < 1.0),
                (m - k + 1) / k * p / np.maximum(1.0 - p, 1e-300),
                0.0,
            )
            pmf = pmf * ratio
            cdf = cdf + pmf
    q = np.stack(qs, axis=1)
    return np.floor(np.clip(q, 0.0, 1.0) * (1 << 24)).astype(np.int32)


def poisson_neg_thresholds_sym(edges: TypedEdges, n_nodes: int) -> np.ndarray:
    """Per-relation thresholds of the symmetric fused dense BCE
    (ops/dense_bce_sym.py): int32 [n_et, 8] =
    [single-rate q_1..q_4 | doubled-rate q_1..q_4] * 2^24.

    Diagonal-block cells draw X ~ Binomial(m_t, 1/nonpos_t); off-diagonal
    stored cells stand for a mirrored pair and draw at the doubled rate.
    """
    m, nonpos = _per_relation_counts(edges, n_nodes)
    qs = _binom_tail_thresholds(m, 1.0 / nonpos, 4)
    qd = _binom_tail_thresholds(m, np.minimum(2.0 / nonpos, 1.0), 4)
    return np.concatenate([qs, qd], axis=1)


def poisson_neg_thresholds(edges: TypedEdges, n_nodes: int) -> np.ndarray:
    """Per-relation thresholds of the full-page fused dense BCE
    (ops/dense_bce_nn.py): int32 [n_et, 3] = floor(P(X >= k) * 2^24) for
    k = 1..3, X ~ Binomial(m_t, 1/nonpos_t).  A cell's count
    sum_k 1[u24 < q_k] is exactly min(X, 3)."""
    m, nonpos = _per_relation_counts(edges, n_nodes)
    return _binom_tail_thresholds(m, 1.0 / nonpos, 3)


# Largest count each full-page dtype holds exactly.
PAGE_EXACT_MAX = {"uint8": 255, "bfloat16": 256, "float32": 1 << 24}


def cast_dense_adj(da: np.ndarray, dtype: str = "uint8") -> np.ndarray:
    """The count pages [R, n, n] (dense_relation_adj) in the page dtype,
    unpadded; raises where a count is past the dtype's exact range rather
    than cast lossily.

    ``uint8`` holds counts up to 255 and is what the NN decoder's dense BCE
    (kernel B3) reads beside DR-NN's strips; ``bfloat16`` holds them up to
    256 and ``float32`` up to 2^24: the full pages of the encoder and of
    kernels B2 and B3.  numpy has no
    bfloat16, so those pages come back as their bit patterns in uint16
    (the upper half of each float32, exact for these counts);
    ``torch.from_numpy(p).view(torch.bfloat16)`` reads them.  Page bytes
    at Decagon shape (R = 1,097, n = 645): uint8 456 MB, bf16 913 MB,
    float32 1.83 GB (the JAX package's tile-padded bf16 pages [1097, 656,
    768] take 1.105 GB)."""
    name = "bfloat16" if str(dtype) == "bfloat16" else np.dtype(dtype).name
    if name not in PAGE_EXACT_MAX:
        raise ValueError(f"page dtype {name} not in {sorted(PAGE_EXACT_MAX)}")
    top = int(da.max()) if da.size else 0
    if top > PAGE_EXACT_MAX[name]:
        raise ValueError(
            f"edge multiplicity {top} is not exactly representable in {name}; "
            "use a wider page dtype or the chunked kernels")
    if name == "bfloat16":
        return (da.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    return da.astype(name)


def dense_pp_feasible(n_nodes: int) -> bool:
    """Whether the [n_nodes, n_nodes] dense int8 (A+I) fits ~1 GB."""
    return n_nodes * n_nodes * 1 <= 1.0e9


def dense_pp_parts(pp_norm_index: np.ndarray, n_nodes: int):
    """Dense (A + I) in int8 plus the float32 D^-1/2 diagonal, so that
    A_hat @ x = dinv * ((A+I) @ (dinv * x)) exactly.  Raises on duplicate
    entries, which a 0/1 matrix cannot hold."""
    a1 = np.zeros((n_nodes, n_nodes), np.uint8)
    a1[pp_norm_index[1], pp_norm_index[0]] = 1
    deg = a1.sum(axis=1, dtype=np.int64)
    if int(deg.sum()) != pp_norm_index.shape[1]:
        raise ValueError(
            "P-P normalized edge list contains duplicate entries; the dense "
            "0/1 (A+I) path cannot represent edge multiplicity"
        )
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1)), 0.0)
    return a1.astype(np.int8), dinv.astype(np.float32)


def gcn_normalize(
    edge_index: np.ndarray, n_nodes: int, add_self_loops: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (edge_index', weight) for D^-1/2 (A + I) D^-1/2, degrees
    including the self loop, destination-sorted."""
    if add_self_loops:
        loops = np.tile(np.arange(n_nodes, dtype=np.int32), (2, 1))
        edge_index = np.concatenate([edge_index.astype(np.int32), loops], axis=1)
    deg = np.bincount(edge_index[1], minlength=n_nodes).astype(np.float64)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1)), 0.0)
    weight = (dinv[edge_index[0]] * dinv[edge_index[1]]).astype(np.float32)
    order = np.lexsort((edge_index[0], edge_index[1]))
    return edge_index[:, order].copy(), weight[order].copy()


def split_pp_edges(
    pp_edge_index: np.ndarray, p: float = 0.9, seed: int = 1111
) -> Tuple[np.ndarray, np.ndarray]:
    """Dedup symmetric P-P edges (src > dst), Bernoulli split the unique
    pairs, re-mirror each side."""
    keep = pp_edge_index[0] > pp_edge_index[1]
    pairs = pp_edge_index[:, keep]
    rng = np.random.default_rng(seed + 7)
    mask = rng.random(pairs.shape[1]) < p
    return to_bidirected(pairs[:, mask]), to_bidirected(pairs[:, ~mask])


def bitmap_stride_bits(n_nodes: int) -> int:
    """Bits reserved per relation: n_nodes^2 rounded up to whole tiles."""
    return -(-(n_nodes * n_nodes) // _TILE_BITS) * _TILE_BITS


def build_key_bitmap(keys: np.ndarray, key_space: int) -> np.ndarray:
    """Pack bit positions into a uint32 bitmap [ceil(key_space / 32)]."""
    return native.build_bitmap(np.asarray(keys, np.int64), key_space)


def build_typed_bitmap(
    edge_index: np.ndarray, edge_type: np.ndarray, n_nodes: int, n_et: int
) -> np.ndarray:
    """Relation-strided membership bitmap of (type, dst, src) edges:
    bit ``type * stride + dst * n + src``, uint32 words."""
    stride = bitmap_stride_bits(n_nodes)
    src, dst = edge_index.astype(np.int64)
    bits = edge_type.astype(np.int64) * stride + dst * n_nodes + src
    return build_key_bitmap(bits, n_et * stride)


@dataclass
class TriGraphData:
    """Everything the TIP model consumes, as static-shape numpy arrays."""

    n_drug: int
    n_prot: int
    n_et: int

    # D-D multigraph (type-binned, dst-sorted within bins)
    dd_train: TypedEdges
    dd_test: TypedEdges
    dd_train_deg: np.ndarray  # [n_drug] total in-degree over train edges
    dd_train_keys: np.ndarray  # [E_train] int64 sorted (type,dst,src) keys
    dd_test_keys: np.ndarray  # [E_test] int64 sorted keys
    dd_train_bitmap: np.ndarray  # packed uint32 membership bitmap (train keys)
    dd_test_bitmap: np.ndarray  # packed uint32 membership bitmap (test keys)

    # P-P graph: raw symmetric train/test edges + cached GCN normalization
    pp_train: np.ndarray  # [2, Epp_train]
    pp_test: np.ndarray  # [2, Epp_test]
    pp_norm_index: np.ndarray  # [2, Epp_train + n_prot] dst-sorted, self loops
    pp_norm_weight: np.ndarray  # [Epp_train + n_prot] float32

    # P->D bipartite edges (protein src, drug dst), dst-sorted
    dp_edge_index: np.ndarray  # [2, Edp]
    dp_drug_deg: np.ndarray  # [n_drug]

    # Optional general drug feature matrix [n_drug, n_drug + n_mono]
    # (None => identity fast path)
    drug_feat: Optional[np.ndarray] = None
    d_norm: Optional[np.ndarray] = None  # [n_drug] divisor (ones by default)


def build_trigraph(raw, split_rate: float = 0.9, seed: int = 1111) -> TriGraphData:
    """Pack a DecagonRaw into the model-ready TriGraphData."""
    dd_train, dd_test = split_typed_edges(raw.dd_pair_list, p=split_rate, seed=seed)
    dd_train = sort_typed_edges(dd_train)
    dd_test = sort_typed_edges(dd_test)

    pp_train, pp_test = split_pp_edges(raw.pp_edge_index, p=split_rate, seed=seed)
    pp_norm_index, pp_norm_weight = gcn_normalize(pp_train, raw.n_prot)

    dp = raw.dp_edge_index
    dp = dp[:, np.lexsort((dp[0], dp[1]))].copy()

    drug_feat = None
    if getattr(raw, "drug_mono", None) is not None:
        mono = np.asarray(raw.drug_mono.todense(), np.float32)
        drug_feat = np.concatenate(
            [np.eye(raw.n_drug, dtype=np.float32), mono], axis=1
        )
    n_et = len(raw.dd_pair_list)
    return TriGraphData(
        n_drug=raw.n_drug,
        n_prot=raw.n_prot,
        n_et=n_et,
        dd_train=dd_train,
        dd_test=dd_test,
        dd_train_deg=in_degree(dd_train.edge_index, raw.n_drug),
        dd_train_keys=encode_keys(dd_train, raw.n_drug),
        dd_test_keys=encode_keys(dd_test, raw.n_drug),
        dd_train_bitmap=build_typed_bitmap(
            dd_train.edge_index, dd_train.edge_type, raw.n_drug, n_et),
        dd_test_bitmap=build_typed_bitmap(
            dd_test.edge_index, dd_test.edge_type, raw.n_drug, n_et),
        pp_train=pp_train,
        pp_test=pp_test,
        pp_norm_index=pp_norm_index,
        pp_norm_weight=pp_norm_weight,
        dp_edge_index=dp,
        dp_drug_deg=in_degree(dp, raw.n_drug),
        drug_feat=drug_feat,
    )


def synthetic_trigraph(
    n_drug: int = 64,
    n_prot: int = 128,
    n_et: int = 7,
    pairs_per_et: int = 40,
    n_pp_pairs: int = 300,
    n_dp: int = 100,
    seed: int = 0,
):
    """A random tri-graph with the same invariants (the same draws as the
    JAX package's, so both give one graph per seed).

    Each relation's pairs concentrate inside a random node community so the
    graph has learnable structure.
    """
    from tip_tpu_torch.data.decagon import DecagonRaw

    rng = np.random.default_rng(seed)
    dd_pair_list = []
    for _ in range(n_et):
        m = int(pairs_per_et * (0.5 + rng.random()))
        community = rng.choice(n_drug, size=max(4, n_drug // 3), replace=False)
        in_comm = rng.random(m) < 0.85
        a = np.where(
            in_comm[None, :],
            rng.choice(community, size=(2, m)).astype(np.int32),
            rng.integers(0, n_drug, size=(2, m), dtype=np.int32),
        )
        a = a[:, a[0] != a[1]]
        lo, hi = np.minimum(a[0], a[1]), np.maximum(a[0], a[1])
        pairs = np.unique(np.stack([lo, hi]), axis=1)
        dd_pair_list.append(pairs.astype(np.int32))
    ppa = rng.integers(0, n_prot, size=(2, n_pp_pairs), dtype=np.int32)
    ppa = ppa[:, ppa[0] != ppa[1]]
    lo, hi = np.minimum(ppa[0], ppa[1]), np.maximum(ppa[0], ppa[1])
    pp_pairs = np.unique(np.stack([hi, lo]), axis=1)  # src > dst convention
    pp_edge_index = to_bidirected(pp_pairs.astype(np.int32))
    dp = np.unique(
        np.stack(
            [
                rng.integers(0, n_prot, n_dp, dtype=np.int32),
                rng.integers(0, n_drug, n_dp, dtype=np.int32),
            ]
        ),
        axis=1,
    )
    return DecagonRaw(
        n_drug=n_drug,
        n_prot=n_prot,
        dd_pair_list=dd_pair_list,
        et_ids=np.arange(n_et, dtype=np.int32),
        pp_edge_index=pp_edge_index,
        dp_edge_index=dp,
    )
