"""Compatibility loader for the reference's prepared ``data_dict.pkl``.

A port of tip_tpu/data/compat.py.  Users of the reference run
``python prepare.py`` once and train from the resulting pickle (reference:
prepare.py:46-47, consumed at src/layers.py:284-295).  This module ingests
that artifact, torch tensors and all, into a :class:`TriGraphData` equal to
the JAX package's, so switching frameworks needs no re-prepared data and
keeps the split.  The membership bitmaps come from the port's own
``data/packing.py:build_typed_bitmap``.
"""

from __future__ import annotations

import pickle

import numpy as np

from tip_tpu_torch.data.packing import (
    TriGraphData,
    TypedEdges,
    build_typed_bitmap,
    encode_keys,
    gcn_normalize,
    in_degree,
    sort_typed_edges,
)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if hasattr(x, "is_sparse") and x.is_sparse:
            x = x.to_dense()
        return x.numpy()
    return np.asarray(x)


def _typed(idx, et, rng) -> TypedEdges:
    edges = TypedEdges(
        _np(idx).astype(np.int32), _np(et).astype(np.int32),
        _np(rng).astype(np.int32),
    )
    # the reference stores bins unsorted within each relation; our segment
    # ops need (type, dst, src) order — ranges stay valid under in-bin sort
    return sort_typed_edges(edges)


def load_data_dict(path: str) -> TriGraphData:
    """reference data_dict.pkl -> packed TriGraphData (identical split)."""
    with open(path, "rb") as f:
        d = pickle.load(f)

    n_drug = int(d["n_drug"])
    n_prot = int(d["n_prot"])
    n_et = int(d["n_dd_et"])

    dd_train = _typed(d["dd_train_idx"], d["dd_train_et"], d["dd_train_range"])
    dd_test = _typed(d["dd_test_idx"], d["dd_test_et"], d["dd_test_range"])

    pp_train = _np(d["pp_train_indices"]).astype(np.int32)
    pp_test = _np(d["pp_test_indices"]).astype(np.int32)
    pp_norm_index, pp_norm_weight = gcn_normalize(pp_train, n_prot)

    # reference dp layout: row0 = protein, row1 = drug + n_prot offset
    # (reference: prepare.py:43) — undo the offset for the direct bipartite form
    dp = _np(d["dp_edge_index"]).astype(np.int64)
    dp = np.stack([dp[0], dp[1] - n_prot]).astype(np.int32)
    order = np.lexsort((dp[0], dp[1]))
    dp = dp[:, order].copy()

    train_keys = encode_keys(dd_train, n_drug)
    test_keys = encode_keys(dd_test, n_drug)

    d_norm = None
    if "d_norm" in d:
        dn = _np(d["d_norm"]).astype(np.float32).reshape(-1)
        if dn.shape[0] == n_drug and not np.all(dn == 1.0):
            d_norm = dn

    return TriGraphData(
        n_drug=n_drug,
        n_prot=n_prot,
        n_et=n_et,
        dd_train=dd_train,
        dd_test=dd_test,
        dd_train_deg=in_degree(dd_train.edge_index, n_drug),
        dd_train_keys=train_keys,
        dd_test_keys=test_keys,
        dd_train_bitmap=build_typed_bitmap(
            dd_train.edge_index, dd_train.edge_type, n_drug, n_et
        ),
        dd_test_bitmap=build_typed_bitmap(
            dd_test.edge_index, dd_test.edge_type, n_drug, n_et
        ),
        pp_train=pp_train,
        pp_test=pp_test,
        pp_norm_index=pp_norm_index,
        pp_norm_weight=pp_norm_weight,
        dp_edge_index=dp,
        dp_drug_deg=in_degree(dp, n_drug),
        d_norm=d_norm,
    )
