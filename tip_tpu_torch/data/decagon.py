"""Raw Decagon polypharmacy data loading (host-side, numpy/scipy only).

A copy of tip_tpu/data/decagon.py's loader: reads the preprocessed sparse
adjacencies (per-relation drug-drug npz, protein-protein npz, drug-protein
npz, optional drug mono side-effect features) into plain numpy edge lists,
with the same semantics:

  * per-relation D-D adjacencies are reduced to their upper triangle so
    each undirected pair appears once before splitting;
  * the drug-protein edge list of the reference's shipped data carries the
    reference's ``-1`` index shift (reference: prepare.py:30), kept for
    parity with its ``data_dict.pkl`` and the JAX package.  A directory
    that this package's ``preprocess_decagon`` wrote holds the marker file
    ``DP_UNSHIFTED``, and its drug-protein ids are loaded as they are: the
    shift would put every target on the drug and protein before its own
    and drug 0's or protein 0's at -1.  The JAX package shifts both kinds;
    the two packages load the same graph only from the shipped data;
  * features default to pure identity, so the first drug projection is an
    embedding lookup.

The data directory is ``--data-dir`` or ``$TIP_DATA_DIR``.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp

DEFAULT_DATA_DIR = os.environ.get("TIP_DATA_DIR", "data")

# The marker file preprocess_decagon writes beside graph_info.pkl: the
# directory's drug-protein ids are the id maps' own, loaded without the shift.
DP_UNSHIFTED = "dp_unshifted"


@dataclass
class DecagonRaw:
    """Unpacked tri-graph: numpy edge lists, one D-D list entry per relation."""

    n_drug: int
    n_prot: int
    # Per-relation upper-triangular drug-drug pairs, each [2, nnz_t] int32.
    dd_pair_list: List[np.ndarray]
    # Relation ids (into the original 1,317 Decagon side effects) per list entry.
    et_ids: np.ndarray
    # Symmetric protein-protein edges [2, nnz] int32 (both directions present).
    pp_edge_index: np.ndarray
    # Drug-protein edges [2, nnz] int32, rows = (protein, drug), less
    # dp_shift (see module docstring).
    dp_edge_index: np.ndarray
    # Optional drug mono side-effect feature matrix (CSR) — the general
    # feature path; the default model uses identity features instead.
    drug_mono: Optional[sp.csr_matrix] = None
    # The shift taken off the drug-protein ids: 1 (the reference's) or 0 (a
    # DP_UNSHIFTED directory); data/cache.py keys the unshifted graph apart.
    dp_shift: int = 1


def default_et_list(data_dir: str = DEFAULT_DATA_DIR) -> np.ndarray:
    """The 1,097 relation ids with >500 symmetric nnz (reference: prepare.py:5)."""
    with open(os.path.join(data_dir, "decagon_et.pkl"), "rb") as f:
        return np.asarray(pickle.load(f), dtype=np.int32)


def load_decagon_raw(
    data_dir: str = DEFAULT_DATA_DIR,
    et_list: Optional[Sequence[int]] = None,
    mono: bool = False,
) -> DecagonRaw:
    """Load the Decagon npz files of ``data_dir`` into numpy edge lists."""
    with open(os.path.join(data_dir, "graph_info.pkl"), "rb") as f:
        n_drug, n_prot, _n_combo, _n_mono = pickle.load(f)

    if et_list is None:
        et_list = default_et_list(data_dir)
    et_ids = np.asarray(et_list, dtype=np.int32)

    dd_pair_list = []
    for t in et_ids:
        adj = sp.load_npz(
            os.path.join(data_dir, "sym_adj", "drug-sparse-adj", f"type_{int(t)}.npz")
        )
        triu = sp.triu(adj).tocoo()
        dd_pair_list.append(
            np.stack([triu.row.astype(np.int32), triu.col.astype(np.int32)])
        )

    pp = sp.load_npz(os.path.join(data_dir, "sym_adj", "protein-sparse-adj.npz")).tocoo()
    pp_edge_index = np.stack([pp.row.astype(np.int32), pp.col.astype(np.int32)])

    dp = sp.load_npz(
        os.path.join(data_dir, "sym_adj", "drug-protein-sparse-adj.npz")
    ).tocsr().tocoo()
    # (protein, drug), with the reference's -1 shift on its shipped data
    # (reference: prepare.py:30) and none on preprocess_decagon's output.
    shift = 0 if os.path.exists(os.path.join(data_dir, DP_UNSHIFTED)) else 1
    dp_edge_index = np.stack(
        [dp.col.astype(np.int32) - shift, dp.row.astype(np.int32) - shift]
    )

    drug_mono = None
    if mono:
        drug_mono = sp.load_npz(
            os.path.join(data_dir, "node_feature", "drug-mono-feature.npz")
        ).tocsr()

    return DecagonRaw(
        n_drug=int(n_drug),
        n_prot=int(n_prot),
        dd_pair_list=dd_pair_list,
        et_ids=et_ids,
        pp_edge_index=pp_edge_index,
        dp_edge_index=dp_edge_index,
        drug_mono=drug_mono,
        dp_shift=shift,
    )


def has_reference_data(data_dir: str = DEFAULT_DATA_DIR) -> bool:
    return os.path.exists(os.path.join(data_dir, "graph_info.pkl"))


def et_list_by_nnz_band(
    low: int, high: int, data_dir: str = DEFAULT_DATA_DIR
) -> np.ndarray:
    """Relation ids whose symmetric adjacency nnz lies in (low, high).

    Equivalent of the reference's ``cut_data`` band selection (reference:
    data/utils.py:172-195; e.g. the 1k-5k band of test/dd_net_scalable.py).
    Scans ``type_0`` .. ``type_1316`` as the JAX package does.
    """
    out = []
    for t in range(1317):
        path = os.path.join(
            data_dir, "sym_adj", "drug-sparse-adj", f"type_{t}.npz"
        )
        if not os.path.exists(path):
            continue
        nnz = sp.load_npz(path).nnz
        if low < nnz < high:
            out.append(t)
    return np.asarray(out, dtype=np.int32)


def load_decagon_band(
    data_dir: Optional[str] = None, et_band: Optional[str] = None,
    mono: bool = False,
) -> DecagonRaw:
    """The CLIs' load: the Decagon files of ``data_dir`` (None: the default
    directory), all relations of the default list or those whose nnz lies
    in the band ``"LOW,HIGH"`` (et_list_by_nnz_band)."""
    kw = {"data_dir": data_dir} if data_dir else {}
    if et_band:
        low, high = (int(x) for x in et_band.split(","))
        kw["et_list"] = et_list_by_nnz_band(low, high, **kw)
    if mono:
        kw["mono"] = True
    return load_decagon_raw(**kw)
