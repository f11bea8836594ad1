"""Stage-1 preprocessing: raw BioSNAP Decagon CSVs -> packed adjacencies.

A port of tip_tpu/data/preprocess.py (numpy/scipy), byte for byte in its
outputs: assigns dense ids in first-appearance order, symmetrizes the
per-side-effect drug-drug matrices as the reference's offline preprocessing
does (reference: data/preprocess_data.py:9-174), and writes the npz layout
the loader consumes (sym_adj/drug-sparse-adj/type_i.npz,
protein-sparse-adj, drug-protein-sparse-adj,
node_feature/drug-mono-feature) plus the id maps in index_map/ and
graph_info.pkl.  One file more than the JAX package writes: the marker
``DP_UNSHIFTED`` (data/decagon.py), so that load_decagon_raw takes the
drug-protein ids as written instead of applying the -1 shift that belongs
to the reference's shipped data.

Raw inputs (bio-decagon-*.csv from BioSNAP) are not shipped; the tests and
chip_smoke.py run it on synthetic CSVs.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, Tuple

import numpy as np
import scipy.sparse as sp

from tip_tpu_torch.data.decagon import DP_UNSHIFTED


def _decagon_code(code: str, letter: str) -> int:
    """'CID000002173' / 'C0004144' style codes -> int (reference:
    data/utils.py:17-22)."""
    return int(code.split(letter)[-1])


class IdMap:
    """Dense ids in first-appearance order (reference: preprocess_data.py:12-16)."""

    def __init__(self) -> None:
        self.map: Dict[int, int] = {}

    def __getitem__(self, raw: int) -> int:
        if raw not in self.map:
            self.map[raw] = len(self.map)
        return self.map[raw]

    def __len__(self) -> int:
        return len(self.map)


def preprocess_decagon(raw_dir: str, out_dir: str) -> Tuple[int, int, int, int]:
    """Run the full stage-1 pipeline; returns (n_drug, n_prot, n_combo, n_mono)."""
    drug, prot, combo, mono = IdMap(), IdMap(), IdMap(), IdMap()

    # drug-drug-side-effect triples
    rows: Dict[int, list] = {}
    cols: Dict[int, list] = {}
    with open(os.path.join(raw_dir, "bio-decagon-combo.csv")) as f:
        reader = csv.reader(f)
        next(reader)
        for d1, d2, se, _name in reader:
            i, j = drug[_decagon_code(d1, "D")], drug[_decagon_code(d2, "D")]
            t = combo[_decagon_code(se, "C")]
            rows.setdefault(t, []).append(i)
            cols.setdefault(t, []).append(j)

    n_drug = len(drug)
    os.makedirs(os.path.join(out_dir, "sym_adj", "drug-sparse-adj"), exist_ok=True)
    for t in range(len(combo)):
        adj = sp.coo_matrix(
            (np.ones(len(rows[t])), (rows[t], cols[t])), shape=(n_drug, n_drug)
        )
        # symmetrize exactly as the reference (preprocess_data.py:52)
        sym = adj + adj.T.multiply(adj.T > adj) - adj.multiply(adj.T > adj)
        sp.save_npz(
            os.path.join(out_dir, "sym_adj", "drug-sparse-adj", f"type_{t}.npz"),
            sym.tocoo(),
        )

    # protein-protein
    r, c = [], []
    with open(os.path.join(raw_dir, "bio-decagon-ppi.csv")) as f:
        reader = csv.reader(f)
        next(reader)
        for p1, p2 in reader:
            r.append(prot[int(p1)])
            c.append(prot[int(p2)])
    n_prot = len(prot)
    adj = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n_prot, n_prot))
    sym = adj + adj.T.multiply(adj.T > adj) - adj.multiply(adj.T > adj)
    sp.save_npz(os.path.join(out_dir, "sym_adj", "protein-sparse-adj.npz"), sym.tocoo())

    # drug-protein targets
    r, c = [], []
    with open(os.path.join(raw_dir, "bio-decagon-targets.csv")) as f:
        reader = csv.reader(f)
        next(reader)
        for d, p in reader:
            raw_p = int(p)
            if raw_p not in prot.map:  # target outside the PPI graph: skip
                continue
            r.append(drug[_decagon_code(d, "D")])
            c.append(prot.map[raw_p])
    dp = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n_drug, n_prot))
    sp.save_npz(os.path.join(out_dir, "sym_adj", "drug-protein-sparse-adj.npz"), dp)

    # mono side-effect drug features
    r, c = [], []
    mono_path = os.path.join(raw_dir, "bio-decagon-mono.csv")
    if os.path.exists(mono_path):
        with open(mono_path) as f:
            reader = csv.reader(f)
            next(reader)
            for d, se, _name in reader:
                r.append(drug[_decagon_code(d, "D")])
                c.append(mono[_decagon_code(se, "C")])
    os.makedirs(os.path.join(out_dir, "node_feature"), exist_ok=True)
    feat = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n_drug, max(len(mono), 1)))
    sp.save_npz(os.path.join(out_dir, "node_feature", "drug-mono-feature.npz"), feat)

    # id maps + graph info
    os.makedirs(os.path.join(out_dir, "index_map"), exist_ok=True)
    for name, m in [("drug-map", drug), ("protein-map", prot),
                    ("combo_map", combo), ("mono_map", mono)]:
        with open(os.path.join(out_dir, "index_map", f"{name}.pkl"), "wb") as f:
            pickle.dump(m.map, f)
    info = (n_drug, n_prot, len(combo), len(mono))
    with open(os.path.join(out_dir, "graph_info.pkl"), "wb") as f:
        pickle.dump(info, f)
    with open(os.path.join(out_dir, DP_UNSHIFTED), "w") as f:
        f.write("drug-protein ids as written: load without the reference's "
                "-1 shift\n")
    return info
