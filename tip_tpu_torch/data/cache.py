"""Disk cache for packed TriGraphData (one npz per (dataset, split, seed)).

A port of tip_tpu/data/cache.py.  Packing the 9.3M-edge Decagon multigraph
costs seconds of host work that every launch would repeat; this caches the
packed arrays keyed by a content fingerprint (relation ids, node counts,
split rate, seed, layout version).  The fingerprint and the npz keys are
the JAX package's, so a cache file written by either package loads in the
other.

The directory is ``cache_dir``, else ``$TIP_CACHE_DIR`` (read at each
call), else ``~/.cache/tip_tpu_torch``.  One difference from the JAX
package: a cache file is written through a temporary file unique to the
writing process and then renamed into place, so two processes building the
same graph at once cannot interleave their writes.  A second: a graph whose
drug-protein ids were loaded without the reference's -1 shift
(``raw.dp_shift == 0``, data/decagon.py) has a fingerprint of its own, so it
never shares a file with the shifted graph the JAX package loads from the
same directory; every other graph keeps the JAX package's fingerprint.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile
from typing import Optional

import numpy as np

from tip_tpu_torch import trace
from tip_tpu_torch.data.packing import TriGraphData, TypedEdges, build_trigraph

_LAYOUT_VERSION = 3  # bump when TriGraphData layout changes


def default_cache_dir() -> str:
    return os.environ.get(
        "TIP_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "tip_tpu_torch"))


def _fingerprint(raw, split_rate: float, seed: int) -> str:
    h = hashlib.sha256()
    mono = int(getattr(raw, "drug_mono", None) is not None)
    h.update(
        f"v{_LAYOUT_VERSION}|{raw.n_drug}|{raw.n_prot}|{split_rate}|{seed}|{mono}|".encode()
    )
    h.update(np.asarray(raw.et_ids).tobytes())
    counts = np.array([p.shape[1] for p in raw.dd_pair_list], np.int64)
    h.update(counts.tobytes())
    h.update(np.int64(raw.pp_edge_index.shape[1]).tobytes())
    h.update(np.int64(raw.dp_edge_index.shape[1]).tobytes())
    if getattr(raw, "dp_shift", 1) == 0:
        h.update(b"|dp unshifted")
    return h.hexdigest()[:16]


def _save(f, g: TriGraphData) -> None:
    np.savez(
        f,
        n_drug=g.n_drug, n_prot=g.n_prot, n_et=g.n_et,
        tr_idx=g.dd_train.edge_index, tr_et=g.dd_train.edge_type,
        tr_rng=g.dd_train.range_list,
        te_idx=g.dd_test.edge_index, te_et=g.dd_test.edge_type,
        te_rng=g.dd_test.range_list,
        deg=g.dd_train_deg, tr_keys=g.dd_train_keys, te_keys=g.dd_test_keys,
        tr_bitmap=g.dd_train_bitmap, te_bitmap=g.dd_test_bitmap,
        pp_train=g.pp_train, pp_test=g.pp_test,
        pp_norm_index=g.pp_norm_index, pp_norm_weight=g.pp_norm_weight,
        dp=g.dp_edge_index, dp_deg=g.dp_drug_deg,
        **({"drug_feat": g.drug_feat} if g.drug_feat is not None else {}),
        **({"d_norm": g.d_norm} if g.d_norm is not None else {}),
    )


def _load(path: str) -> TriGraphData:
    with np.load(path) as z:
        return TriGraphData(
            n_drug=int(z["n_drug"]), n_prot=int(z["n_prot"]),
            n_et=int(z["n_et"]),
            dd_train=TypedEdges(z["tr_idx"], z["tr_et"], z["tr_rng"]),
            dd_test=TypedEdges(z["te_idx"], z["te_et"], z["te_rng"]),
            dd_train_deg=z["deg"], dd_train_keys=z["tr_keys"],
            dd_test_keys=z["te_keys"],
            dd_train_bitmap=z["tr_bitmap"], dd_test_bitmap=z["te_bitmap"],
            pp_train=z["pp_train"], pp_test=z["pp_test"],
            pp_norm_index=z["pp_norm_index"],
            pp_norm_weight=z["pp_norm_weight"],
            dp_edge_index=z["dp"], dp_drug_deg=z["dp_deg"],
            drug_feat=z["drug_feat"] if "drug_feat" in z else None,
            d_norm=z["d_norm"] if "d_norm" in z else None,
        )


@trace.spanned("cache")
def cached_trigraph(raw, split_rate: float = 0.9, seed: int = 1111,
                    cache_dir: Optional[str] = None) -> TriGraphData:
    """build_trigraph with a transparent npz cache; a cache file that does
    not load is rebuilt."""
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    name = f"trigraph_{_fingerprint(raw, split_rate, seed)}.npz"
    path = os.path.join(cache_dir, name)
    if os.path.exists(path):
        try:
            return _load(path)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            os.remove(path)
    g = build_trigraph(raw, split_rate=split_rate, seed=seed)
    fd, tmp = tempfile.mkstemp(prefix=name + ".", suffix=".tmp",
                               dir=cache_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            _save(f, g)
        os.replace(tmp, path)
    except BaseException:
        os.remove(tmp)
        raise
    return g
