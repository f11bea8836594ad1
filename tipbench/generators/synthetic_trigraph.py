"""Generator ``synthetic_trigraph``: a random tri-graph whose relations'
pairs concentrate inside random drug communities.

Frozen copy of ``synthetic_trigraph`` (tip_tpu_torch/data/packing.py:551-611
at the commit that added this benchmark), so that a later change to the
program's generator cannot move the yardstick.  The draws are the same:
one graph per seed, identical to the program's and the JAX package's.
A traffic file's "graph" group sets its arguments.
"""

from __future__ import annotations

import numpy as np

from tipbench.lib.generator import RawGraph


def make(n_drug: int, n_prot: int, n_et: int, pairs_per_et: int,
         n_pp_pairs: int, n_dp: int, seed: int) -> RawGraph:
    """A random tri-graph: each relation's pairs concentrate inside a
    random drug community (85 %), so the graph has learnable structure."""
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
    pp_pairs = pp_pairs.astype(np.int32)
    pp_edge_index = np.concatenate([pp_pairs, pp_pairs[::-1]], axis=1)
    dp = np.unique(np.stack([
        rng.integers(0, n_prot, n_dp, dtype=np.int32),
        rng.integers(0, n_drug, n_dp, dtype=np.int32),
    ]), axis=1)
    return RawGraph(n_drug=n_drug, n_prot=n_prot, dd_pair_list=dd_pair_list,
                    et_ids=np.arange(n_et, dtype=np.int32),
                    pp_edge_index=pp_edge_index, dp_edge_index=dp)

