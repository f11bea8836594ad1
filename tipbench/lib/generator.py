"""The seeded raw tri-graph of a traffic mix.

A traffic file's "graph" group names its generator under ``kind``, a
module ``tipbench/generators/<kind>.py`` whose ``make(**params)`` takes
the group's other keys and returns a :class:`RawGraph`; a new shape of
graph is a new generator file.

``RawGraph`` has the fields of the program's ``DecagonRaw``
(tip_tpu_torch/data/decagon.py:42) that packing reads; the program packs
it by duck typing, and the plain reference reads the same object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from tipbench.lib.found import load_module


@dataclass
class RawGraph:
    n_drug: int
    n_prot: int
    dd_pair_list: List[np.ndarray]  # per relation, [2, m] int32, lo < hi
    et_ids: np.ndarray
    pp_edge_index: np.ndarray  # [2, E] int32, both directions
    dp_edge_index: np.ndarray  # [2, E] int32, rows (protein, drug)
    drug_mono: Optional[object] = None
    dp_shift: int = 1


def make_raw(graph: dict) -> RawGraph:
    """The raw graph a traffic file's "graph" group describes."""
    params = dict(graph)
    return load_module("generators", params.pop("kind")).make(**params)
