from tip_tpu_torch.data.decagon import DecagonRaw, load_decagon_raw
from tip_tpu_torch.data.drug_structure import (
    calculate_drug_similarity,
    dice_similarity_matrix,
    morgan_fingerprint,
)
from tip_tpu_torch.data.cache import cached_trigraph
from tip_tpu_torch.data.packing import (
    TriGraphData,
    TypedEdges,
    build_trigraph,
    split_typed_edges,
    sort_typed_edges,
    synthetic_trigraph,
)

__all__ = [
    "DecagonRaw",
    "load_decagon_raw",
    "TypedEdges",
    "TriGraphData",
    "split_typed_edges",
    "sort_typed_edges",
    "build_trigraph",
    "synthetic_trigraph",
    "cached_trigraph",
    "calculate_drug_similarity",
    "dice_similarity_matrix",
    "morgan_fingerprint",
]
