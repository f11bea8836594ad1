from tip_tpu_torch.ops.dense_bce import dense_bce_sum
from tip_tpu_torch.ops.dense_bce_sym import dense_bce_sym_sum
from tip_tpu_torch.ops.segment import (
    distmult_score,
    mean_from_sum,
    segment_sum_sorted,
)

__all__ = [
    "dense_bce_sum",
    "dense_bce_sym_sum",
    "distmult_score",
    "mean_from_sum",
    "segment_sum_sorted",
]
