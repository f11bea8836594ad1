from tip_tpu_torch.analysis.report import (
    load_side_effect_names,
    per_relation_table,
    top_bottom,
    decagon_rank_comparison,
    save_report,
)

__all__ = [
    "load_side_effect_names",
    "per_relation_table",
    "top_bottom",
    "decagon_rank_comparison",
    "save_report",
]
