from tip_tpu_torch.metrics.ranking import grouped_ranking_metrics, macro_average

__all__ = ["grouped_ranking_metrics", "macro_average"]
