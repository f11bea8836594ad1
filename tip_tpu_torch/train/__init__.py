"""Training: model assembly (model.py), the loop (loop.py), the CLI
(``python -m tip_tpu_torch.train``)."""
