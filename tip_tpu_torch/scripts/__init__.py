"""Measurement scripts of the port, each run as ``python -m
tip_tpu_torch.scripts.<name>`` (counterparts of the JAX package's
``scripts/``)."""
