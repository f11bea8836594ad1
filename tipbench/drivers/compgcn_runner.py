"""Driver of CompGCN through the entry of tip_tpu_torch/models/runner.py:
``build_variant("compgcn", ...)`` (the int8 strips, which
``preferred_dense_dtype`` picks for the kernel dtype and the mix's
``matmul_precision`` within the dense budget), the runner's TF32 off
(``set_matmul_precision``).  Its widths are CompGCNConfig's, which the
other drivers' keys do not name.  A program without CompGCN fails at this
module's import, before set-up."""

from __future__ import annotations

from tip_tpu_torch.models.compgcn import CompGCNConfig
from tip_tpu_torch.models.runner import build_variant
from tip_tpu_torch.ops.matmul import set_matmul_precision

DIM_KEYS = ("init_dim", "gcn_dim")


def build(data, config: dict, traffic: dict, device):
    """(model, graph, test, gs) on ``device``."""
    set_matmul_precision()
    model, graph, test = build_variant(
        config["variant"], data, device, kernel_dtype=config["kernel_dtype"],
        matmul_precision=traffic["matmul_precision"],
        dims={k: config[k] for k in DIM_KEYS})
    if not isinstance(model.cfg, CompGCNConfig):
        raise ValueError(f"variant {config['variant']!r} is not CompGCN")
    return model, graph, test, model.gs
