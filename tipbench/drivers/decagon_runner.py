"""Driver of Decagon through the entry of tip_tpu_torch/models/runner.py:
``build_variant("decagon", ...)`` (the layout ``preferred_dense_dtype``
picks for the kernel dtype and the mix's ``matmul_precision``: the strips'
uint8 pages within the dense budget), the runner's TF32 off
(``set_matmul_precision``).  Its widths are DecagonConfig's, which
models_runner's keys do not name."""

from __future__ import annotations

from tip_tpu_torch.models.runner import build_variant
from tip_tpu_torch.ops.matmul import set_matmul_precision

DIM_KEYS = ("n_hid1", "n_hid2")


def build(data, config: dict, traffic: dict, device):
    """(model, graph, test, gs) on ``device``."""
    set_matmul_precision()
    model, graph, test = build_variant(
        config["variant"], data, device, kernel_dtype=config["kernel_dtype"],
        matmul_precision=traffic["matmul_precision"],
        dims={k: config[k] for k in DIM_KEYS})
    return model, graph, test, model.gs
