"""Driver of the D-D models (DR-NN, DR-DF) through the entry of
tip_tpu_torch/models/runner.py: ``build_variant`` (the layout
``preferred_dense_dtype`` picks for the kernel dtype and the mix's
``matmul_precision``), the runner's TF32 off (``set_matmul_precision``)."""

from __future__ import annotations

from tip_tpu_torch.models.runner import build_variant
from tip_tpu_torch.ops.matmul import set_matmul_precision

DIM_KEYS = ("n_embed", "n_hid1", "n_hid2", "num_base")


def build(data, config: dict, traffic: dict, device):
    """(model, graph, test, gs) on ``device``."""
    set_matmul_precision()
    model, graph, test = build_variant(
        config["variant"], data, device, kernel_dtype=config["kernel_dtype"],
        matmul_precision=traffic["matmul_precision"],
        dims={k: config[k] for k in DIM_KEYS})
    want = config.get("nn_decoder_l1_dim")
    if want is not None and model.cfg.nn_decoder_l1_dim != want:
        raise ValueError("the runner's NN decoder width differs from the "
                         "configuration's")
    return model, graph, test, model.gs

