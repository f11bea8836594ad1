"""Driver of TIP (TIP-cat, TIP-add) through the entry of
tip_tpu_torch/train/loop.py:train: the D-D layout ``preferred_dense_dtype``
picks for the configuration's kernel dtype and the mix's
``matmul_precision``, the device graph from ``make_graph_arrays``, the
model from ``TIP.for_data``, TF32 off (``set_matmul_precision``)."""

from __future__ import annotations

from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.ops.matmul import set_matmul_precision
from tip_tpu_torch.train.model import (
    TIP,
    make_graph_arrays,
    make_test_arrays,
    preferred_dense_dtype,
)

MODEL_KEYS = ("mode", "prot_drug_dim", "n_embed", "n_hid1", "n_hid2",
              "num_base", "pp_hid1", "pp_hid2", "decoder",
              "nn_decoder_l1_dim", "kernel_dtype", "negatives")


def model_config(config: dict) -> ModelConfig:
    return ModelConfig(**{k: config[k] for k in MODEL_KEYS if k in config})


def build(data, config: dict, traffic: dict, device):
    """(model, graph, test, gs) on ``device``."""
    cfg = model_config(config)
    set_matmul_precision()
    dense_dtype = preferred_dense_dtype(data, cfg.kernel_dtype,
                                        traffic["matmul_precision"])
    graph, gs = make_graph_arrays(data, device, dense_dtype=dense_dtype,
                                  sampled=cfg.negatives == "sampled",
                                  decoder=cfg.decoder)
    model = TIP.for_data(cfg, data, gs, device)
    return model, graph, make_test_arrays(data, device), gs

