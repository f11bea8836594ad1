"""DistMult decoder (port of tip_tpu/nn/decoders.py:17,22)."""

from __future__ import annotations

import math

from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.ops.segment import distmult_score


def distmult_init(gen, in_dim: int, n_et: int, device=None):
    """weight ~ N(0, 1/sqrt(in_dim)), [n_et, in_dim]."""
    return {"weight": init.normal(gen, (n_et, in_dim),
                                  std=1.0 / math.sqrt(in_dim), device=device)}


def distmult_apply(params, z, src, dst, edge_type, sigmoid: bool = True):
    """score_e = sigmoid(sum_d z[src, d] z[dst, d] w[et, d])."""
    return distmult_score(z, params["weight"], src, dst, edge_type,
                          sigmoid=sigmoid)
