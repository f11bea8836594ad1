"""DistMult decoder (port of tip_tpu/nn/decoders.py:17,22,27): flat
scoring of (src, dst, relation) triples, and the chunk-aligned variant of
the chunked layout, kernel B8 (ops/sddmm2.py)."""

from __future__ import annotations

import math

import torch

from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.ops.sddmm2 import distmult_logits_padded2
from tip_tpu_torch.ops.segment import distmult_score


def distmult_init(gen, in_dim: int, n_et: int, device=None):
    """weight ~ N(0, 1/sqrt(in_dim)), [n_et, in_dim]."""
    return {"weight": init.normal(gen, (n_et, in_dim),
                                  std=1.0 / math.sqrt(in_dim), device=device)}


def distmult_apply(params, z, src, dst, edge_type, sigmoid: bool = True):
    """score_e = sigmoid(sum_d z[src, d] z[dst, d] w[et, d])."""
    return distmult_score(z, params["weight"], src, dst, edge_type,
                          sigmoid=sigmoid)


def distmult_apply_padded(params, z, src2d, dst2d, chunk_type,
                          sigmoid: bool = True, kernel_dtype: str = "float32"):
    """Chunk-aligned variant returning flat scores [n_chunks * chunk]; pad
    slots (dst = n) score a logit of exactly 0."""
    logits = distmult_logits_padded2(z, params["weight"], src2d, dst2d,
                                     chunk_type, z.shape[0],
                                     kernel_dtype).reshape(-1)
    return torch.sigmoid(logits) if sigmoid else logits
