"""Multi-relational decoders (port of tip_tpu/nn/decoders.py:17-107,
110-171): DistMult and the per-relation two-layer NN decoder, each with a
flat scorer of (src, dst, relation) triples and a chunk-aligned variant of
the chunked layout, kernels B8 and B9 (ops/sddmm2.py); and the DistMult
positives' BCE over the full count pages, which the sampled-negative route
takes on the dense layouts."""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.ops.dense_bce_sym import softplus
from tip_tpu_torch.ops.matmul import compute_round
from tip_tpu_torch.ops.sddmm2 import (
    distmult_logits_padded2,
    nn_logits_padded2,
)
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


def distmult_dense_pos_bce_sum(w, z, pages, kernel_dtype: str = "float32",
                               block: int = 128):
    """Sum over the positive edges of softplus(-logit), from the full count
    pages [R, n, n] (any dtype holding the counts exactly): every pair of a
    relation scored by one batched product and weighted by its count,

        sum_e softplus(-logit_e) = sum_t sum_{d,s} DA[t,d,s] softplus(-L_t[d,s]),

    with no per-edge work.  Relations go ``block`` at a time, each block
    recomputed in the backward instead of keeping its [block, n, n] logits
    (torch.utils.checkpoint, as jax.checkpoint there).  ``kernel_dtype``
    bfloat16 rounds z, w and their product to bf16 before the float32
    product, as the JAX package does on the CPU."""
    zc = compute_round(z, kernel_dtype)

    def block_sum(wb, da):
        wb = compute_round(wb, kernel_dtype)
        zw = compute_round(zc[None] * wb[:, None, :], kernel_dtype)
        logits = zw @ zc.T  # [block, n, n]
        return torch.sum(softplus(-logits) * da.float())

    total = torch.zeros((), dtype=torch.float32, device=z.device)
    for c0 in range(0, pages.shape[0], block):
        total = total + checkpoint(block_sum, w[c0:c0 + block],
                                   pages[c0:c0 + block], use_reentrant=False)
    return total


def nn_decoder_init(gen, in_dim: int, n_et: int, l1_dim: int = 16,
                    device=None):
    """Shared L1 per endpoint ~ N(0, 1), per-relation L2 rows
    ~ N(0, 1/sqrt(l1_dim))."""
    s2 = 1.0 / math.sqrt(l1_dim)
    return {
        "w1_l1": init.normal(gen, (in_dim, l1_dim), device=device),
        "w2_l1": init.normal(gen, (in_dim, l1_dim), device=device),
        "w1_l2": init.normal(gen, (n_et, l1_dim), std=s2, device=device),
        "w2_l2": init.normal(gen, (n_et, l1_dim), std=s2, device=device),
    }


def nn_hiddens(params, z):
    """The endpoint hiddens (relu(z W1), relu(z W2)), [n, l1] each."""
    return (torch.relu(z @ params["w1_l1"]), torch.relu(z @ params["w2_l1"]))


def nn_decoder_apply(params, z, src, dst, edge_type, sigmoid: bool = True):
    """logit_e = h1[src] . w1_l2[et] + h2[dst] . w2_l2[et], through the
    dense (node, relation) score tables s = h @ w_l2^T, each edge reading
    one scalar of each."""
    h1, h2 = nn_hiddens(params, z)
    s1 = h1 @ params["w1_l2"].T  # [n, n_et]
    s2 = h2 @ params["w2_l2"].T
    et = edge_type.long()
    logits = s1[src.long(), et] + s2[dst.long(), et]
    return torch.sigmoid(logits) if sigmoid else logits


def nn_decoder_apply_padded(params, z, src2d, dst2d, chunk_type,
                            sigmoid: bool = True,
                            kernel_dtype: str = "float32"):
    """Chunk-aligned NN decoder returning flat scores [n_chunks * chunk]
    (kernel B9); pad slots score their pad src, so the caller masks
    them."""
    h1, h2 = nn_hiddens(params, z)
    logits = nn_logits_padded2(h1, h2, params["w1_l2"], params["w2_l2"],
                               src2d, dst2d, chunk_type, z.shape[0],
                               kernel_dtype).reshape(-1)
    return torch.sigmoid(logits) if sigmoid else logits
