"""Segment reductions and edge scoring on tensors.

Port of tip_tpu/ops/segment.py:24,31,41,55,67: ``segment_sum_sorted`` is an
``index_add_`` (the ids need not be sorted here; the name keeps the
counterpart's), ``weighted_gather_sum`` the COO SpMM over it (gathers by
``index_select``, whose backward is an ``index_add_``: advanced indexing
sorts its repeated indices in the backward, slowly on the card),
``typed_neighbor_sum`` the flat (relation, dst) binning of the R-GCN (the
JAX package's XLA route; kernel B4 bins the chunked buffers),
``mean_from_sum`` divides by in-degree with empty means at zero
(torch-scatter's scatter_mean convention), ``distmult_score`` is the
DistMult gather-multiply-reduce.
"""

from __future__ import annotations

import torch


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s] = sum of data rows with segment id s."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids.long(), data)


def weighted_gather_sum(x, src, dst, weight, n_nodes: int) -> torch.Tensor:
    """out[d] = sum over edges e with dst_e = d of weight_e * x[src_e]; with
    the cached GCN normalization this is A_hat @ x."""
    return segment_sum_sorted(x.index_select(0, src.long()) * weight[:, None],
                              dst, n_nodes)


def typed_neighbor_sum(x, src, dst, edge_type, n_nodes: int,
                       n_et: int) -> torch.Tensor:
    """P[t, d] = sum over edges e of relation t with dst_e = d of x[src_e]:
    [n_et, n_nodes, d_in], one segment sum over segment ids
    t * n_nodes + dst."""
    seg = edge_type.long() * n_nodes + dst.long()
    flat = segment_sum_sorted(x.index_select(0, src.long()), seg,
                              n_et * n_nodes)
    return flat.reshape(n_et, n_nodes, x.shape[-1])


def mean_from_sum(summed: torch.Tensor, degree: torch.Tensor) -> torch.Tensor:
    """Divide aggregated sums by in-degree; zero-degree rows stay zero."""
    deg = degree.to(summed.dtype)
    inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0),
                      torch.zeros_like(deg))
    return summed * inv.reshape((-1,) + (1,) * (summed.dim() - 1))


def distmult_score(z, rel_weight, src, dst, edge_type, sigmoid: bool = True):
    """score_e = sum_d z[src_e, d] * z[dst_e, d] * rel_weight[et_e, d]."""
    logits = torch.sum(z[src.long()] * z[dst.long()]
                       * rel_weight[edge_type.long()], dim=-1)
    return torch.sigmoid(logits) if sigmoid else logits
