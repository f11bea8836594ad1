"""Directed bipartite protein->drug convolution (port of
tip_tpu/nn/hierarchy.py): identity messages, mean aggregation of each
drug's targeted proteins, then one dense projection.  Drugs with no
targeted protein get zero rows.
"""

from __future__ import annotations

from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.ops.segment import mean_from_sum, segment_sum_sorted


def hierarchy_conv_init(gen, in_dim: int, out_dim: int,
                        after_relu: bool = True, device=None):
    return {
        "weight": init.normal(
            gen, (in_dim, out_dim), std=init.hierarchy_std(in_dim, after_relu),
            device=device,
        )
    }


def hierarchy_conv_apply(params, x_src, src, dst, dst_degree, n_dst: int):
    """x_src [n_src, in]; (src, dst) bipartite edges.  Returns
    [n_dst, out] = mean_{src in N(dst)} x_src[src] @ W."""
    summed = segment_sum_sorted(x_src[src.long()], dst, n_dst)
    return mean_from_sum(summed, dst_degree) @ params["weight"]
