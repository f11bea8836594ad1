"""GCN convolution over the protein graph: COO, dense or windowed.

Port of tip_tpu/nn/gcn.py's ``gcn_conv_apply``, ``gcn_conv_apply_dense``
and ``gcn_conv_apply_windowed``.  COO: out = A_hat @ (x W) + b as a
segment sum over the cached normalized edge list (``index_add_``; the JAX
package runs it in XLA).  Dense: out = dinv * ((A+I) @ (dinv * (x W)))
+ b, the cached D^-1/2 (A+I) D^-1/2 normalization with the
non-representable edge weights factored out of the streamed operand
(data/packing.py:dense_pp_parts); the product reads the resident int8
(A+I) with the bf16-rounded operand and accumulates in float32
(ops/pp_aggregate.py: kernel B12 on the card, no float32 copy of the
matrix), as the JAX path does on both the TPU and the CPU.  Windowed:
out = A_hat @ (x W) + b over the pre-windowed edge buffers, kernel B5
(ops/typed_segment.py).  ``x=None`` is the identity-feature fast path:
layer 1's weight acts as an embedding table.
"""

from __future__ import annotations

import torch

from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.ops.pp_aggregate import pp_aggregate
from tip_tpu_torch.ops.segment import weighted_gather_sum
from tip_tpu_torch.ops.typed_segment import gcn_spmm_padded


def gcn_conv_init(gen, in_dim: int, out_dim: int, bias: bool = True,
                  device=None):
    params = {"weight": init.glorot_uniform(gen, (in_dim, out_dim), device)}
    if bias:
        params["bias"] = torch.zeros((out_dim,), dtype=torch.float32,
                                     device=device)
    return params


def gcn_conv_apply(params, x, norm_index, norm_weight, n_nodes: int):
    """x [N, in] or None; norm_index [2, E] (src, dst) and norm_weight [E]
    from data/packing.py:gcn_normalize."""
    h = params["weight"] if x is None else x @ params["weight"]
    out = weighted_gather_sum(h, norm_index[0], norm_index[1], norm_weight,
                              n_nodes)
    if "bias" in params:
        out = out + params["bias"]
    return out


def gcn_conv_apply_dense(params, x, a1, dinv, backend: str = "pallas"):
    """x [N, in] or None; a1: the symmetric (A+I) matrix [N, N] as int8
    (kernel B12 on the card), or under ``backend="xla"``, which launches no
    kernel and takes the float32 product, that or its exact float32 upcast
    (a caller applying both layers upcasts once); dinv [N] float32."""
    h = params["weight"] if x is None else x @ params["weight"]
    hb = (h * dinv[:, None]).to(torch.bfloat16)
    agg = a1.float() @ hb.float() if backend == "xla" else pp_aggregate(a1, hb)
    out = agg * dinv[:, None]
    if "bias" in params:
        out = out + params["bias"]
    return out


def gcn_conv_apply_windowed(params, x, wsrc2d, wdstl2d, ww2d, chunk_window,
                            n_windows: int, window: int, n_nodes: int,
                            kernel_dtype: str = "float32"):
    """x [N, in] or None; the windowed buffers of
    data/packing.py:pad_windowed_edges.  Requires the symmetric cached
    normalization (the SpMM's backward reruns it on the gradient)."""
    h = params["weight"] if x is None else x @ params["weight"]
    out = gcn_spmm_padded(h, wsrc2d, wdstl2d, ww2d, chunk_window, n_windows,
                          window, n_nodes, kernel_dtype)
    if "bias" in params:
        out = out + params["bias"]
    return out
