"""Basis-decomposed relational graph convolution over the symmetric strip
layout, the full count pages or the chunked edge buffers (port of
tip_tpu/nn/rgcn.py:34 ``rgcn_init``, :74 ``dense_rgcn_pair_apply``, :152
``dense_rgcn_pair_apply_sym`` and :229 ``rgcn_apply_padded`` on its kernel
branch).

Per layer: out[d] = (1/deg[d]) * sum_t (DA[t] @ x)[d] @ W_t + x[d] @ root
with W_t = sum_b att[t, b] basis_b.  Reassociated M-first,

    sum_t att[t, b] (DA[t] @ x) = (sum_t att[t, b] DA[t]) @ x = M[b] @ x,

so BOTH layers' M come from one contraction ``M = att_cat^T @ strips`` over
the concatenated ``[R, B1 + B2]`` attention table.  The pages are
symmetric, so M is too, and contracting the packed strips gives M's upper
block triangle; ``M @ h`` is reassembled strip by strip: strip I adds
``strip_I @ h[I*128:]`` to rows I and ``strip_I[:, 128:]^T @ h[I]`` to the
mirror rows.  Contributions to a row block are summed in the JAX
package's order.  Both contractions take bf16-rounded operands with f32
accumulation (ops/matmul.py).  Over the full pages (the JAX package's
float32 or bf16 ``dd_adj_t``, unpadded here) the same M-first pair runs
without the strip bookkeeping: float32 pages take float32 operands as they
are, bf16 pages bf16-rounded ones.

The chunked layer bins neighbour sums per (relation, dst) with kernel B4
(ops/typed_segment.py) in the transposed [n_et, d, n] layout, which the
basis einsums contract directly, in float32.  Under a mesh
(parallel/mesh.py) each rank bins only its own chunks and the basis-mixed
intermediate ``q`` is summed over the ranks (the JAX package's psum).
"""

from __future__ import annotations

import math

import torch

from tip_tpu_torch.data.packing import SYM_BLOCK as B, nb_from_cols
from tip_tpu_torch.nn import initializers as init
from tip_tpu_torch.ops.matmul import bf16_round, mm_bf16
from tip_tpu_torch.ops.segment import mean_from_sum
from tip_tpu_torch.ops.typed_segment import typed_neighbor_sum_padded_t
from tip_tpu_torch.parallel.collectives import psum


def rgcn_init(gen, in_dim: int, out_dim: int, n_et: int, n_base: int,
              after_relu: bool, bias: bool = False, device=None):
    std = init.rgcn_std(in_dim, after_relu)
    params = {
        "att": init.normal(gen, (n_et, n_base), std=1.0 / math.sqrt(n_base),
                           device=device),
        "basis": init.normal(gen, (n_base, in_dim, out_dim), std=std,
                             device=device),
        "root": init.normal(gen, (in_dim, out_dim), std=std, device=device),
    }
    if bias:
        params["bias"] = torch.zeros((out_dim,), dtype=torch.float32,
                                     device=device)
    return params


def dense_rgcn_pair_apply_sym(params1, params2, x, sym_strips, degree):
    """Both R-GCN layers (ReLU between) over the int8 strips
    [R, 128, NB*128] (data/packing.py:sym_strip_pack); x [n, d_in],
    degree [n] the cross-relation in-degree.  Returns [n, d_out2]."""
    att_cat = torch.cat([params1["att"], params2["att"]], dim=1)
    b1 = params1["att"].shape[1]
    n_true = degree.shape[0]
    r, _, totcols = sym_strips.shape
    nb = nb_from_cols(totcols)
    offs = [(i * nb - i * (i - 1) // 2) * B for i in range(nb + 1)]
    m = (bf16_round(att_cat).T @ bf16_round(sym_strips).reshape(r, -1))
    m = m.reshape(-1, B, totcols)  # [B1 + B2, 128, totcols] f32

    def half(params, m_half, h):
        hd = torch.nn.functional.pad(h, (0, 0, 0, nb * B - n_true))
        blocks = [[] for _ in range(nb)]
        for i in range(nb):
            ms = m_half[:, :, offs[i]:offs[i + 1]]  # [b, 128, (nb-i)*128]
            if nb - i > 1:  # mirror of the off-diagonal strip part
                mirror = mm_bf16(ms[:, :, B:].transpose(1, 2),
                                 hd[i * B:(i + 1) * B])
                for k in range(i + 1, nb):
                    blocks[k].append(mirror[:, (k - i - 1) * B:(k - i) * B])
            blocks[i].append(mm_bf16(ms, hd[i * B:]))
        qd = torch.cat([sum(parts) for parts in blocks], dim=1)
        agg = torch.einsum("bdf,bfe->de", qd[:, :n_true], params["basis"])
        out = mean_from_sum(agg, degree) + h @ params["root"]
        if "bias" in params:
            out = out + params["bias"]
        return out

    h = torch.relu(half(params1, m[:b1], x))
    return half(params2, m[b1:], h)


def dense_rgcn_pair_apply(params1, params2, x, pages, degree):
    """Both R-GCN layers (ReLU between) over the full count pages
    [R, n, n] (float32 or bf16; data/packing.py:cast_dense_adj) from one
    M-first contraction ``M = att_cat^T @ DA``, then ``M[b] @ h``; x
    [n, d_in], degree [n].  Returns [n, d_out2].

    The rounding is the JAX package's on the CPU in each page dtype:
    float32 pages multiply float32 operands as they are; bf16 pages round
    ``att_cat``, ``M`` and ``h`` to bf16 and multiply in float32."""
    att_cat = torch.cat([params1["att"], params2["att"]], dim=1)
    b1 = params1["att"].shape[1]
    r, n, _ = pages.shape
    exact = pages.dtype == torch.float32
    rnd = (lambda v: v) if exact else bf16_round
    m = (rnd(att_cat).T @ pages.reshape(r, -1).float()).reshape(-1, n, n)

    def half(params, m_half, h):
        qd = rnd(m_half) @ rnd(h)  # [b, n, d_in]
        agg = torch.einsum("bdf,bfe->de", qd, params["basis"])
        out = mean_from_sum(agg, degree) + h @ params["root"]
        if "bias" in params:
            out = out + params["bias"]
        return out

    h = torch.relu(half(params1, m[:b1], x))
    return half(params2, m[b1:], h)


def rgcn_apply_padded(params, x, src2d, dst2d, chunk_type, degree,
                      n_nodes: int, n_et: int, kernel_dtype: str = "float32",
                      mesh=None):
    """One R-GCN layer over chunk-aligned typed edges
    (data/packing.py:pad_typed_edges): src2d/dst2d [n_chunks, chunk] int32
    with pad slots at dst = n_nodes, chunk_type [n_chunks] int32; x
    [n_nodes, d_in], degree [n_nodes].  Returns [n_nodes, d_out].  Under
    ``mesh`` the chunks are this rank's shard and ``q`` (linear in the
    edges) is summed over all ranks."""
    pt = typed_neighbor_sum_padded_t(x, src2d, dst2d, chunk_type, n_et,
                                     kernel_dtype)
    q = torch.einsum("tb,tdn->bdn", params["att"], pt)
    if mesh is not None:
        q = psum(q)
    agg = torch.einsum("bdn,bde->ne", q, params["basis"])
    out = mean_from_sum(agg, degree) + x @ params["root"]
    if "bias" in params:
        out = out + params["bias"]
    return out
