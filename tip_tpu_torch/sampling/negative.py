"""Typed negative sampling against a relation-strided membership bitmap
(port of tip_tpu/sampling/negative.py:43-157).

:func:`typed_negative_sampling` (the test negatives, and the flat training
negatives of PR-HMP-NN and PP-GAE): one uniform pair per positive edge over
[0, n)^2 for the edge's relation, tested against that relation's positives
by one bitmap word lookup; a fixed number of masked resampling rounds,
leftovers accepted after the last.  Draws come from a ``torch.Generator``
on the generator's device: a CPU generator draws on the host and the pairs
are moved to the device (a seed gives the same pairs on either device, as
the test negatives want), a CUDA generator draws on the card (no host
draws or copies in a training step).

:func:`typed_negative_sampling_chunked` (the training negatives of the
chunked layout): one draw per slot of the chunk-aligned buffer, kernel B10
(ops/sampler.py) on CUDA tensors, its plain version on CPU tensors
(``backend="pallas"``); with ``backend="xla"``, the JAX package's XLA
branch: the flat sampler above over the slots' relations, ``rounds``
rounds, drawn by a generator seeded with the step seed on the chunk
buffers' device.
"""

from __future__ import annotations

import numpy as np
import torch

from tip_tpu_torch.data.packing import bitmap_stride_bits
from tip_tpu_torch.ops.sampler import typed_negative_sampling_padded


def bitmap_tensor(bitmap, device=None) -> torch.Tensor:
    """uint32 bitmap words (numpy) as an int32 tensor of the same bits."""
    return torch.from_numpy(np.asarray(bitmap, np.uint32).view(np.int32)).to(device)


def collides(pair, edge_type, bitmap: torch.Tensor, n_nodes: int):
    """Whether pair = dst * n + src is a positive of edge_type."""
    bit = edge_type.long() * bitmap_stride_bits(n_nodes) + pair
    word = bitmap[bit >> 5]
    return ((word >> (bit & 31)) & 1) != 0


def typed_negative_sampling(gen: torch.Generator, edge_type, bitmap,
                            n_nodes: int, rounds: int = 4):
    """One negative (src, dst) per positive edge, per relation.

    edge_type [E] relation ids; bitmap: int32 words (:func:`bitmap_tensor`)
    on edge_type's device; ``gen`` draws on its own device (the CPU, or
    edge_type's).  Returns (src, dst) int64 tensors [E]."""
    e = edge_type.shape[0]

    def draw():
        pair = torch.randint(0, n_nodes * n_nodes, (e,), generator=gen,
                             dtype=torch.int64, device=gen.device
                             ).to(edge_type.device)
        return pair, collides(pair, edge_type, bitmap, n_nodes)

    pair, hit = draw()
    for _ in range(1, rounds):
        new_pair, new_hit = draw()
        pair = torch.where(hit, new_pair, pair)
        hit = hit & new_hit
    # pair = dst * n + src (the (type, dst, src) key order)
    return pair % n_nodes, pair // n_nodes


def typed_negative_sampling_chunked(seed: int, chunk_type, bitmap,
                                    n_nodes: int, n_et: int, chunk: int,
                                    u24=None, backend: str = "pallas",
                                    rounds: int = 4):
    """Negatives for a chunk-aligned buffer: (src2d, dst2d)
    [n_chunks, chunk], one per slot, from the step ``seed``.  'pallas':
    int32, on CUDA one launch of kernel B10 draws, resolves and splits them
    (``u24`` replaces its draws: ops/sampler.py); 'xla': int64, the flat
    sampler with ``rounds`` rounds (``u24`` is the kernel route's and
    raises here)."""
    if backend == "pallas":
        return typed_negative_sampling_padded(seed, chunk_type, bitmap,
                                              n_nodes, n_et, chunk, u24=u24,
                                              split=True)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}: 'pallas' or 'xla'")
    if u24 is not None:
        raise ValueError("u24 draws are kernel B10's; the xla route draws "
                         "from its own generator")
    gen = torch.Generator(device=chunk_type.device).manual_seed(int(seed))
    et = torch.repeat_interleave(chunk_type.long(), chunk)
    src, dst = typed_negative_sampling(gen, et, bitmap, n_nodes, rounds)
    shape = (chunk_type.shape[0], chunk)
    return src.reshape(shape), dst.reshape(shape)
