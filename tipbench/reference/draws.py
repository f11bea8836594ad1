"""The random draws of a training step, as rules the reference computes
itself.

Frozen copies of the rules the program's estimators are defined by, so
that the reference draws the same cells and pairs from the same seed
without running any of the program's code:

* ``step_seed``: the seed of training step k (tip_tpu_torch/train/loop.py:
  ``step_seed``): the first uint32 of ``SeedSequence([seed, k])``.
* ``u24``: the counter hash of a cell (tip_tpu_torch/ops/dense_bce_sym.py:
  ``mix32``, ``u24_field``; csrc/bce_cell.cuh): lowbias32 of the relation
  key and of the cell index ``row * npad + col``, top 24 bits.
* ``sampled_pairs``: one negative pair a slot of the chunk-aligned buffer
  (tip_tpu_torch/ops/sampler.py: the plain sampler, ``resolve_borrow``):
  the hash with the chunk in place of the relation, a float32 fixed-point
  scale, a flag on train positives, the lane-borrow pass at offsets 1, 2,
  4, 8 within the chunk.

Integer arithmetic runs in int64 holding uint32 values; products are split
into 16-bit halves so that none overflows.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def step_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def u24(seed: int, key_ids: torch.Tensor, rows: torch.Tensor,
        cols: torch.Tensor, npad: int) -> torch.Tensor:
    """[len(key_ids), len(rows), len(cols)] int64 draws below 2^24 of the
    cells (row, col) of a plane ``npad`` wide, keyed by relation (or chunk)
    ids ``key_ids``."""
    t = key_ids.to(torch.int64)
    key = mix32((int(seed) + mix32((t + GOLDEN) & M32)) & M32)
    cell = rows.to(torch.int64)[:, None] * npad + cols.to(torch.int64)[None, :]
    return mix32(key[:, None, None] ^ mix32(cell)[None]) >> 8


def sampled_pairs(seed: int, chunk_type: torch.Tensor, chunk: int,
                  is_positive, n: int) -> torch.Tensor:
    """Negative pairs (dst * n + src) [n_chunks, chunk] int64 of a step.

    ``is_positive(rel, pair)`` says which candidates are train positives
    of their relation.  Graphs of at most 4,096 nodes draw one 24-bit word
    a slot."""
    if n * n > (1 << 24):
        raise ValueError("the two-draw mode (n > 4096) is not in this rule")
    dev = chunk_type.device
    n_chunks = chunk_type.shape[0]
    u = u24(seed, torch.arange(n_chunks, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.arange(chunk, device=dev), chunk)[:, 0]
    scale = torch.tensor(np.float32((n * n) / (1 << 24)), device=dev)
    pair = torch.clamp((u.to(torch.float32) * scale).to(torch.int64),
                       max=n * n - 1)
    rel = chunk_type.to(torch.int64)[:, None].expand_as(pair)
    out = torch.where(is_positive(rel, pair), -pair - 1, pair)
    for shift in (1, 2, 4, 8):
        alt = torch.roll(out, shift, dims=1)
        out = torch.where((out < 0) & (alt >= 0), alt, out)
    return torch.where(out < 0, -out - 1, out)
