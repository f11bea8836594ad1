"""Typed negative sampling for chunk-aligned edge buffers (kernel B10).

Port of tip_tpu/ops/pallas_sampler.py (``typed_negative_sampling_padded``
with one full-width round, as sampling/negative.py calls it, and
``resolve_borrow``).  Every slot (c, j) of the [n_chunks, chunk] buffer
draws one candidate pair = dst * n + src for its chunk's relation:

  * n^2 <= 2^24: one 24-bit draw u, pair = min(int(f32(u) * f32(n^2 / 2^24)),
    n^2 - 1), the product an f32 multiply truncated toward zero;
  * n > 4096: two draws (words j and chunk + j of the chunk's draw row),
    src and dst each min(int(f32(u) * f32(n / 2^24)), n - 1).

A candidate that is a positive of the relation (bit ``pair & 7`` of byte
``pair >> 3`` of the relation's slice of the little-endian bitmap) comes
out sign-flagged as ``-pair - 1``; :func:`resolve_borrow` then lets each
flagged lane copy a clean lane of the same chunk at offsets 1, 2, 4, 8,
and the training step splits each pair into (pair % n, pair // n).  On
CUDA tensors one launch of the kernel draws, flags, runs the borrow pass
in shared memory and writes the pairs or their split, bit for bit what
the plain sampler, :func:`resolve_borrow` and the split give; the raw
flagged pairs stay available (``resolve=False``).

Random bits.  The TPU kernel draws from its on-chip PRNG.  Here word w of
chunk c's draw row is ``u24 = mix32(key_c ^ mix32(w)) >> 8`` with
``key_c = mix32(seed + mix32(c + 0x9E3779B9))`` — the 32-bit counter hash
of ops/dense_bce_sym.py with the chunk in place of the relation — in the
CUDA kernel (``csrc/typed_neg_sampler.cu``) and in the plain version
alike, so both give the same pairs for a seed.  Both also take explicit draws
``u24 [n_chunks, 1, draws * chunk]`` (values below 2^24), the layout of
the bits the JAX kernel streams in on the CPU, in place of the hashed ones.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tip_tpu_torch import kernels
from tip_tpu_torch.data.packing import bitmap_stride_bits
from tip_tpu_torch.ops.dense_bce_sym import u24_field

KERNEL = "typed_neg_sampler"
MAX_NODES = 46340  # floor(sqrt(2^31 - 1)): int32 pair = dst * n + src


def draws_per_slot(n_nodes: int) -> int:
    """One 24-bit draw per slot up to 4096 nodes, two (src, dst) above."""
    return 2 if n_nodes * n_nodes > (1 << 24) else 1


def draw_scale(n_nodes: int) -> np.float32:
    """The f32 fixed-point scale of a 24-bit draw, rounded as
    ``jnp.float32(...)`` rounds the JAX kernel's constant."""
    if draws_per_slot(n_nodes) == 2:
        return np.float32(n_nodes / (1 << 24))
    return np.float32((n_nodes * n_nodes) / (1 << 24))


def _check_nodes(n_nodes: int) -> None:
    if n_nodes > MAX_NODES:
        raise ValueError(
            f"n_nodes={n_nodes}: int32 pair encoding (dst * n + src) "
            "overflows; the sampler needs 64-bit keys for graphs this large")


def sampler_u24(seed: int, n_chunks: int, width: int, device=None):
    """The hashed draws [n_chunks, 1, width] int64 of a seed."""
    chunks = torch.arange(n_chunks, device=device)
    return u24_field(seed & 0xFFFFFFFF, chunks,
                     torch.zeros(1, dtype=torch.int64, device=device),
                     torch.arange(width, device=device), width)


def typed_negative_sampling_plain(seed: int, chunk_type, bitmap, n_nodes: int,
                                  chunk: int, u24: Optional[torch.Tensor] = None):
    """Sign-flagged raw pairs [n_chunks, chunk] int32 (before the borrow
    pass).  bitmap: the relation-strided uint32 words as int32."""
    _check_nodes(n_nodes)
    n_chunks = chunk_type.shape[0]
    dev = chunk_type.device
    draws = draws_per_slot(n_nodes)
    if u24 is None:
        u24 = sampler_u24(seed, n_chunks, draws * chunk, dev)
    u = u24.to(dev).reshape(n_chunks, draws, chunk).float()
    scale = torch.tensor(draw_scale(n_nodes), device=dev)
    if draws == 2:
        src = torch.clamp((u[:, 0] * scale).to(torch.int32), max=n_nodes - 1)
        dst = torch.clamp((u[:, 1] * scale).to(torch.int32), max=n_nodes - 1)
        pair = dst * n_nodes + src
    else:
        pair = torch.clamp((u[:, 0] * scale).to(torch.int32),
                           max=n_nodes * n_nodes - 1)
    stride_bytes = bitmap_stride_bits(n_nodes) // 8
    byte_at = (chunk_type.long()[:, None] * stride_bytes
               + (pair.long() >> 3))
    byte = bitmap.contiguous().view(torch.uint8)[byte_at].to(torch.int32)
    hit = ((byte >> (pair & 7)) & 1) != 0
    return torch.where(hit, -pair - 1, pair)


OUTPUTS = ("raw", "pair", "split")  # what the CUDA kernel writes
MAX_CHUNK = 4096  # the kernel's block holds a chunk (in 32 KB of shared memory)


def typed_negative_sampling_cuda(seed: int, chunk_type, bitmap, n_nodes: int,
                                 chunk: int, u24: Optional[torch.Tensor] = None,
                                 output: str = "raw"):
    """Launch csrc/typed_neg_sampler.cu on the card, from the seed's hashed
    draws or from ``u24``.  ``output``: "raw", the sign-flagged pairs of
    :func:`typed_negative_sampling_plain`; "pair", the pairs after
    :func:`resolve_borrow`; "split", those pairs' (src, dst) = (pair % n,
    pair // n), the kernel's borrow pass and split in the same launch."""
    _check_nodes(n_nodes)
    dev = chunk_type.device
    if not chunk_type.is_cuda:
        raise ValueError("typed_negative_sampling_cuda needs CUDA tensors")
    if output not in OUTPUTS:
        raise ValueError(f"output {output!r} not in {OUTPUTS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes 1 .. {MAX_CHUNK}")
    kernels.require(chunk_type, "chunk_type", torch.int32, 1, dev)
    kernels.require(bitmap, "bitmap", torch.int32, 1, dev)
    n_chunks = chunk_type.shape[0]
    draws = draws_per_slot(n_nodes)
    if u24 is not None:
        if u24.numel() != n_chunks * draws * chunk:
            raise ValueError(f"u24 has {u24.numel()} draws, expected "
                             f"{n_chunks} x {draws * chunk}")
        u24 = u24.to(device=dev, dtype=torch.int32).contiguous()
    stride_bytes = bitmap_stride_bits(n_nodes) // 8
    out = torch.empty((n_chunks, chunk), dtype=torch.int32, device=dev)
    if output == "split":
        pair, src, dst = None, out, torch.empty_like(out)
    else:
        pair, src, dst = out, None, None
    kernels.launch(KERNEL, "tip_typed_neg_sampler", "pppuiiiifqippp",
                   chunk_type, bitmap, u24, seed & 0xFFFFFFFF, n_chunks, chunk,
                   n_nodes, draws, float(draw_scale(n_nodes)), stride_bytes,
                   int(output != "raw"), pair, src, dst, device=dev)
    return (src, dst) if output == "split" else pair


def resolve_borrow(out: torch.Tensor) -> torch.Tensor:
    """Lane-borrow collision resolution: a sign-flagged lane takes the
    candidate of a clean lane of the same chunk (same relation) at offsets
    1, 2, 4, 8, each pass reading the previous one's output.  Borrowed
    values are copies of clean uniform draws, so each lane's marginal stays
    uniform over the relation's non-positives.  Lanes still flagged after
    the four passes (a whole neighbourhood of collisions, ~density^5) are
    accepted as drawn."""
    for shift in (1, 2, 4, 8):
        alt = torch.roll(out, shift, dims=1)
        out = torch.where((out < 0) & (alt >= 0), alt, out)
    return torch.where(out < 0, -out - 1, out)


def typed_negative_sampling_padded(seed: int, chunk_type, bitmap,
                                   n_nodes: int, n_et: int, chunk: int,
                                   u24: Optional[torch.Tensor] = None,
                                   resolve: bool = True, split: bool = False):
    """Negatives for a chunk-aligned typed edge buffer.

    seed: uint32 step seed; chunk_type [n_chunks] int32 (non-decreasing);
    bitmap: relation-strided uint32 words as int32 [n_et * stride / 32].
    ``u24`` replaces the hashed draws.  Returns pair [n_chunks, chunk]
    int32 with pair = dst * n_nodes + src (raw and sign-flagged with
    ``resolve=False``), or with ``split`` the resolved pairs' (src, dst).
    CUDA tensors take one launch of the kernel for all of it; CPU tensors
    the plain sampler, :func:`resolve_borrow`, then ``%`` and ``//``."""
    if bitmap.numel() * 32 != n_et * bitmap_stride_bits(n_nodes):
        raise ValueError(f"bitmap has {bitmap.numel()} words, expected "
                         f"{n_et * bitmap_stride_bits(n_nodes) // 32}")
    if split and not resolve:
        raise ValueError("split takes the resolved pairs")
    if chunk_type.is_cuda:
        output = "split" if split else "pair" if resolve else "raw"
        return typed_negative_sampling_cuda(seed, chunk_type, bitmap, n_nodes,
                                            chunk, u24, output)
    if chunk_type.device.type != "cpu":
        raise ValueError(f"no sampler for device {chunk_type.device}")
    out = typed_negative_sampling_plain(seed, chunk_type, bitmap, n_nodes,
                                        chunk, u24)
    if not resolve:
        return out
    pair = resolve_borrow(out)
    return (pair % n_nodes, pair // n_nodes) if split else pair
