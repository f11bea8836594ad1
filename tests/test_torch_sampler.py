"""Kernel B10 of the port (tip_tpu_torch/ops/sampler.py, the typed negative
sampler of the chunked layout) against the JAX package on the CPU.

The CPU runs the plain PyTorch version; chip_smoke.py holds the CUDA kernel
against it on the card, pair for pair under one seed.  Here:

  * handed the 24-bit draws that JAX's kernel streams in on the CPU
    (``jax.random.bits(key, (n_chunks, 1, draws * chunk)) >> 8``), the port
    gives JAX's pairs exactly, flags and all, in the one-draw and the
    two-draw (n > 4096) regime, before and after the lane-borrow pass;
  * its own hashed draws keep the sampler's invariants and are uniform
    over a relation's non-positives (chi-square, as in
    tests/test_sampler_stats.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy import stats

from tip_tpu.ops.pallas_sampler import (
    resolve_borrow as j_resolve,
    typed_negative_sampling_padded as j_sample,
)
from tip_tpu.sampling.negative import bitmap_stride_bits, build_key_bitmap
from tip_tpu_torch import kernels
from tip_tpu_torch.ops import sampler as port
from tip_tpu_torch.sampling import bitmap_tensor, typed_negative_sampling_chunked


def _jax_bits(key, n_chunks, width):
    """The draws JAX's sampler streams into its kernel on the CPU."""
    return np.asarray(jax.random.bits(key, (n_chunks, 1, width), jnp.uint32)
                      >> 8).astype(np.int32)


def _pairs_of(u24, n):
    """The pairs the draws map to (numpy, the kernel's f32 arithmetic)."""
    u = u24[:, 0].astype(np.float32)
    if n * n > (1 << 24):
        c = u.shape[1] // 2
        scale = np.float32(n / (1 << 24))
        src = np.minimum((u[:, :c] * scale).astype(np.int32), n - 1)
        dst = np.minimum((u[:, c:] * scale).astype(np.int32), n - 1)
        return dst.astype(np.int64) * n + src
    scale = np.float32(n * n / (1 << 24))
    return np.minimum((u * scale).astype(np.int64), n * n - 1)


@pytest.mark.parametrize("n,chunk,n_chunks,n_et", [(40, 64, 12, 3),
                                                   (5000, 128, 4, 2)])
def test_matches_jax_kernel_under_the_same_bits(n, chunk, n_chunks, n_et):
    """Half of the slots' first draws are made positives of their relation,
    so both the clean and the sign-flagged path are exercised."""
    key = jax.random.key(7)
    draws = port.draws_per_slot(n)
    assert draws == (2 if n > 4096 else 1)
    u24 = _jax_bits(key, n_chunks, draws * chunk)
    chunk_type = np.repeat(np.arange(n_et, dtype=np.int32),
                           -(-n_chunks // n_et))[:n_chunks]
    pairs = _pairs_of(u24, n)
    hit = np.random.default_rng(0).random(pairs.shape) < 0.5
    stride = bitmap_stride_bits(n)
    bits = chunk_type[:, None].astype(np.int64) * stride + pairs
    bitmap = build_key_bitmap(np.unique(bits[hit]), n_et * stride)
    with pltpu.force_tpu_interpret_mode():
        want_raw = np.asarray(j_sample(key, jnp.asarray(chunk_type),
                                       jnp.asarray(bitmap), n, n_et, chunk,
                                       _resolve=False))
    got_raw = port.typed_negative_sampling_padded(
        0, torch.from_numpy(chunk_type), bitmap_tensor(bitmap), n, n_et, chunk,
        u24=torch.from_numpy(u24), resolve=False)
    np.testing.assert_array_equal(got_raw.numpy(), want_raw)
    assert (want_raw < 0).any() and (want_raw >= 0).any()
    np.testing.assert_array_equal(port.resolve_borrow(got_raw).numpy(),
                                  np.asarray(j_resolve(jnp.asarray(want_raw))))


def test_rejects_int32_overflow_nodes():
    with pytest.raises(ValueError, match="int32 pair"):
        port.typed_negative_sampling_padded(
            0, torch.zeros(1, dtype=torch.int32),
            torch.zeros(bitmap_stride_bits(50000) // 32, dtype=torch.int32),
            50000, 1, 8)


def _dense_setup():
    """n = 32: relation 0 at ~5% density, relation 1 at 60%."""
    n = 32
    rng = np.random.default_rng(7)
    pos = [rng.choice(n * n, size=51, replace=False),
           rng.choice(n * n, size=614, replace=False)]
    stride = bitmap_stride_bits(n)
    bits = np.concatenate([t * stride + p for t, p in enumerate(pos)])
    bitmap = build_key_bitmap(bits.astype(np.int64), 2 * stride)
    chunk_type = np.repeat(np.arange(2, dtype=np.int32), 50)
    return n, pos, bitmap_tensor(bitmap), torch.from_numpy(chunk_type)


def test_hashed_draws_invariants():
    n, pos, bitmap, ct = _dense_setup()
    raw = port.typed_negative_sampling_padded(3, ct, bitmap, n, 2, 64,
                                              resolve=False)
    again = port.typed_negative_sampling_padded(3, ct, bitmap, n, 2, 64,
                                                resolve=False)
    other = port.typed_negative_sampling_padded(4, ct, bitmap, n, 2, 64,
                                                resolve=False)
    assert torch.equal(raw, again) and not torch.equal(raw, other)
    pair = torch.where(raw < 0, -raw - 1, raw)
    assert int(pair.min()) >= 0 and int(pair.max()) < n * n
    # the flag is exactly "pair is a positive of the chunk's relation"
    is_pos = np.zeros((2, n * n), bool)
    for t, p in enumerate(pos):
        is_pos[t, p] = True
    et = np.repeat(ct.numpy()[:, None], 64, 1)
    np.testing.assert_array_equal((raw < 0).numpy(), is_pos[et, pair.numpy()])
    # after the borrow pass a collision is only a lane whose whole
    # neighbourhood collided, left as drawn
    res = port.resolve_borrow(raw).numpy()
    still = is_pos[et, res]
    assert np.all(raw.numpy()[still] < 0)
    assert np.all(res[still] == -raw.numpy()[still] - 1)
    assert still[:50].mean() < 1e-3  # the 5% relation: ~density^5
    assert still[50:].mean() < 3 * 0.6**5 + 0.02  # the 60% relation


def test_hashed_draws_uniform_over_non_positives():
    """Clean draws of the 5% relation, over 8 seeds: chi-square against
    uniform over its non-positives (test_sampler_stats.py's check)."""
    n, pos, bitmap, ct = _dense_setup()
    nonpos = np.setdiff1d(np.arange(n * n), pos[0])
    clean = []
    for s in range(8):
        raw = port.typed_negative_sampling_padded(
            s, ct, bitmap, n, 2, 64, resolve=False).numpy()[:50]
        clean.append(raw[raw >= 0])
    clean = np.concatenate(clean)
    assert clean.size > 20000
    counts = np.bincount(np.searchsorted(nonpos, clean), minlength=nonpos.size)
    assert counts.sum() == clean.size
    _, p = stats.chisquare(counts)
    assert p > 1e-6


def test_hashed_draws_two_draw_regime_uniform():
    n = 5000
    stride = bitmap_stride_bits(n)
    bitmap = torch.zeros(stride // 32, dtype=torch.int32)
    ct = torch.zeros(16, dtype=torch.int32)
    pair = np.concatenate([port.typed_negative_sampling_padded(
        s, ct, bitmap, n, 1, 256).numpy().ravel() for s in range(4)])
    src, dst = pair % n, pair // n
    for v in (src, dst):
        _, p = stats.chisquare(np.bincount(v * 50 // n, minlength=50))
        assert p > 1e-6
    _, p = stats.chisquare(np.bincount((src * 8 // n) * 8 + dst * 8 // n,
                                       minlength=64))
    assert p > 1e-6
    # beyond the one-draw grid of 2^24 fixed-point pairs
    g = (n * n) / float(1 << 24)
    assert (np.ceil(pair / g) * g >= pair + 1).mean() > 0.05


def test_chunked_entry_point_and_cuda_wrapper():
    n, _, bitmap, ct = _dense_setup()
    kernels.reset_launch_counts()
    src, dst = typed_negative_sampling_chunked(5, ct, bitmap, n, 2, 64)
    assert src.shape == dst.shape == (100, 64) and src.dtype == torch.int32
    pair = port.typed_negative_sampling_padded(5, ct, bitmap, n, 2, 64)
    assert torch.equal(dst * n + src, pair)
    assert kernels.LAUNCHES[port.KERNEL] == 0
    with pytest.raises(ValueError, match="CUDA"):
        port.typed_negative_sampling_cuda(5, ct, bitmap, n, 64)
    with pytest.raises(ValueError, match="words"):
        port.typed_negative_sampling_padded(5, ct, bitmap[:-1], n, 2, 64)
