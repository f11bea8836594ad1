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
    tests/test_sampler_stats.py);
  * the CUDA kernel's order (draws, flags, four borrow rounds through a
    shared-memory row, un-flag, split), emulated in numpy, gives the plain
    route's (src, dst) exactly, and JAX's kernel + resolve_borrow's under
    the same bits.
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
    with pytest.raises(ValueError, match="resolved"):
        port.typed_negative_sampling_padded(5, ct, bitmap, n, 2, 64,
                                            resolve=False, split=True)


# ---------------------------------------------------------------------------
# The CUDA kernel's order: draws, flags, four borrow rounds through a copy
# of the chunk in shared memory, un-flag, split (csrc/typed_neg_sampler.cu)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x):
    """The kernel's lowbias32 mixer on uint64 arrays of 32-bit values."""
    x = np.asarray(x, np.uint64) & _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def emulate_fused(seed, chunk_type, bitmap, n, chunk, u24=None):
    """(src, dst) [n_chunks, chunk] as the kernel makes them, one chunk a
    block: each lane draws (hashed from the chunk's key, or word j and
    chunk + j of its row of ``u24``), keeps (signed pair, src | dst << 16)
    with src, dst from the draws in the two-draw mode and from one
    division in the one-draw mode; round r writes the row, reads lane j - s
    (s = 2^r mod chunk; + chunk below 0) and takes it where its own value
    is flagged and the other clean; then a flagged lane is un-flagged and
    the split read from the carried word."""
    draws = port.draws_per_slot(n)
    scale = port.draw_scale(n)
    stride = bitmap_stride_bits(n) // 8
    bytes_ = np.asarray(bitmap, np.uint32).view(np.uint8)
    lanes = np.arange(chunk)
    src_out = np.zeros((len(chunk_type), chunk), np.int32)
    dst_out = np.zeros_like(src_out)
    for c, t in enumerate(np.asarray(chunk_type)):
        if u24 is None:
            key = _mix32(np.uint64((seed + int(_mix32(c + 0x9E3779B9))) & _M32))
            words = (_mix32(key ^ _mix32(np.arange(draws * chunk))) >> 8)
        else:
            words = np.asarray(u24[c]).reshape(-1).astype(np.uint64)
        u = words.astype(np.float32)
        if draws == 2:
            src = np.minimum((u[:chunk] * scale).astype(np.int64), n - 1)
            dst = np.minimum((u[chunk:] * scale).astype(np.int64), n - 1)
            pair = dst * n + src
        else:
            pair = np.minimum((u * scale).astype(np.int64), n * n - 1)
            dst = pair // n
            src = pair - dst * n
        byte = bytes_[int(t) * stride + (pair >> 3)].astype(np.int64)
        p = np.where((byte >> (pair & 7)) & 1, -pair - 1, pair)
        sd = src | (dst << 16)
        for r in range(4):
            s = (1 << r) % chunk
            other = np.where(lanes >= s, lanes - s, lanes - s + chunk)
            row_p, row_sd = p.copy(), sd.copy()  # the shared-memory row
            take = (p < 0) & (row_p[other] >= 0)
            p = np.where(take, row_p[other], p)
            sd = np.where(take, row_sd[other], sd)
        src_out[c] = sd & 0xFFFF
        dst_out[c] = sd >> 16
    return src_out, dst_out


def _wrap_setup(n, chunk, n_chunks, n_et, u24):
    """A bitmap that flags the first 3 lanes of every chunk and about a
    third of the others: lanes 0-2 borrow across lane 0 from the chunk's
    last lanes."""
    chunk_type = np.repeat(np.arange(n_et, dtype=np.int32),
                           -(-n_chunks // n_et))[:n_chunks]
    pairs = _pairs_of(u24, n)
    hit = np.random.default_rng(1).random(pairs.shape) < 1 / 3
    hit[:, :3] = True
    hit[:, -3:] = False
    stride = bitmap_stride_bits(n)
    bits = chunk_type[:, None].astype(np.int64) * stride + pairs
    flagged = np.isin(bits, np.unique(bits[hit]))
    return chunk_type, build_key_bitmap(np.unique(bits[hit]), n_et * stride), flagged


@pytest.mark.parametrize("n,chunk", [(40, 64), (5000, 128), (40, 6)])
@pytest.mark.parametrize("draws", ["hashed", "explicit"])
def test_fused_kernel_order_emulation_matches_plain_route(n, chunk, draws):
    """The kernel's pass order (emulate_fused) equals the plain route,
    resolve_borrow over the plain sampler then % and //, exactly: one- and
    two-draw modes, hashed and explicit draws, a chunk shorter than the
    largest shift, and flagged lanes that borrow across lane 0."""
    n_chunks, n_et = 9, 3
    per_slot = port.draws_per_slot(n)
    u24 = _jax_bits(jax.random.key(3), n_chunks, per_slot * chunk)
    ct, bitmap, flagged = _wrap_setup(n, chunk, n_chunks, n_et, u24)
    given = None if draws == "hashed" else u24
    src, dst = emulate_fused(11, ct, bitmap, n, chunk, given)
    tu24 = None if given is None else torch.from_numpy(given)
    pair = port.resolve_borrow(port.typed_negative_sampling_plain(
        11, torch.from_numpy(ct), bitmap_tensor(bitmap), n, chunk, tu24))
    np.testing.assert_array_equal(src, (pair % n).numpy())
    np.testing.assert_array_equal(dst, (pair // n).numpy())
    got = port.typed_negative_sampling_padded(
        11, torch.from_numpy(ct), bitmap_tensor(bitmap), n, n_et, chunk,
        u24=tu24, split=True)
    assert all(torch.equal(a, torch.from_numpy(b))
               for a, b in zip(got, (src, dst)))
    if draws == "explicit":
        # lane 0 took lane chunk - 1's clean pair across the wrap
        pairs = _pairs_of(u24, n)
        wrap = flagged[:, 0] & ~flagged[:, -1]
        assert wrap.sum() >= n_chunks // 2
        np.testing.assert_array_equal((dst * n + src)[wrap, 0],
                                      pairs[wrap, -1])


@pytest.mark.parametrize("n,chunk", [(40, 64), (5000, 128)])
def test_fused_kernel_order_emulation_matches_jax_under_the_same_bits(n, chunk):
    """Handed the bits JAX's kernel streams in on the CPU, the emulated
    kernel gives (src, dst) of tip_tpu's resolve_borrow over the JAX
    kernel's interpret-mode output."""
    n_chunks, n_et = 9, 3
    key = jax.random.key(5)
    u24 = _jax_bits(key, n_chunks, port.draws_per_slot(n) * chunk)
    ct, bitmap, _ = _wrap_setup(n, chunk, n_chunks, n_et, u24)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_sample(key, jnp.asarray(ct), jnp.asarray(bitmap),
                                   n, n_et, chunk))
    src, dst = emulate_fused(0, ct, bitmap, n, chunk, u24)
    np.testing.assert_array_equal(src, want % n)
    np.testing.assert_array_equal(dst, want // n)
