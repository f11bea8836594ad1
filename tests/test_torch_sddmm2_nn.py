"""Kernel B9 of the port (tip_tpu_torch/ops/sddmm2.py, the NN-decoder SDDMM)
against the JAX package's nn_logits_padded2 on the CPU.

The CPU runs the plain PyTorch version; chip_smoke.py holds the CUDA kernel
against it on the card.  The JAX kernel runs in interpret mode, as
tests/test_sddmm2_nn.py runs it.  Pad slots score their pad src in both
packages (the caller masks them), so logits are compared masked by valid,
to 1e-5.  Gradients take one shared cotangent, pad slots included, and
agree to 1e-4 (float32 sums in another order: per chunk then per relation
in the JAX kernel, per (relation, endpoint) in the port).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import synthetic_trigraph
from tip_tpu.data.packing import pad_typed_edges, sort_typed_edges, split_typed_edges
from tip_tpu.ops.pallas_sddmm2 import nn_logits_padded2 as j_nn
from tip_tpu_torch import kernels
from tip_tpu_torch.ops import sddmm2 as port
from tip_tpu_torch.ops.matmul import compute_round


def _setup(n_drug, seed=5, skewed=False):
    """Packed buffers (chunk 32), float32 parameters and the valid mask.
    ``skewed``: relation 0 holds every drug pair (1,482 train slots at 40
    drugs, 47 chunks: several work items), the others 15-45 pairs."""
    raw = synthetic_trigraph(n_drug=n_drug, n_prot=10, n_et=4,
                             pairs_per_et=30 if skewed else 60, seed=seed)
    if skewed:
        lo, hi = np.triu_indices(n_drug, 1)
        raw = dataclasses.replace(raw, dd_pair_list=[
            np.stack([lo, hi]).astype(np.int32), *raw.dd_pair_list[1:]])
    edges, _ = split_typed_edges(raw.dd_pair_list, p=0.95, seed=0)
    padded = pad_typed_edges(sort_typed_edges(edges), n_drug, chunk=32)
    nc = padded.chunk_type.shape[0]
    bufs = (padded.src.reshape(nc, 32), padded.dst.reshape(nc, 32),
            padded.chunk_type)
    rng = np.random.default_rng(seed)
    h1, h2 = np.maximum(rng.normal(size=(2, n_drug, 16)), 0).astype(np.float32)
    w1, w2 = rng.normal(size=(2, edges.n_et, 16)).astype(np.float32)
    valid = padded.valid.reshape(nc, 32).astype(np.float32)
    return bufs, (h1, h2, w1, w2), valid


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("n_drug", [40, 150])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_grads_match_jax(n_drug, dtype):
    bufs, params, valid = _setup(n_drug)
    jb = list(map(jnp.asarray, bufs))
    cot = np.random.default_rng(1).normal(size=valid.shape).astype(np.float32)

    def jloss(*p):
        lg = j_nn(*p, *jb, n_drug, jnp.dtype(dtype))
        return jnp.sum(lg * cot), lg

    with pltpu.force_tpu_interpret_mode():
        (_, jlg), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, params))
    ts = [torch.tensor(p, requires_grad=True) for p in params]
    lg = port.nn_logits_padded2(*ts, *_t(bufs), n_drug, dtype)
    (lg * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(lg.detach().numpy() * valid,
                               np.asarray(jlg) * valid, atol=1e-5)
    for t, want in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    # pad slots: the dst term is exactly 0, so a pad logit is its src score
    pad = valid == 0
    assert pad.any()
    h1, _, w1, _ = (compute_round(torch.from_numpy(p), dtype).numpy()
                    if i < 2 else p for i, p in enumerate(params))
    src, _, ct = bufs
    want_pad = (h1[src] * w1[ct][:, None, :]).sum(-1)
    np.testing.assert_allclose(lg.detach().numpy()[pad], want_pad[pad],
                               atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_backward_matches_autograd_of_per_slot_formula(bf16):
    """The hand-written backward (the CUDA kernel's factoring through the
    per-(relation, endpoint) sums of g) equals autograd through the
    per-slot formula; with bf16 each scattered dh contribution is rounded,
    which autograd does not do, so dh is held to bf16 rounding there."""
    bufs, params, _ = _setup(150, seed=3)
    g = np.random.default_rng(4).normal(size=bufs[0].shape).astype(np.float32)
    ts = [torch.tensor(p, requires_grad=True) for p in params]
    src, dst, ct = (torch.from_numpy(b).long() for b in bufs)
    h2p = torch.nn.functional.pad(ts[1], (0, 0, 0, 1))
    w1t, w2t = ts[2][ct][:, None, :], ts[3][ct][:, None, :]
    per_slot = (ts[0][src] * w1t).sum(-1) + (h2p[dst] * w2t).sum(-1)
    (per_slot * torch.from_numpy(g)).sum().backward()
    got = port.nn_bwd_plain(*_t(params), *_t(bufs), torch.from_numpy(g), bf16)
    want = [t.grad for t in ts]
    for i, (a, b) in enumerate(zip(got, want)):
        if bf16 and i < 2:
            # each contribution rounded to bf16: 2^-9 relative a term
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=4e-3 * float(b.abs().max()))
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                       rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_cuda_wrapper_refuses_them():
    bufs, params, _ = _setup(40)
    kernels.reset_launch_counts()
    ts = [torch.tensor(p, requires_grad=True) for p in params]
    port.nn_logits_padded2(*ts, *_t(bufs), 40).sum().backward()
    assert kernels.LAUNCHES[port.NN_KERNEL] == 0
    with pytest.raises(ValueError, match="CUDA"):
        port.nn_logits_cuda(*_t(params), *_t(bufs))
    with pytest.raises(ValueError, match="CUDA"):
        port.nn_bwd_cuda(*_t(params), *_t(bufs), torch.zeros(bufs[0].shape))
    with pytest.raises(ValueError, match="rows"):
        port.nn_logits_padded2(*ts, *_t(bufs), 41)


@pytest.mark.parametrize("bad", ["width", "nodes", "dtype", "h2", "w2"])
def test_cuda_argument_checks(bad):
    """What the CUDA wrapper refuses before it hands pointers to the kernel
    (the checks need no card)."""
    bufs, params, _ = _setup(40)
    args = [*_t(params), *_t(bufs)]
    port._check_nn_args(*args, table="shared")  # valid: passes
    if bad == "width":  # the kernel is built for l1 = 16
        args[:4] = [a[:, :12].contiguous() for a in args[:4]]
    elif bad == "nodes":  # the shared-memory vectors no longer fit
        args[0] = args[1] = torch.zeros(29056, 16)
    elif bad == "dtype":
        args[4] = args[4].long()
    elif bad == "h2":
        args[1] = args[1][:-1].contiguous()
    else:
        args[3] = args[3][:-1].contiguous()
    with pytest.raises(ValueError):
        port._check_nn_args(*args, table="shared")


def test_shared_vector_boundary():
    """The largest graph whose work items' score rows / gradient sums
    (2 (n + 1) floats) the kernel keeps in shared memory; one node more
    takes the global-memory mode, which has no limit."""
    n_max = 29055
    assert port.nn_shared_fits(n_max) and not port.nn_shared_fits(n_max + 1)
    bufs, params, _ = _setup(40)
    w = _t(params[2:])
    for n, shared in ((n_max, True), (n_max + 1, False), (100_000, False)):
        h = torch.zeros(n, 16)
        assert port._check_nn_args(h, h, *w, *_t(bufs)) == (n, shared)
        assert port._check_nn_args(h, h, *w, *_t(bufs),
                                   table="global") == (n, False)


def test_work_items_cover_every_slot_once_within_their_relation():
    """nn_items (the kernel's plan) cuts each relation's chunks into runs of
    at most ITEM_CHUNKS, near-equal and in chunk order: every chunk, so
    every slot, lies in exactly one item, of the relation that owns it; the
    count stays within nn_max_items, which the wrapper allocates for."""
    item_chunks = port.ITEM_CHUNKS
    bufs, params, _ = _setup(40, skewed=True)
    ct, n_et = bufs[2], params[2].shape[0]
    rng = np.random.default_rng(9)
    cases = [ct] + [np.sort(rng.integers(0, n_et, size=rng.integers(1, 200)))
                    for _ in range(20)]
    for c in cases:
        items, rel_items = port.nn_items(c, n_et)
        covered = np.zeros(len(c), np.int64)
        for t in range(n_et):
            own = items[rel_items[t]:rel_items[t + 1]]
            assert (own[:, 0] == t).all()
            sizes = own[:, 2] - own[:, 1]
            assert (sizes > 0).all() and (sizes <= item_chunks).all()
            assert len(sizes) == 0 or np.ptp(sizes) <= 1
            assert (own[1:, 1] == own[:-1, 2]).all()  # in chunk order
            for _, c0, c1 in own:
                assert (c[c0:c1] == t).all()
                covered[c0:c1] += 1
        assert (covered == 1).all() and rel_items[-1] == len(items)
        assert len(items) <= port.nn_max_items(len(c), n_et)
    items, _ = port.nn_items(ct, n_et)
    assert (items[:, 0] == 0).sum() >= 3  # the heavy relation is cut up


def _warp_add(acc, keys, vals):
    """nn_sddmm.cu's warp_add for the active lanes (a prefix of the warp):
    a segmented scan in lane order where the keys rise across the lanes,
    its last lane adding the run's sum; else one rank of equal keys at a
    time, in lane order."""
    f = np.float32
    v = vals.astype(f)
    if (np.diff(keys) >= 0).all():
        head = np.array([np.flatnonzero(keys == k)[0] for k in keys])
        off = 1
        while off < 32:
            prev = v.copy()
            for lane in range(len(v)):
                if lane - off >= head[lane]:
                    v[lane] = f(prev[lane] + prev[lane - off])
            off *= 2
        for lane, k in enumerate(keys):
            if lane == len(keys) - 1 or keys[lane + 1] != k:
                acc[k] = f(acc[k] + v[lane])
    else:
        for lane, k in enumerate(keys):  # rank order is lane order per key
            acc[k] = f(acc[k] + v[lane])


def emulate_cuda_bwd(h1, h2, w1, w2, src2d, dst2d, ct, g):
    """nn_sddmm.cu's float32 backward in its fixed order (products rounded
    before each add: numpy has no fused multiply-add).  Per item, warp w of
    the block sums g by endpoint over the 128-slot groups w, w + W, ... (in
    four steps j, lane l adding slot 4 l + j) into its own vectors, added in
    warp order; then rows (dw: a relation's items
    in order, j strided over 16 lanes, the lanes in order) and cols (dh:
    slabs of CONTRACT_SLAB items, items strided over 16 lanes, lanes then
    slabs in order)."""
    f = np.float32
    n, d = h1.shape
    n_et = w1.shape[0]
    C = src2d.shape[1]
    src, dst, gf = src2d.reshape(-1), dst2d.reshape(-1), g.reshape(-1)
    items, rel_items = port.nn_items(ct, n_et)
    warps = min(8, kernels.SMEM_BYTES // (8 * (n + 1)))
    gs = np.zeros((len(items), 2, n + 1), f)
    for i, (_, c0, c1) in enumerate(items):
        vec = np.zeros((warps, 2, n + 1), f)
        for w in range(warps):
            for base in range(c0 * C + 128 * w, c1 * C, 128 * warps):
                for j in range(4):
                    lanes = np.arange(base + j, min(base + 128, c1 * C), 4)
                    _warp_add(vec[w, 0], src[lanes], gf[lanes])
                    _warp_add(vec[w, 1], dst[lanes], gf[lanes])
        gs[i] = vec[0]
        for w in range(1, warps):
            gs[i] = (gs[i] + vec[w]).astype(f)
    slabs = port.contract_slabs(port.nn_max_items(src2d.shape[0], n_et))
    out = []
    for side, (x, wt) in enumerate(((h1, w1), (h2, w2))):
        a = gs[:, side, :n]
        dw = np.zeros((n_et, d), f)
        for t in range(n_et):
            lanes = np.zeros((16, d), f)
            for lane in range(16):
                for i in range(rel_items[t], rel_items[t + 1]):
                    for j in range(lane, n, 16):
                        lanes[lane] = (lanes[lane] + a[i, j] * x[j]).astype(f)
            for lane in range(16):
                dw[t] = (dw[t] + lanes[lane]).astype(f)
        dh = np.zeros((n, d), f)
        for sl in range(slabs):
            lo, hi = sl * port.CONTRACT_SLAB, min(len(items),
                                                  (sl + 1) * port.CONTRACT_SLAB)
            part = np.zeros((n, d), f)
            for lane in range(16):
                acc = np.zeros((n, d), f)
                for i in range(lo + lane, hi, 16):
                    acc = (acc + a[i][:, None] * wt[items[i, 0]][None, :]).astype(f)
                part = (part + acc).astype(f)
            dh = (dh + part).astype(f)
        out.append((dh, dw))
    (dh1, dw1), (dh2, dw2) = out
    return dh1, dh2, dw1, dw2


def test_cuda_backward_item_order_emulation_matches_plain_and_jax():
    """The item-partial backward summed in the kernel's fixed order
    (emulate_cuda_bwd) gives nn_bwd_plain and the JAX kernel's gradients
    (interpret mode) on a skewed graph, to test_logits_and_grads_match_jax's
    1e-4."""
    bufs, params, valid = _setup(40, skewed=True)
    g = np.random.default_rng(2).normal(size=valid.shape).astype(np.float32)
    got = emulate_cuda_bwd(*params, *bufs, g)
    plain = port.nn_bwd_plain(*_t(params), *_t(bufs), torch.from_numpy(g))
    jb = list(map(jnp.asarray, bufs))
    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.grad(lambda *p: jnp.sum(j_nn(*p, *jb, 40) * g),
                          argnums=(0, 1, 2, 3))(*map(jnp.asarray, params))
    for a, b, j in zip(got, plain, jgrads):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(a, np.asarray(j), atol=1e-4, rtol=1e-4)
