"""Kernel B3 of the port (tip_tpu_torch/ops/dense_bce_nn.py, the NN
decoder's fused dense BCE) against the JAX package on the CPU.

The CPU runs the plain PyTorch version; chip_smoke.py holds the CUDA kernel
against it on the card.  The JAX kernel in interpret mode draws u24 = 0 (a
cell's count is #{k : q_k > 0}), so the plain version fed an explicit zero
field must match it value for value and gradient for gradient.  The hashed
field is checked in the two deterministic threshold modes (q = 0 and
q = 2^24) against a float64 oracle, and statistically against the
estimator's analytic expectation.  The kernel reads the pages in the dtype
the graph ships them (uint8 beside DR-NN's strips, bf16 or float32 as the
full-page layout, where counts may pass 255): the same counts give one
result in every page dtype.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import build_trigraph, synthetic_trigraph
from tip_tpu.data.packing import dense_relation_adj, pad_dense_adj
from tip_tpu.ops.pallas_dense_bce_nn import dense_bce_nn_sum
from tests.torch_tile_math import (
    PLAIN_ULPS_NN, assert_readings, diagnosis, digest, digests, mkl_vml_ops,
    recorded,
)
from tip_tpu_torch import kernels
from tip_tpu_torch.data.packing import cast_dense_adj, poisson_neg_thresholds
from tip_tpu_torch.ops import dense_bce_nn as port

L1 = 16
_BUILT = {}  # digests of the fixture's inputs, taken when it built them


@pytest.fixture(scope="module")
def setup():
    # n_drug > 128: the kernel's row tiles and strips are ragged
    raw = synthetic_trigraph(n_drug=150, n_prot=16, n_et=6, pairs_per_et=120,
                             seed=3)
    data = build_trigraph(raw, split_rate=0.9, seed=3)
    da = dense_relation_adj(data.dd_train, data.n_drug)
    pages = cast_dense_adj(da, "uint8")
    q = poisson_neg_thresholds(data.dd_train, data.n_drug)
    rng = np.random.default_rng(0)
    w1, w2 = (0.4 * rng.standard_normal((2, data.n_et, L1))).astype(np.float32)
    h1, h2 = np.maximum(rng.standard_normal((2, data.n_drug, L1)),
                        0).astype(np.float32)
    _BUILT.update(digests(w1=w1, w2=w2, h1=h1, h2=h2, da=da, pages=pages))
    return data, da, pages, q, (w1, w2, h1, h2)


def _torch_value_and_grads(args, pages, q, seed, u24=None):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    loss = port.dense_bce_nn_sum(*ts, torch.from_numpy(pages),
                                 torch.from_numpy(q), seed, u24=u24)
    loss.backward()
    return loss.item(), [t.grad.numpy() for t in ts]


def _port_then_jax(args, pages, q, jpages):
    """The port's plain value and grads under u24 = 0, then the JAX
    kernel's (interpret mode) on ``jpages``; the port runs first, recorded
    op by op (``torch_tile_math.recorded``), and the digests of its outputs
    before the JAX call and the record come with them."""
    port_out, first_call = recorded(lambda: _torch_value_and_grads(
        args, pages, q, seed=3, u24=torch.zeros((), dtype=torch.int64)))
    port_out = (port_out[0], *port_out[1])
    before = _digests_of(port_out)
    with pltpu.force_tpu_interpret_mode():
        jval, jgrads = jax.value_and_grad(
            lambda a: dense_bce_nn_sum(*a, jpages, jnp.asarray(q),
                                       jax.random.key(3)))(
            tuple(map(jnp.asarray, args)))
    return (port_out, (float(jval), *map(np.asarray, jgrads)), before,
            first_call)


_NAMES = ("value", "dw1", "dw2", "dh1", "dh2")


def _digests_of(port_out):
    return digests(**{f"port {k} (before the JAX call)": np.asarray(
        v, np.float64 if k == "value" else np.float32)
        for k, v in zip(_NAMES, port_out)})


def _fresh_call(args, pages, q):
    """Fresh copies of the u24 = 0 test's inputs, built here, and the
    port's call on them, made as the first call was (only the call is
    recorded, so the two op streams start alike)."""
    args, pages, q = [a.copy() for a in args], pages.copy(), q.copy()

    def call():
        value, grads = _torch_value_and_grads(
            args, pages, q, seed=3, u24=torch.zeros((), dtype=torch.int64))
        return (value, *grads)
    return call


def _check_u24_zero(port_out, jax_out, args, da, pages, q, built, before,
                    first_call):
    """The port's plain version and the JAX kernel under u24 = 0, each
    against the float64 oracle and against each other, within a few
    float32 roundings of the sum of each result's absolute terms
    (tests/torch_tile_math.py: PLAIN_ULPS_NN for the plain version,
    JAX_ULPS where the JAX kernel takes part): with u24 = 0 every
    non-positive cell counts, so dh sums ~n * R terms of O(1) that cancel
    to small entries.  The port's outputs must come through the JAX call
    unchanged (``before``: their digests); a failing port reading
    recomputes the port from fresh copies of the inputs, checks the
    inputs against ``built``, names the cell with the largest error and
    the first op where the recomputation parts from the first call
    (``first_call``; ``torch_tile_math.diagnosis``)."""
    dan = np.asarray(da, np.float64)
    cnt = (q > 0).sum(1)[:, None, None] * (dan == 0)
    oracle, sabs = _oracle(args, dan, cnt, abs_sums=True)

    def cells():
        w1, w2, h1, h2 = (torch.tensor(a) for a in args)
        lg = (h2 @ w2.T).T[:, :, None] + (h1 @ w1.T).T[:, None, :]
        sp = port.softplus(-lg)
        dat = torch.from_numpy(dan.astype(np.float32))
        ct = torch.from_numpy(cnt.astype(np.float32))
        t32 = (sp * dat + (sp + lg) * ct).numpy()
        w1, w2, h1, h2 = (np.asarray(a, np.float64) for a in args)
        L = (h2 @ w2.T).T[:, :, None] + (h1 @ w1.T).T[:, None, :]
        sp64 = np.logaddexp(0.0, -L)
        return t32, sp64 * dan + (sp64 + L) * cnt, dict(
            logit32=lg.numpy(), logit64=L, count=cnt, page=dan)

    inputs = dict(zip(("w1", "w2", "h1", "h2"), args), da=da, pages=pages)
    assert_readings(
        _NAMES, port_out, jax_out, oracle, sabs, PLAIN_ULPS_NN,
        lambda: diagnosis(
            lambda: _fresh_call(args, pages, q),
            _NAMES, oracle, sabs, PLAIN_ULPS_NN, dict(built, **before),
            dict(inputs, **{f"port {k} (before the JAX call)": np.asarray(
                v, np.float64 if k == "value" else np.float32)
                for k, v in zip(_NAMES, port_out)}),
            cells, first_call))
    after = _digests_of(port_out)
    moved = [k for k in after if after[k] != before[k]]
    assert not moved, f"the JAX call changed the port's outputs {moved}"


def test_plain_u24_zero_matches_jax_interpret_kernel(setup):
    data, da, pages, _, args = setup
    # per-relation counts #{k: q_k > 0}, every value 0..3
    q = np.zeros((data.n_et, 3), np.int32)
    for t, c in enumerate([0, 1, 2, 3, 1, 2]):
        q[t, :c] = 7
    port_out, jax_out, before, first_call = _port_then_jax(
        args, pages, q, jnp.asarray(pad_dense_adj(da.astype(np.float32))))
    _check_u24_zero(port_out, jax_out, args, da, pages, q, _BUILT, before,
                    first_call)


@pytest.mark.parametrize("u24", ["zero", "hashed"])
def test_plain_version_calls_no_mkl_vml_function(setup, u24):
    """The plain version's value and gradients call no function that torch
    runs through MKL's VML on the CPU (torch_tile_math.MKL_VML_OPS): the
    first parallel exp of a process there can return one thread's share
    at about half of float32's precision (ROADMAP Queue C)."""
    _, _, pages, q, args = setup
    field = torch.zeros((), dtype=torch.int64) if u24 == "zero" else None
    _, record = recorded(lambda: _torch_value_and_grads(args, pages, q, 3,
                                                        u24=field))
    assert mkl_vml_ops(record) == []


def _oracle(args, da, cnt, abs_sums: bool = False):
    """float64 value and grads of the estimator for a fixed count field;
    with ``abs_sums`` also the sums of the absolute values of the terms of
    each."""
    w1, w2, h1, h2 = (np.asarray(a, np.float64) for a in args)
    L = (h2 @ w2.T).T[:, :, None] + (h1 @ w1.T).T[:, None, :]  # [R, i, j]
    sp = np.logaddexp(0.0, -L)
    val = (sp * da + (sp + L) * cnt).sum()
    g = cnt - (da + cnt) / (1.0 + np.exp(L))
    r, c = g.sum(2), g.sum(1)
    grads = [c @ h1, r @ h2, c.T @ w1, r.T @ w2]
    if not abs_sums:
        return val, grads
    ra, ca = np.abs(g).sum(2), np.abs(g).sum(1)
    sval = (np.abs(sp * da) + np.abs((sp + L) * cnt)).sum()
    return (val, *grads), (sval, ca @ np.abs(h1), ra @ np.abs(h2),
                           ca.T @ np.abs(w1), ra.T @ np.abs(w2))


@pytest.mark.parametrize("mode", ["positives_only", "saturated"])
def test_plain_hashed_field_deterministic_modes_vs_oracle(setup, mode):
    """q = 0 (no negatives) and q = 2^24 (count 3 on every non-positive
    cell) make the hashed field irrelevant."""
    data, da, pages, _, args = setup
    q = np.full((data.n_et, 3), 0 if mode == "positives_only" else 1 << 24,
                np.int32)
    val, grads = _torch_value_and_grads(args, pages, q, seed=7)
    dan = da.astype(np.float64)
    cnt = 0.0 if mode == "positives_only" else 3.0 * (dan == 0)
    oval, ograds = _oracle(args, dan, cnt)
    assert abs(val - oval) / abs(oval) < 1e-5
    for got, want in zip(grads, ograds):
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_plain_hashed_field_mean_matches_expectation(setup):
    """E[loss] over seeds equals the analytic expectation: each
    non-positive cell of relation t draws min(X, 3), X ~ Bin(m_t,
    1/nonpos_t), whose mean m_t / nonpos_t the truncation barely moves."""
    data, da, pages, q, args = setup
    w1, w2, h1, h2 = args
    L = (h2 @ w2.T).T[:, :, None] + (h1 @ w1.T).T[:, None, :]
    sp = np.logaddexp(0.0, -L)
    nonpos = da == 0
    m = np.bincount(data.dd_train.edge_type, minlength=data.n_et)
    mu = m / nonpos.reshape(data.n_et, -1).sum(1)
    expect = float((sp * da).sum() + sum(
        mu[t] * ((sp[t] + L[t]) * nonpos[t]).sum() for t in range(data.n_et)))
    ts = [torch.from_numpy(a) for a in (*args, pages, q)]
    vals = np.array([float(port.dense_bce_nn_sum(*ts, seed=s))
                     for s in range(48)])
    se = vals.std(ddof=1) / np.sqrt(len(vals))
    assert abs(vals.mean() - expect) < max(5 * se, 2e-3 * abs(expect)), (
        vals.mean(), expect, se)


def test_a_nan_in_h_reaches_the_loss(setup):
    """A NaN in one element of h1 makes the plain version's loss NaN, as in
    the JAX package; chip_smoke.py holds the kernel to the same (the
    training loop stops on a non-finite loss)."""
    _, _, pages, q, (w1, w2, h1, h2) = setup
    h1 = h1.copy()
    h1[75, 3] = np.nan
    loss, _ = _torch_value_and_grads((w1, w2, h1, h2), pages, q, seed=5)
    assert np.isnan(loss)


def test_value_only_equals_fused_and_cpu_wrapper_launches_nothing(setup):
    _, _, pages, q, args = setup
    kernels.reset_launch_counts()
    ts = [torch.from_numpy(a) for a in (*args, pages, q)]
    value = port.dense_bce_nn_sum(*ts, seed=11)
    fused = port.dense_bce_nn_plain(*ts, seed=11, grads=True)[0]
    assert float(value) == float(fused)
    # CPU tensors take the plain version: the kernel count stays at 0
    assert kernels.LAUNCHES[port.KERNEL] == 0
    with pytest.raises(ValueError, match="CUDA"):
        port.dense_bce_nn_cuda(*ts, seed=0)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "width", "shape",
                                 "square", "q", "aligned"])
def test_cuda_argument_checks(setup, bad):
    """The checks the CUDA wrapper runs before it hands pointers to the
    kernel (they need no card)."""
    _, _, pages, q, args = setup
    kw = dict(zip(("w1", "w2", "h1", "h2"), map(torch.from_numpy, args)),
              pages=torch.from_numpy(pages), q=torch.from_numpy(q))
    port._check_cuda_args(**kw)  # the valid call passes
    if bad == "dtype":  # the kernel reads uint8, bf16 or float32 pages
        kw["pages"] = kw["pages"].half()
    elif bad == "contiguous":
        kw["h1"] = torch.from_numpy(np.asfortranarray(args[2]))
    elif bad == "width":  # the kernel is built for l1 = 16
        for k in ("w1", "w2", "h1", "h2"):
            kw[k] = kw[k][:, :8].contiguous()
    elif bad == "shape":
        kw["w2"] = kw["w2"][:-1].contiguous()
    elif bad == "square":
        kw["pages"] = kw["pages"][:, :-1].contiguous()
    elif bad == "aligned":  # the kernel stages page rows by 16-byte chunks
        flat = torch.empty(pages.size + 1, dtype=torch.uint8)[1:]
        kw["pages"] = flat.view(pages.shape).copy_(kw["pages"])
    else:
        kw["q"] = kw["q"][:, :2].contiguous()
    with pytest.raises(ValueError):
        port._check_cuda_args(**kw)


def _pages(counts, dtype):
    pages = torch.from_numpy(cast_dense_adj(counts, dtype))
    return pages.view(torch.bfloat16) if dtype == "bfloat16" else pages


def test_plain_page_dtypes_give_one_result(setup):
    """uint8, bf16 and float32 pages of the same counts: the same loss and
    gradients, bit for bit (a cell is read as float)."""
    data, da, _, q, args = setup
    out = []
    for dtype in ("uint8", "bfloat16", "float32"):
        ts = [torch.from_numpy(a) for a in args]
        out.append(port.dense_bce_nn_plain(*ts, _pages(da, dtype),
                                           torch.from_numpy(q), 5, grads=True))
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))


@pytest.mark.parametrize("mode", ["positives_only", "saturated"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_float_pages_deterministic_modes_vs_oracle(setup, dtype, mode):
    """The deterministic threshold modes on the bf16 and float32 pages, the
    float32 ones with a count past uint8's range (300 copies of one pair),
    against the float64 oracle."""
    data, da, _, _, args = setup
    da = da.astype(np.int64)
    if dtype == "float32":
        da[0, 3, 5] += 300
    q = np.full((data.n_et, 3), 0 if mode == "positives_only" else 1 << 24,
                np.int32)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    loss = port.dense_bce_nn_sum(*ts, _pages(da, dtype), torch.from_numpy(q),
                                 7)
    loss.backward()
    dan = da.astype(np.float64)
    cnt = 0.0 if mode == "positives_only" else 3.0 * (dan == 0)
    oval, ograds = _oracle(args, dan, cnt)
    assert abs(loss.item() - oval) / abs(oval) < 1e-5
    for t, want in zip(ts, ograds):
        np.testing.assert_allclose(t.grad.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())


def test_plain_u24_zero_on_float32_pages_past_255_matches_jax(setup):
    """A count past 255 rides the float32 pages, which the JAX kernel
    reads as they are: u24 = 0 as in the uint8 test above."""
    data, da, _, _, args = setup
    da = da.astype(np.float32)
    da[2, 7, 9] += 300.0
    q = np.zeros((data.n_et, 3), np.int32)
    q[::2, :2] = 7
    built = dict(_BUILT, da=digest(da), pages=digest(da))
    port_out, jax_out, before, first_call = _port_then_jax(
        args, da, q, jnp.asarray(pad_dense_adj(da)))
    _check_u24_zero(port_out, jax_out, args, da, da, q, built, before,
                    first_call)
