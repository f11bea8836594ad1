"""Kernel B2 of the port (tip_tpu_torch/ops/dense_bce.py, the fused dense
BCE over the full float32 or bf16 pages) against the JAX package on the CPU.

The CPU runs the plain PyTorch version; chip_smoke.py holds the CUDA kernel
against it on the card.  The JAX kernel in interpret mode draws u24 = 0 (a
cell's count is #{k : q_k > 0}), so the plain version fed an explicit zero
field must match it value for value and gradient for gradient, on both page
dtypes.  The hashed field is checked in the two deterministic threshold
modes (q = 0 and q = 2^24) against a float64 oracle, and statistically
against the estimator's analytic expectation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import build_trigraph, synthetic_trigraph
from tip_tpu.data.packing import dense_relation_adj
from tip_tpu.ops.pallas_dense_bce import dense_bce_sum
from tip_tpu_torch import kernels
from tip_tpu_torch.data.packing import poisson_neg_thresholds
from tip_tpu_torch.ops import dense_bce as port
from tip_tpu_torch.train.model import pages_tensor

DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def setup():
    # n_drug > 128: the kernel's tiles are ragged at the plane's edge
    raw = synthetic_trigraph(n_drug=150, n_prot=16, n_et=6, pairs_per_et=120,
                             seed=3)
    data = build_trigraph(raw, split_rate=0.9, seed=3)
    da = dense_relation_adj(data.dd_train, data.n_drug)
    q = poisson_neg_thresholds(data.dd_train, data.n_drug)
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((data.n_et, 8)) * 0.3).astype(np.float32)
    z = (rng.standard_normal((data.n_drug, 8)) * 0.5).astype(np.float32)
    return data, da, q, w, z


def _torch_value_and_grads(w, z, pages, q, seed, u24=None):
    wt = torch.tensor(w, requires_grad=True)
    zt = torch.tensor(z, requires_grad=True)
    loss = port.dense_bce_sum(wt, zt, pages, torch.from_numpy(q), seed,
                              u24=u24)
    loss.backward()
    return loss.item(), wt.grad.numpy(), zt.grad.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_u24_zero_matches_jax_interpret_kernel(setup, dtype):
    data, da, _, w, z = setup
    q = np.zeros((data.n_et, 3), np.int32)
    for t, c in enumerate([0, 1, 2, 3, 1, 2]):  # count #{k: q_k > 0}
        q[t, :c] = 7
    jpages = jnp.asarray(da.astype(np.float32)).astype(jnp.dtype(dtype))
    # a fresh simulated memory for TPU interpret mode, whatever an earlier
    # test in this process left behind (tests/test_torch_dense_bce_sym.py)
    pltpu.reset_tpu_interpret_mode_state()

    # jit: the forward and backward kernels run as one program, in order
    @jax.jit
    def value_and_grad(w, z):
        return jax.value_and_grad(
            lambda wz: dense_bce_sum(wz[0], wz[1], jpages, jnp.asarray(q),
                                     jax.random.key(3)))((w, z))

    with pltpu.force_tpu_interpret_mode():
        jval, (jdw, jdz) = jax.block_until_ready(
            value_and_grad(jnp.asarray(w), jnp.asarray(z)))
    val, dw, dz = _torch_value_and_grads(
        w, z, pages_tensor(da, dtype), q, seed=3,
        u24=torch.zeros((), dtype=torch.int64))
    # f32 sums in another order: the repo's own kernel tolerances
    np.testing.assert_allclose(val, float(jval), rtol=1e-5)
    np.testing.assert_allclose(dw, np.asarray(jdw), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(dz, np.asarray(jdz), rtol=2e-4, atol=1e-5)


def _oracle(w, z, da, cnt):
    """float64 value and grads of the estimator for a fixed count field."""
    wn, zn = np.asarray(w, np.float64), np.asarray(z, np.float64)
    L = np.einsum("nf,tf,mf->tnm", zn, wn, zn)
    sp = np.logaddexp(0.0, -L)
    val = (sp * da + (sp + L) * cnt).sum()
    g = cnt - (da + cnt) / (1.0 + np.exp(L))
    dw = np.einsum("tnm,nf,mf->tf", g, zn, zn)
    dz = (np.einsum("tf,tnm,mf->nf", wn, g, zn)
          + np.einsum("tf,tnm,nf->mf", wn, g, zn))
    return val, dw, dz


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["positives_only", "saturated"])
def test_plain_hashed_field_deterministic_modes_vs_oracle(setup, mode, dtype):
    """q = 0 (no negatives) and q = 2^24 (count 3 on every non-positive
    cell, the diagonal's self-pairs included, as in the JAX package) make
    the hashed field irrelevant."""
    data, da, _, w, z = setup
    q = np.full((data.n_et, 3), 0 if mode == "positives_only" else 1 << 24,
                np.int32)
    val, dw, dz = _torch_value_and_grads(w, z, pages_tensor(da, dtype), q,
                                         seed=7)
    dan = da.astype(np.float64)
    cnt = 0.0 if mode == "positives_only" else 3.0 * (dan == 0)
    if mode == "saturated":
        assert (cnt[:, np.arange(data.n_drug), np.arange(data.n_drug)]
                == 3.0).any()
    oval, odw, odz = _oracle(w, z, dan, cnt)
    assert abs(val - oval) / abs(oval) < 1e-5
    np.testing.assert_allclose(dw, odw, atol=1e-4 * np.abs(odw).max())
    np.testing.assert_allclose(dz, odz, atol=1e-4 * np.abs(odz).max())


def test_plain_hashed_field_mean_matches_expectation(setup):
    """E[loss] over seeds equals the analytic expectation: each
    non-positive cell of relation t draws min(X, 3), X ~ Bin(m_t,
    1/nonpos_t), whose mean m_t / nonpos_t the truncation barely moves."""
    data, da, q, w, z = setup
    L = np.einsum("nf,tf,mf->tnm", z, w, z)
    sp = np.logaddexp(0.0, -L)
    nonpos = da == 0
    m = np.bincount(data.dd_train.edge_type, minlength=data.n_et)
    mu = m / nonpos.reshape(data.n_et, -1).sum(1)
    expect = float((sp * da).sum() + sum(
        mu[t] * ((sp[t] + L[t]) * nonpos[t]).sum() for t in range(data.n_et)))
    args = [torch.from_numpy(w), torch.from_numpy(z), pages_tensor(da, "float32"),
            torch.from_numpy(q)]
    vals = np.array([float(port.dense_bce_sum(*args, seed=s))
                     for s in range(40)])
    se = vals.std(ddof=1) / np.sqrt(len(vals))
    assert abs(vals.mean() - expect) < max(5 * se, 2e-3 * abs(expect)), (
        vals.mean(), expect, se)


def test_bf16_pages_give_the_float32_pages_result(setup):
    """The counts are exact in bf16, so both page dtypes give one result."""
    _, da, q, w, z = setup
    a = _torch_value_and_grads(w, z, pages_tensor(da, "float32"), q, seed=5)
    b = _torch_value_and_grads(w, z, pages_tensor(da, "bfloat16"), q, seed=5)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


def test_value_only_equals_fused_and_cpu_wrapper_launches_nothing(setup):
    _, da, q, w, z = setup
    kernels.reset_launch_counts()
    args = [torch.from_numpy(w), torch.from_numpy(z), pages_tensor(da, "float32"),
            torch.from_numpy(q)]
    value = port.dense_bce_sum(*args, seed=11)
    fused = port.dense_bce_plain(*args, seed=11, grads=True)[0]
    assert float(value) == float(fused)
    # CPU tensors take the plain version: the kernel count stays at 0
    assert kernels.LAUNCHES[port.KERNEL] == 0
    with pytest.raises(ValueError, match="CUDA"):
        port.dense_bce_cuda(*args, seed=0)


@pytest.mark.parametrize("bad", ["page_dtype", "dtype", "contiguous", "width",
                                 "shape", "square", "q"])
def test_cuda_argument_checks(setup, bad):
    """The checks the CUDA wrapper runs before it hands pointers to the
    kernel (they need no card)."""
    _, da, q, w, z = setup
    kw = dict(w=torch.from_numpy(w), z=torch.from_numpy(z),
              pages=pages_tensor(da, "bfloat16"), q=torch.from_numpy(q))
    port._check_cuda_args(**kw)  # the valid call passes, bf16 pages too
    kw["pages"] = pages_tensor(da, "float32")
    port._check_cuda_args(**kw)
    if bad == "page_dtype":  # float32 or bf16 pages only
        kw["pages"] = torch.from_numpy(da.astype(np.uint8))
    elif bad == "dtype":
        kw["q"] = kw["q"].long()
    elif bad == "contiguous":
        kw["z"] = torch.from_numpy(np.asfortranarray(z))
    elif bad == "width":  # the kernel is built for d in 8, 16, 32
        kw["w"], kw["z"] = kw["w"][:, :6].contiguous(), kw["z"][:, :6].contiguous()
    elif bad == "shape":
        kw["w"] = kw["w"][:-1].contiguous()
    elif bad == "square":
        kw["pages"] = kw["pages"][:, :-1].contiguous()
    else:
        kw["q"] = kw["q"][:, :2].contiguous()
    with pytest.raises(ValueError):
        port._check_cuda_args(**kw)
