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

import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import build_trigraph, synthetic_trigraph
from tip_tpu.data.packing import dense_relation_adj
from tip_tpu.ops.pallas_dense_bce import dense_bce_sum
from tests.torch_tile_math import (
    PLAIN_ULPS, assert_readings, diagnosis, digest, digests, mma,
    op_divergence, recorded, softplus_sigmoid, split, tf32,
)
from tip_tpu_torch import kernels
from tip_tpu_torch.data.packing import poisson_neg_thresholds
from tip_tpu_torch.ops import dense_bce as port
from tip_tpu_torch.train.model import pages_tensor

DTYPES = ["float32", "bfloat16"]
_BUILT = {}  # digests of the fixture's inputs, taken when it built them


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
    _BUILT.update(digests(da=da, w=w, z=z))
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
    """The port's plain version and the JAX kernel (interpret mode) under
    u24 = 0, each against the float64 oracle and against each other,
    within a few float32 roundings of the sum of each result's absolute
    terms (tests/torch_tile_math.py: PLAIN_ULPS for the plain version,
    JAX_ULPS where the JAX kernel takes part), on both page dtypes.

    The port runs first, recorded op by op (``torch_tile_math.recorded``),
    and its inputs and outputs must come through the JAX call unchanged; a
    failing port reading recomputes the port from fresh copies of the
    inputs, checks the inputs against their digests from the fixture,
    names the cell with the largest error and the first op where the
    recomputation parts from the first call (``torch_tile_math.diagnosis``)."""
    data, da, _, w, z = setup
    q = np.zeros((data.n_et, 3), np.int32)
    for t, c in enumerate([0, 1, 2, 3, 1, 2]):  # count #{k: q_k > 0}
        q[t, :c] = 7
    pages = pages_tensor(da, dtype)
    built = dict(_BUILT, pages=digest(pages))
    port_out, first_call = recorded(lambda: _torch_value_and_grads(
        w, z, pages, q, seed=3, u24=torch.zeros((), dtype=torch.int64)))
    port_digests = digests(value=np.float64(port_out[0]), dw=port_out[1],
                           dz=port_out[2])
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
    jax_out = (float(jval), np.asarray(jdw), np.asarray(jdz))
    dan = da.astype(np.float64)
    cnt = (q > 0).sum(1)[:, None, None] * (dan == 0)
    oracle, sabs = _oracle(w, z, dan, cnt, abs_sums=True)
    after = digests(value=np.float64(port_out[0]), dw=port_out[1],
                    dz=port_out[2])
    moved = [k for k in after if after[k] != port_digests[k]]

    def cells():
        zt, wt = torch.tensor(z), torch.tensor(w)
        lg = (zt[None] * wt[:, None, :]) @ zt.T
        sp = port.softplus(-lg)
        dat = pages_tensor(da.copy(), dtype).float()
        ct = torch.from_numpy(cnt.astype(np.float32))
        t32 = (sp * dat + (sp + lg) * ct).numpy()
        L = np.einsum("nf,tf,mf->tnm", *(x.astype(np.float64)
                                         for x in (z, w, z)))
        sp64 = np.logaddexp(0.0, -L)
        return t32, sp64 * dan + (sp64 + L) * cnt, dict(
            logit32=lg.numpy(), logit64=L, count=cnt, page=dan)

    names = ("value", "dw", "dz")
    assert_readings(
        names, port_out, jax_out, oracle, sabs, PLAIN_ULPS,
        lambda: diagnosis(
            lambda: _torch_value_and_grads(
                w.copy(), z.copy(), pages_tensor(da.copy(), dtype), q.copy(),
                seed=3, u24=torch.zeros((), dtype=torch.int64)),
            names, oracle, sabs, PLAIN_ULPS,
            dict(built, **{f"port {k} (before the JAX call)": v
                           for k, v in port_digests.items()}),
            dict(da=da, w=w, z=z, pages=pages,
                 **{f"port {k} (before the JAX call)": a for k, a in
                    zip(names, (np.float64(port_out[0]), *port_out[1:]))}),
            cells, first_call))
    assert not moved, f"the JAX call changed the port's outputs {moved}"


def test_diagnosis_names_a_tensor_written_between_ops():
    """The u24 = 0 tests' first-call record (torch_tile_math.recorded)
    names a tensor whose bytes change between two ops from outside the
    call, as a stray write into reused memory would: the first op whose
    outputs differ from a clean recomputation's, as the call left them,
    and the op that reads it."""
    x = torch.arange(8, dtype=torch.float32)

    def call(stray: bool):
        sp = torch.exp(-x)
        if stray:  # bytes written from outside, without an ATen op
            ctypes.c_float.from_address(sp.data_ptr() + 12).value += 0.5
        return torch.sum(sp * 2.0).item()

    value, first = recorded(lambda: call(True))
    again_value, again = recorded(lambda: call(False))
    assert value != again_value
    text = op_divergence(first, again)
    assert "op 1 aten.exp.default: outputs differ" in text
    assert "(op 0)" in text  # it read aten.neg's output
    assert first["ops"][2][1][0] == first["ops"][1][2][0][0]  # mul reads it
    assert first["threads"][0] == "MainThread" and first["native_threads"] > 0
    assert "left equal bytes" in op_divergence(
        again, recorded(lambda: call(False))[1])


def _oracle(w, z, da, cnt, abs_sums: bool = False):
    """float64 value and grads of the estimator for a fixed count field;
    with ``abs_sums`` also the sums of the absolute values of the terms of
    each."""
    wn, zn = np.asarray(w, np.float64), np.asarray(z, np.float64)
    L = np.einsum("nf,tf,mf->tnm", zn, wn, zn)
    sp = np.logaddexp(0.0, -L)
    val = (sp * da + (sp + L) * cnt).sum()
    g = cnt - (da + cnt) / (1.0 + np.exp(L))
    dw = np.einsum("tnm,nf,mf->tf", g, zn, zn)
    dz = (np.einsum("tf,tnm,mf->nf", wn, g, zn)
          + np.einsum("tf,tnm,nf->mf", wn, g, zn))
    if not abs_sums:
        return val, dw, dz
    ga, za, wa = np.abs(g), np.abs(zn), np.abs(wn)
    sval = (np.abs(sp * da) + np.abs((sp + L) * cnt)).sum()
    sdw = np.einsum("tnm,nf,mf->tf", ga, za, za)
    sdz = (np.einsum("tf,tnm,mf->nf", wa, ga, za)
           + np.einsum("tf,tnm,nf->mf", wa, ga, za))
    return (val, dw, dz), (sval, sdw, sdz)


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
                                 "shape", "square", "q", "aligned"])
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
    elif bad == "aligned":  # the kernel stages page rows by 16-byte chunks
        flat = torch.empty(da.size + 1, dtype=torch.float32)[1:]
        kw["pages"] = flat.view(da.shape).copy_(kw["pages"])
    else:
        kw["q"] = kw["q"][:, :2].contiguous()
    with pytest.raises(ValueError):
        port._check_cuda_args(**kw)


@pytest.mark.parametrize("d", [8, 16, 32])
def test_3xtf32_contractions_of_a_full_page_tile_hold_the_kernel_tolerances(d):
    """CPU evidence for the tensor-core design of csrc/dense_bce.cu: a full,
    non-symmetric 128 x 128 tile (z_I and z_J distinct rows) with float32
    page counts past 256, at the magnitudes chip_smoke.py checks B2 with
    (z ~ 0.5 N(0, 1), w ~ 0.3 N(0, 1)).  The logits (z_I w_t) z_J^T and
    the gradient contractions G z_J and G^T z_I as 3xTF32 products stay
    ~100 times inside the tolerances the kernel is held to on the card
    (loss 1e-5 relative, dw and dz 1e-3 of their max) against float64;
    one TF32 product keeps only ~3 digits of each contraction."""
    rng = np.random.default_rng(100 + d)
    zi = (0.5 * rng.standard_normal((128, d))).astype(np.float32)
    zj = (0.5 * rng.standard_normal((128, d))).astype(np.float32)
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    da = rng.poisson(0.05, (128, 128)).astype(np.float64)
    hot = rng.random((128, 128)) < 0.01  # counts past bf16's exact range
    da[hot] = rng.integers(257, 2000, int(hot.sum()))
    cnt = np.where(da > 0, 0.0, rng.integers(0, 4, (128, 128)))
    a = zi * w
    l64 = a.astype(np.float64) @ zj.T.astype(np.float64)

    def loss_and_g(logits):
        sp = np.logaddexp(0.0, -logits)
        g = cnt - (da + cnt) / (1.0 + np.exp(logits))
        return (sp * da + (sp + logits) * cnt).sum(), g

    loss64, g64 = loss_and_g(l64)
    g = g64.astype(np.float32)
    hi64 = g64 @ zj.astype(np.float64)
    hj64 = g64.T @ zi.astype(np.float64)
    errs = {}
    for passes in (3, 1):
        logits = mma(a, np.ascontiguousarray(zj.T), passes)
        loss, _ = loss_and_g(logits.astype(np.float64))
        errs[passes] = (
            np.abs(logits - l64).max() / np.abs(l64).max(),
            abs(loss - loss64) / abs(loss64),
            np.abs(mma(g, zj, passes) - hi64).max() / np.abs(hi64).max(),
            np.abs(mma(np.ascontiguousarray(g.T), zi, passes) - hj64).max()
            / np.abs(hj64).max())
    logit3, loss3, gzj3, gtzi3 = errs[3]
    assert logit3 < 1e-6 and loss3 < 1e-7
    assert gzj3 < 1e-5 and gtzi3 < 1e-5
    # one TF32 product: errors of a few 1e-4 of the largest magnitude
    assert min(errs[1][0], errs[1][2], errs[1][3]) > 100 * max(logit3, gzj3, gtzi3)


@pytest.mark.parametrize("signs", [(0, 0, 0), (1, 1, 1), (-1, -1, -1),
                                   (1, -1, 1), (-1, 1, -1)])
def test_one_exponential_cell_holds_the_kernel_tolerances(signs):
    """The cell of B1, B2 and B3 (tile_math.cuh: softplus_neg, sigmoid_neg)
    computes softplus(-x) and sigmoid(-x) from one exponential with the
    card's approximate ex2 and lg2 and __fdividef.  Emulated in float32,
    each approximation moved by ``signs`` times its worst-case error, over
    logits in [-40, 40] (the checks' logits stay within +-15) against
    float64: softplus within 5e-7 + 2^-23 |x| and sigmoid within 5e-7 a
    cell, and on a page of counts (past 256 too) the loss within 1e-6
    relative and G within 1e-6 of its largest magnitude, against the 1e-5
    and 1e-3 the kernels are held to on the card."""
    rng = np.random.default_rng(7)
    x = np.concatenate([np.linspace(-40.0, 40.0, 40001),
                        3.0 * rng.standard_normal(40000)]).astype(np.float32)
    sp, sg = softplus_sigmoid(x, *signs)
    x64 = x.astype(np.float64)
    sp64 = np.logaddexp(0.0, -x64)
    sg64 = 1.0 / (1.0 + np.exp(x64))
    assert np.all(np.abs(sp - sp64) <= 5e-7 + 2.0**-23 * np.abs(x64))
    assert np.all(np.abs(sg - sg64) <= 5e-7)
    da = rng.poisson(0.05, x.shape).astype(np.float64)
    da[rng.random(x.shape) < 1e-3] = 300.0
    cnt = np.where(da > 0, 0.0, rng.integers(0, 4, x.shape))
    # the kernels' per-cell float32 terms, summed exactly
    f = np.float32
    terms = (sp * f(1) * da.astype(f) + (sp + x) * cnt.astype(f)).astype(f)
    loss64 = (sp64 * da + (sp64 + x64) * cnt).sum()
    assert abs(terms.astype(np.float64).sum() - loss64) < 1e-6 * loss64
    g = (cnt.astype(f) - sg * (da.astype(f) + cnt.astype(f))).astype(f)
    g64 = cnt - sg64 * (da + cnt)
    assert np.abs(g - g64).max() < 1e-6 * np.abs(g64).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_nan_in_z_reaches_the_loss(setup, dtype):
    """A NaN in one element of z makes the plain version's loss NaN, as in
    the JAX package; chip_smoke.py holds the kernel to the same (the
    training loop stops on a non-finite loss)."""
    _, da, q, w, z = setup
    z = z.copy()
    z[75, 3] = np.nan
    loss, _, _ = _torch_value_and_grads(w, z, pages_tensor(da, dtype, "cpu"),
                                        q, seed=5)
    assert np.isnan(loss)


# NaN bit patterns: the one float32 arithmetic produces on x86 (0xffc00000)
# and on the card (0x7fffffff), and others with high or low mantissa bits
NAN_BITS = [0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000, 0x7F800001]


@pytest.mark.parametrize("part", ["tf32", "mma", "cell"])
def test_a_nan_operand_stays_nan_in_the_kernel_arithmetic(part):
    """The arithmetic of B1 and B2 (tile_math.cuh, emulated) carries a NaN
    operand to the loss: tf32 and split keep every NaN a NaN (and an
    infinity infinite), a NaN in one element of a 3xTF32 product's operand
    makes that row of the product NaN and leaves the rest finite, and the
    one-exponential cell gives NaN softplus, sigmoid and loss terms, also
    where the cell's weights are 0."""
    if part == "tf32":
        x = np.array(NAN_BITS, np.uint32).view(np.float32)
        with np.errstate(invalid="ignore"):
            hi, _ = split(x)
        assert np.isnan(tf32(x)).all() and np.isnan(hi).all()
        assert np.isinf(tf32(np.float32([np.inf, -np.inf]))).all()
    elif part == "mma":
        rng = np.random.default_rng(1)
        a = rng.standard_normal((16, 16)).astype(np.float32)
        b = rng.standard_normal((16, 8)).astype(np.float32)
        a[5, 9] = np.uint32(0x7FFFFFFF).view(np.float32)
        out = mma(a, b, 3)
        assert np.isnan(out[5]).all()
        assert np.isfinite(np.delete(out, 5, axis=0)).all()
    else:
        sp, sg = softplus_sigmoid(np.float32([np.nan]))
        assert np.isnan(sp).all() and np.isnan(sg).all()
        for pos, cnt in ((0.0, 0.0), (1.0, 0.0), (0.0, 3.0)):
            assert np.isnan(sp * pos + (sp + np.float32(np.nan)) * cnt).all()
