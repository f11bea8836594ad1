"""Port of the symmetric fused dense BCE (tip_tpu_torch/ops/dense_bce_sym.py)
against the JAX package.

The CPU runs the plain PyTorch version; the CUDA kernel is held against
the same plain version on the card by chip_smoke.py.  As in
tests/test_dense_bce_sym.py, the JAX kernel in interpret mode draws
u24 = 0, so the plain version fed an explicit zero field must match it
value for value and gradient for gradient.  The hashed field is checked in
the two deterministic threshold modes against a float64 oracle, and
statistically against the estimator's analytic expectation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import build_trigraph, synthetic_trigraph
from tip_tpu.data.packing import (
    dense_relation_adj,
    poisson_neg_thresholds_sym,
    sym_strip_pack,
)
from tip_tpu.ops.pallas_dense_bce_sym import dense_bce_sym_sum
from tests.torch_tile_math import (
    PLAIN_ULPS, assert_readings, diagnosis, digests, mkl_vml_ops, mma,
    recorded, split,
)
from tip_tpu_torch import kernels
from tip_tpu_torch.ops import dense_bce_sym as port

_BUILT = {}  # digests of the fixture's inputs, taken when it built them


@pytest.fixture(scope="module")
def setup():
    # n_drug > 128: off-diagonal strips and a ragged edge
    raw = synthetic_trigraph(n_drug=150, n_prot=16, n_et=5, pairs_per_et=120,
                             seed=3)
    data = build_trigraph(raw, split_rate=0.9, seed=3)
    da = dense_relation_adj(data.dd_train, data.n_drug)
    pages = sym_strip_pack(da)
    q8 = poisson_neg_thresholds_sym(data.dd_train, data.n_drug)
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((data.n_et, 8)) * 0.3).astype(np.float32)
    z = (rng.standard_normal((data.n_drug, 8)) * 0.5).astype(np.float32)
    _BUILT.update(digests(da=da, w=w, z=z, pages=pages))
    return data, da, pages, q8, w, z


def _torch_value_and_grads(w, z, pages, q8, seed, u24=None):
    wt = torch.tensor(w, requires_grad=True)
    zt = torch.tensor(z, requires_grad=True)
    loss = port.dense_bce_sym_sum(wt, zt, torch.from_numpy(pages),
                                  torch.from_numpy(q8), seed, u24=u24)
    loss.backward()
    return loss.item(), wt.grad.numpy(), zt.grad.numpy()


def _oracle_u24_zero(w, z, da, q8):
    """float64 value, dw and dz of the symmetric estimator under u24 = 0
    on the full matrix, the sums of the absolute values of the terms of
    each, and the count field: a cell counts #{k : q_k > 0} of its rate class, the
    diagonal 128-blocks' single rate for themselves, the doubled rate of a
    mirrored pair split evenly between its two cells."""
    wn, zn, dan = (np.asarray(x, np.float64) for x in (w, z, da))
    ii = np.arange(zn.shape[0])
    same_block = (ii[:, None] // 128) == (ii[None, :] // 128)
    cs = (q8[:, :4] > 0).sum(1)[:, None, None]
    cd = (q8[:, 4:] > 0).sum(1)[:, None, None]
    cnt = np.where(same_block, cs, cd / 2.0) * (dan == 0)
    L = np.einsum("nf,tf,mf->tnm", zn, wn, zn)
    sp = np.logaddexp(0.0, -L)
    val = (sp * dan + (sp + L) * cnt).sum()
    sval = (np.abs(sp * dan) + np.abs((sp + L) * cnt)).sum()
    g = cnt - (dan + cnt) / (1.0 + np.exp(L))
    dw = np.einsum("tnm,nf,mf->tf", g, zn, zn)
    sdw = np.einsum("tnm,nf,mf->tf", np.abs(g), np.abs(zn), np.abs(zn))
    dz = (np.einsum("tf,tnm,mf->nf", wn, g, zn)
          + np.einsum("tf,tnm,nf->mf", wn, g, zn))
    sdz = (np.einsum("tf,tnm,mf->nf", np.abs(wn), np.abs(g), np.abs(zn))
           + np.einsum("tf,tnm,nf->mf", np.abs(wn), np.abs(g), np.abs(zn)))
    return (val, dw, dz), (sval, sdw, sdz), cnt


def test_plain_u24_zero_matches_jax_interpret_kernel(setup):
    """The port's plain version and the JAX kernel (interpret mode) under
    u24 = 0, each against the float64 oracle and against each other,
    within a few float32 roundings of the sum of each result's absolute
    terms (tests/torch_tile_math.py: PLAIN_ULPS for the plain version,
    JAX_ULPS where the JAX kernel takes part): the error of an f32 sum is
    bounded relative to that sum, and dw's and dz's elements cancel.

    The port runs first, recorded op by op (``torch_tile_math.recorded``),
    and its inputs and outputs must come through the JAX call unchanged; a
    failing port reading recomputes the port from fresh copies of the
    inputs, checks the inputs against their digests from the fixture,
    names the cell with the largest error and the first op where the
    recomputation parts from the first call (``torch_tile_math.diagnosis``)."""
    data, da, pages, _, w, z = setup
    # per-rate-class counts #{k: q_k > 0}, varied over relations
    q8 = np.zeros((data.n_et, 8), np.int32)
    for t, (cs, cd) in enumerate(zip([0, 1, 2, 3, 1], [1, 2, 0, 4, 3])):
        q8[t, :cs] = 7
        q8[t, 4:4 + cd] = 7
    port_out, first_call = recorded(lambda: _torch_value_and_grads(
        w, z, pages, q8, seed=5, u24=torch.zeros((), dtype=torch.int64)))
    port_digests = digests(value=np.float64(port_out[0]), dw=port_out[1],
                           dz=port_out[2])
    # TPU interpret mode keeps one process-wide simulated memory: start
    # from a fresh one, whatever an earlier test in this process left
    # behind, and run the fused kernel as one jitted program to its end
    pltpu.reset_tpu_interpret_mode_state()

    @jax.jit
    def value_and_grad(w, z):
        return jax.value_and_grad(
            lambda wz: dense_bce_sym_sum(wz[0], wz[1], jnp.asarray(pages),
                                         jnp.asarray(q8), jax.random.key(5)),
        )((w, z))

    with pltpu.force_tpu_interpret_mode():
        jval, (jdw, jdz) = jax.block_until_ready(
            value_and_grad(jnp.asarray(w), jnp.asarray(z)))
    jax_out = (float(jval), np.asarray(jdw), np.asarray(jdz))
    oracle, sabs, cnt = _oracle_u24_zero(w, z, da, q8)
    after = digests(value=np.float64(port_out[0]), dw=port_out[1],
                    dz=port_out[2])
    moved = [k for k in after if after[k] != port_digests[k]]

    def cells():
        # the symmetric kernel sums stored strip cells; per cell of the
        # full matrix, the same terms (a mirrored pair's count split)
        zt, wt = torch.tensor(z), torch.tensor(w)
        lg = (zt[None] * wt[:, None, :]) @ zt.T
        sp = port.softplus(-lg)
        dat = torch.from_numpy(da.astype(np.float32))
        ct = torch.from_numpy(cnt.astype(np.float32))
        t32 = (sp * dat + (sp + lg) * ct).numpy()
        L = np.einsum("nf,tf,mf->tnm", *(x.astype(np.float64)
                                         for x in (z, w, z)))
        sp64 = np.logaddexp(0.0, -L)
        dan = da.astype(np.float64)
        return t32, sp64 * dan + (sp64 + L) * cnt, dict(
            logit32=lg.numpy(), logit64=L, count=cnt, page=dan)

    names = ("value", "dw", "dz")
    assert_readings(
        names, port_out, jax_out, oracle, sabs, PLAIN_ULPS,
        lambda: diagnosis(
            lambda: _fresh_call(w, z, pages, q8),
            names, oracle, sabs, PLAIN_ULPS,
            dict(_BUILT, **{f"port {k} (before the JAX call)": v
                            for k, v in port_digests.items()}),
            dict(da=da, w=w, z=z, pages=pages,
                 **{f"port {k} (before the JAX call)": a for k, a in
                    zip(names, (np.float64(port_out[0]), *port_out[1:]))}),
            cells, first_call))
    assert not moved, f"the JAX call changed the port's outputs {moved}"


def _fresh_call(w, z, pages, q8):
    """Fresh copies of the u24 = 0 test's inputs, built here, and the
    port's call on them, made as the first call was (only the call is
    recorded, so the two op streams start alike)."""
    w, z, pages, q8 = w.copy(), z.copy(), pages.copy(), q8.copy()
    return lambda: _torch_value_and_grads(
        w, z, pages, q8, seed=5, u24=torch.zeros((), dtype=torch.int64))


@pytest.mark.parametrize("u24", ["zero", "hashed"])
def test_plain_version_calls_no_mkl_vml_function(setup, u24):
    """The plain version's value and gradients call no function that torch
    runs through MKL's VML on the CPU (torch_tile_math.MKL_VML_OPS): the
    first parallel exp of a process there can return one thread's share
    at about half of float32's precision (ROADMAP Queue C; B1's dw drifted
    so).  sigmoid(-L) = 1 - exp(-softplus(-L)) is taken by expm1."""
    _, _, pages, q8, w, z = setup
    field = torch.zeros((), dtype=torch.int64) if u24 == "zero" else None
    _, record = recorded(lambda: _torch_value_and_grads(w, z, pages, q8, 5,
                                                        u24=field))
    assert mkl_vml_ops(record) == []
    assert any(f.startswith("aten.expm1") for f, _, _ in record["ops"])


@pytest.mark.parametrize("mode", ["positives_only", "saturated"])
def test_plain_hashed_field_deterministic_modes_vs_oracle(setup, mode):
    """q = 0 (no negatives) and q = 2^24 (count 4 on every valid
    non-positive stored cell) make the hashed field irrelevant: the plain
    version must equal the float64 full-matrix oracle of
    tests/test_tpu_kernels.py."""
    data, da, pages, _, w, z = setup
    q8 = np.full((data.n_et, 8), 0 if mode == "positives_only" else 1 << 24,
                 np.int32)
    val, dw, dz = _torch_value_and_grads(w, z, pages, q8, seed=7)
    wn, zn, dan = (np.asarray(x, np.float64) for x in (w, z, da))
    L = np.einsum("nf,tf,mf->tnm", zn, wn, zn)
    sp = np.logaddexp(0.0, -L)
    if mode == "positives_only":
        cnt = 0.0
    else:
        ii = np.arange(data.n_drug)
        same_block = (ii[:, None] // 128) == (ii[None, :] // 128)
        cnt = np.where(same_block, 4.0, 2.0) * (dan == 0)
    oval = (sp * dan + (sp + L) * cnt).sum()
    g = cnt - (dan + cnt) / (1.0 + np.exp(L))
    odw = np.einsum("tnm,nf,mf->tf", g, zn, zn)
    odz = (np.einsum("tf,tnm,mf->nf", wn, g, zn)
           + np.einsum("tf,tnm,nf->mf", wn, g, zn))
    assert abs(val - oval) / abs(oval) < 1e-4
    np.testing.assert_allclose(dw, odw, atol=2e-2 * np.abs(odw).max())
    np.testing.assert_allclose(dz, odz, atol=2e-2 * np.abs(odz).max())


def test_plain_hashed_field_mean_matches_expectation(setup):
    """E[loss] over seeds equals the analytic expectation: the pair-rate
    construction preserves every per-pair count marginal (the check of
    tests/test_dense_bce_sym.py on the JAX fallback)."""
    data, da, pages, q8, w, z = setup
    m = np.bincount(data.dd_train.edge_type, minlength=data.n_et)
    logits = np.einsum("nf,tf,mf->tnm", z, w, z)
    sp = np.logaddexp(0.0, -logits)
    nonpos = da == 0
    mu = m / nonpos.reshape(data.n_et, -1).sum(1)
    expect = float((sp * da).sum() + sum(
        mu[t] * ((sp[t] + logits[t]) * nonpos[t]).sum()
        for t in range(data.n_et)))
    args = [torch.from_numpy(x) for x in (w, z, pages, q8)]
    vals = np.array([float(port.dense_bce_sym_sum(*args, seed=s))
                     for s in range(60)])
    se = vals.std(ddof=1) / np.sqrt(len(vals))
    assert abs(vals.mean() - expect) < max(5 * se, 2e-3 * abs(expect)), (
        vals.mean(), expect, se)


def test_u24_field_is_uniform_and_keyed():
    npad = 256
    idx = torch.arange(npad)
    u = port.u24_field(123, torch.arange(4), idx, idx, npad)
    assert u.shape == (4, npad, npad)
    assert int(u.min()) >= 0 and int(u.max()) < (1 << 24)
    # 16 equal bins over 262k draws: chi-square with 15 dof
    counts = torch.bincount((u >> 20).flatten(), minlength=16).double()
    exp = u.numel() / 16
    assert float(((counts - exp) ** 2 / exp).sum()) < 50.0
    # relations and seeds draw different fields
    assert not torch.equal(u[0], u[1])
    v = port.u24_field(124, torch.arange(4), idx, idx, npad)
    assert float((u == v).double().mean()) < 1e-3


def test_mix32_matches_uint32_arithmetic():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    ref = x.copy()
    ref ^= ref >> np.uint32(16)
    ref *= np.uint32(0x7FEB352D)
    ref ^= ref >> np.uint32(15)
    ref *= np.uint32(0x846CA68B)
    ref ^= ref >> np.uint32(16)
    got = port.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_a_nan_in_z_reaches_the_loss(setup):
    """A NaN in one element of z makes the plain version's loss NaN, as in
    the JAX package; chip_smoke.py holds the kernel to the same (the
    training loop stops on a non-finite loss)."""
    _, _, pages, q8, w, z = setup
    z = z.copy()
    z[75, 3] = np.nan
    loss, _, _ = _torch_value_and_grads(w, z, pages, q8, seed=5)
    assert np.isnan(loss)


def test_value_only_equals_fused_and_cpu_wrapper_launches_nothing(setup):
    _, _, pages, q8, w, z = setup
    kernels.reset_launch_counts()
    args = [torch.from_numpy(x) for x in (w, z, pages, q8)]
    value = port.dense_bce_sym_sum(*args, seed=11)
    fused, _, _ = port.dense_bce_sym_plain(*args, seed=11, grads=True)
    assert float(value) == float(fused)
    # CPU tensors take the plain version: the kernel count stays at 0
    assert kernels.LAUNCHES[port.KERNEL] == 0


def test_cuda_wrapper_rejects_cpu_tensors(setup):
    _, _, pages, q8, w, z = setup
    with pytest.raises(ValueError, match="CUDA"):
        port.dense_bce_sym_cuda(*[torch.from_numpy(x)
                                  for x in (w, z, pages, q8)], seed=0)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "width", "shape",
                                 "rows", "aligned"])
def test_cuda_argument_checks(setup, bad):
    """The checks the CUDA wrapper runs before it hands pointers to the
    kernel (they need no card)."""
    _, _, pages, q8, w, z = setup
    args = dict(w=torch.from_numpy(w), z=torch.from_numpy(z),
                pages=torch.from_numpy(pages), q8=torch.from_numpy(q8))
    port._check_cuda_args(**args)  # the valid call passes
    if bad == "dtype":
        args["q8"] = args["q8"].long()
    elif bad == "contiguous":
        args["z"] = torch.from_numpy(np.asfortranarray(z))
    elif bad == "width":
        args["w"], args["z"] = args["w"][:, :6].contiguous(), args["z"][:, :6].contiguous()
    elif bad == "shape":
        args["w"] = args["w"][:-1].contiguous()
    elif bad == "aligned":  # the kernel copies page tiles 16 bytes at a time
        flat = torch.empty(pages.size + 1, dtype=torch.int8)[1:]
        args["pages"] = flat.view(pages.shape).copy_(args["pages"])
    else:  # n outside the strips' row range
        args["z"] = args["z"][:100].contiguous()
    with pytest.raises(ValueError):
        port._check_cuda_args(**args)


@pytest.mark.parametrize("d", [8, 16, 32])
def test_3xtf32_contractions_hold_the_kernel_tolerances(d):
    """CPU evidence for the tensor-core design of csrc/dense_bce_sym.cu: a
    128 x 128 tile's logits (z_I w_t) z_J^T and its gradient contractions
    G z_J and G^T z_I, at the magnitudes chip_smoke.py checks B1 with
    (z ~ 0.5 N(0, 1), w ~ 0.3 N(0, 1)), computed as 3xTF32 products stay
    ~100 times inside the tolerances the kernel is held to on the card
    (loss 1e-5 relative, dw and dz 1e-3 of their max) against float64;
    one TF32 product keeps only ~3 digits of each contraction."""
    rng = np.random.default_rng(d)
    zi = (0.5 * rng.standard_normal((128, d))).astype(np.float32)
    zj = (0.5 * rng.standard_normal((128, d))).astype(np.float32)
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    hi, lo = split(zi)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert np.abs(zi - (hi.astype(np.float64) + lo)).max() <= 2.0**-21 * np.abs(zi).max()

    a = zi * w
    l64 = a.astype(np.float64) @ zj.T.astype(np.float64)
    da = (rng.random((128, 128)) < 0.02).astype(np.float64)
    cnt = np.where(da > 0, 0.0, rng.poisson(0.05, (128, 128)))

    def loss_and_g(logits):
        sp = np.maximum(-logits, 0) + np.log1p(np.exp(-np.abs(logits)))
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
