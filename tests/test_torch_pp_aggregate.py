"""Kernel B12's module (tip_tpu_torch/ops/pp_aggregate.py) on the CPU: the
plain version against a float64 oracle, the exact three-way bf16 split of
the backward, the autograd.Function against the float32 product of the
upcast operands it replaced (bit for bit), the two dense GCN layers against
the JAX package's, the symmetry of (A+I) that the backward relies on, and
the wrapper's argument checks and column blocks, and the backend's route
through the dense encoders.  The CUDA kernel itself is held to the plain
version on the card, at Decagon shape by chip_smoke.py
(check_pp_aggregate) and at every width by the tests marked ``card``
(they skip themselves here): ``python -m pytest
tests/test_torch_pp_aggregate.py -m card --noconftest -q`` (the JAX
package is imported inside the tests that need it, so this module imports
without it)."""

import math

import numpy as np
import pytest
import torch

from tip_tpu_torch import convert
from tip_tpu_torch.data import build_trigraph
from tip_tpu_torch.data.packing import dense_pp_parts
from tip_tpu_torch.nn.encoders import pp_encoder_apply_dense
from tip_tpu_torch.ops import pp_aggregate as ppa
from tip_tpu_torch.ops.matmul import bf16_round, set_matmul_precision

N_RAGGED = 77  # not a multiple of 16 (nor of the kernel's 128-row tiles)


def sym_a1(n: int, seed: int, p: float = 0.1) -> torch.Tensor:
    """A random symmetric 0/1 int8 (A+I) [n, n]."""
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((n, n), generator=g) < p
    a = a | a.T | torch.eye(n, dtype=torch.bool)
    return a.to(torch.int8)


def parent_gcn_dense(params, x, a1, dinv):
    """The dense GCN layer as it was: the float32 upcast of (A+I) times the
    bf16-rounded operand, in one float32 matmul."""
    h = params["weight"] if x is None else x @ params["weight"]
    agg = bf16_round(a1) @ bf16_round(h * dinv[:, None])
    return agg * dinv[:, None] + params["bias"]


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_plain_within_float32_sum_bound(d, x_dtype):
    """|plain - oracle| <= k 2^-24 sum_k |a_ik| |x_kc| with k = N: every
    product is exact (int8 times a bf16 or float32 value) and only the N-term
    float32 sum rounds."""
    g = torch.Generator().manual_seed(d)
    a1 = torch.randint(-128, 128, (N_RAGGED, N_RAGGED), generator=g,
                       dtype=torch.int8)
    x = torch.randn(N_RAGGED, d, generator=g) * 3.0
    x = x.to(getattr(torch, x_dtype))
    got = ppa.pp_aggregate_plain(a1, x).double()
    want = a1.double() @ x.double()
    scale = a1.double().abs() @ x.double().abs()
    assert got.shape == (N_RAGGED, d)
    assert torch.all((got - want).abs() <= N_RAGGED * 2.0**-24 * scale)


def test_split3_is_exact():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(100_000, generator=g)
    x = torch.cat([x, x * 2.0**60, x * 2.0**-60, x * 2.0**-100,
                   torch.tensor([0.0, -0.0, 1.0, -3.5, 2.0**-110,
                                 -(2.0**-110) * 1.9999999])])
    x = x[(x.abs() >= 2.0**-110) | (x == 0)]  # the exact range
    hi, mid, lo = ppa.split3_plain(x)
    for t in (hi, mid, lo):  # each term a bf16 value
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # hi and mid are x's leading bits: |mid| <= 2^-7 |hi|, |lo| <= 2^-7 |mid|
    assert torch.all(mid.abs() <= hi.abs() * 2.0**-7)
    assert torch.all(lo.abs() <= mid.abs() * 2.0**-7)


def test_split3_underflow_case():
    """Below 2^-110 the bits of x under 2^-133 (bf16's least subnormal) do
    not fit lo: the documented loss, under 2^-133 absolute."""
    x = torch.tensor([2.0**-120 + 2.0**-140, -(2.0**-127 + 2.0**-145),
                      2.0**-149])
    hi, mid, lo = ppa.split3_plain(x)
    err = (hi.double() + mid.double() + lo.double() - x.double()).abs()
    assert torch.all(err > 0) and torch.all(err < 2.0**-133)


@pytest.mark.parametrize("d", [16, 32, 24])
def test_function_bit_equal_to_the_float32_upcast_product(d):
    """Forward and gradients (of the weight, the bias, dinv and the layer's
    input) of a dense GCN layer through pp_aggregate equal, bit for bit,
    those of the float32 product of the upcast operands it replaced; the
    CPU takes any width."""
    from tip_tpu_torch.nn.gcn import gcn_conv_apply_dense

    a1 = sym_a1(N_RAGGED, seed=d)
    dinv = 1.0 / torch.sqrt(a1.sum(1).float())
    g = torch.Generator().manual_seed(100 + d)
    x0 = torch.randn(N_RAGGED, 12, generator=g)
    w0 = torch.randn(12, d, generator=g) * 0.3
    b0 = torch.randn(d, generator=g)
    ct = torch.randn(N_RAGGED, d, generator=g)
    results = []
    for fn in (gcn_conv_apply_dense, parent_gcn_dense):
        x = x0.clone().requires_grad_(True)
        dv = dinv.clone().requires_grad_(True)
        params = {"weight": w0.clone().requires_grad_(True),
                  "bias": b0.clone().requires_grad_(True)}
        out = fn(params, x, a1, dv)
        (out * ct).sum().backward()
        results.append([out.detach(), x.grad, dv.grad, params["weight"].grad,
                        params["bias"].grad])
    for got, want in zip(*results):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_function_saves_only_the_matrix():
    a1 = sym_a1(N_RAGGED, seed=3)
    x = torch.randn(N_RAGGED, 16).to(torch.bfloat16).requires_grad_(True)
    out = ppa.pp_aggregate(a1, x)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == a1.data_ptr()
    out.sum().backward()
    assert x.grad.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def pp_graph():
    from tip_tpu.data import synthetic_trigraph

    raw = synthetic_trigraph(n_drug=30, n_prot=150, n_et=3, pairs_per_et=40,
                             seed=9)
    return raw, build_trigraph(raw, split_rate=0.9, seed=0)


def test_encoder_unchanged_against_jax(pp_graph):
    """The two dense GCN layers (identity features, widths 32 and 16)
    against the JAX package's on the same parameters: forward to float32
    summation order, gradients of <out, ct> to rtol 1e-4 plus one bf16 ulp
    of the largest magnitude (the layer-2 operand is rounded to bf16)."""
    import jax
    import jax.numpy as jnp

    from tip_tpu.data import build_trigraph as j_build
    from tip_tpu.data.packing import dense_pp_parts as j_dense_pp_parts
    from tip_tpu.nn import encoders as jenc

    raw, data = pp_graph
    a1, dinv = dense_pp_parts(data.pp_norm_index, data.n_prot)
    jdata = j_build(raw, split_rate=0.9, seed=0)
    ja1, jdinv = j_dense_pp_parts(jdata.pp_norm_index, jdata.n_prot)
    assert np.array_equal(a1, ja1) and np.array_equal(dinv, jdinv)
    params_np = jax.tree.map(np.asarray, jax.jit(
        jenc.pp_encoder_init, static_argnums=(1, 2, 3))(
            jax.random.key(4), data.n_prot, 32, 16))
    ct = np.random.default_rng(4).standard_normal(
        (data.n_prot, 16)).astype(np.float32)

    def jloss(p):
        out = jenc.pp_encoder_apply_dense(p, None, jnp.asarray(ja1),
                                          jnp.asarray(jdinv))
        return jnp.sum(out * ct), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params_np)
    params = convert.params_from_jax(params_np, requires_grad=True)
    out = pp_encoder_apply_dense(params, None, torch.from_numpy(a1),
                                 torch.from_numpy(dinv))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=2.0**-8 * np.abs(jout).max())
    for layer in ("conv1", "conv2"):
        for leaf in ("weight", "bias"):
            want = np.asarray(jgrad[layer][leaf])
            np.testing.assert_allclose(params[layer][leaf].grad.numpy(), want,
                                       rtol=1e-4,
                                       atol=2.0**-8 * np.abs(want).max())


def test_dense_pp_parts_is_symmetric(pp_graph):
    """(A+I) from the generator's graph is symmetric with a unit diagonal:
    the kernel's backward multiplies by (A+I) for (A+I)^T."""
    _, data = pp_graph
    a1, _ = dense_pp_parts(data.pp_norm_index, data.n_prot)
    assert a1.dtype == np.int8 and np.array_equal(a1, a1.T)
    assert np.all(np.diag(a1) == 1) and set(np.unique(a1)) <= {0, 1}


@pytest.mark.parametrize("case", ["non_square", "float_a1", "uint8_a1",
                                  "rows", "float_x", "width"])
def test_argument_checks_raise(case):
    a1 = sym_a1(48, seed=1)
    x = torch.randn(48, 16).to(torch.bfloat16)
    if case == "width":  # the kernel takes any width but none
        for d in (1, 6, 16, 24, 40):
            ppa.check_args(a1, torch.randn(48, d).to(torch.bfloat16),
                           kernel=True)
        with pytest.raises(ValueError, match="d >= 1"):
            ppa.check_args(a1, torch.randn(48, 0).to(torch.bfloat16),
                           kernel=True)
        return
    bad = {"non_square": (a1[:, :40], x), "float_a1": (a1.float(), x),
           "uint8_a1": (a1.to(torch.uint8), x), "rows": (a1, x[:40]),
           "float_x": (a1, x.float())}[case]
    with pytest.raises(ValueError):
        ppa.pp_aggregate(*bad)


def test_cuda_wrapper_refuses_cpu_tensors():
    a1 = sym_a1(48, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        ppa.pp_aggregate_cuda(a1, torch.randn(48, 16).to(torch.bfloat16))


@pytest.mark.parametrize("n,d,sms,want", [(19081, 32, 132, 7),
                                          (19081, 16, 132, 7),
                                          (300, 32, 132, 3),
                                          (77, 16, 132, 1)])
def test_k_splits(n, d, sms, want):
    """At Decagon shape 75 row blocks x 7 k ranges = 525 blocks, 3.98 an SM
    of 132; a small graph splits k as far as its tiles allow."""
    assert ppa.k_splits(n, d, sms) == want


@pytest.mark.parametrize("d", [1, 6, 8, 9, 16, 17, 24, 32, 33, 40, 64, 70])
def test_column_blocks_cover_every_width(d):
    """Blocks of at most 32 columns tile [0, d) in order, each padded to the
    least instantiated width that holds it."""
    blocks = ppa.column_blocks(d)
    assert [c0 for c0, _, _ in blocks] == list(range(0, d, 32))
    assert blocks[-1][1] == d
    for (c0, c1, w), nxt in zip(blocks, blocks[1:] + [(d, None, None)]):
        assert c1 == nxt[0] and 0 < c1 - c0 <= w and w in ppa.WIDTHS
        assert all(v < c1 - c0 for v in ppa.WIDTHS if v < w)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_dense_encoder_takes_the_backends_route(pp_graph, backend,
                                                monkeypatch):
    """``backend="xla"`` takes the float32 product of the upcast (A+I) and
    never reaches B12's module; 'pallas' goes through it; on the CPU both
    give the same bits.  PP-GAE's dense encode follows its model's
    backend."""
    from tip_tpu_torch.models import PPConfig, PPModel
    from tip_tpu_torch.models.pp import make_pp_graph_arrays
    from tip_tpu_torch.nn import gcn

    _, data = pp_graph
    graph, _ = make_pp_graph_arrays(data, "cpu")
    model = PPModel.for_data(PPConfig(hid1=8, hid2=6), data, "cpu",
                             backend=backend)
    assert model.layout == "dense" and model.backend == backend
    params = model.init(torch.Generator().manual_seed(2))
    want = pp_encoder_apply_dense(params["encoder"], None, graph["pp_a1"],
                                  graph["pp_dinv"])
    calls = []
    real = gcn.pp_aggregate
    monkeypatch.setattr(gcn, "pp_aggregate",
                        lambda *a: calls.append(1) or real(*a))
    z = model.encode(params, graph)
    assert len(calls) == (2 if backend == "pallas" else 0)
    assert torch.equal(z, want)


def card_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_matmul_precision()  # the plain version's float32 GEMM, no TF32
    return torch.device("cuda", 0)


def ulps_of_sum(got, a1, x):
    """max |got - plain| in units of 2^-24 sum_k |a_ik x_kc|."""
    want = ppa.pp_aggregate_plain(a1, x).double()
    scale = ppa.pp_aggregate_plain(a1, x.float().abs()).double()
    return float(((got.double() - want).abs() / (scale * 2.0**-24)).max())


@pytest.mark.card
@pytest.mark.parametrize("n", [300, 1031])
@pytest.mark.parametrize("d", [1, 6, 8, 16, 24, 32, 40, 70])
def test_on_the_card_every_width_against_the_plain_version(n, d):
    """The kernel at any width, forward (bf16 x) and backward (a float32
    gradient of spread exponents, float32 and bf16 out), within 4 sqrt(r)
    units of 2^-24 sum|terms| of the plain version (r the most nonzeros of
    a row: chip_smoke.py's bound); a width padded up equals the padded
    operand's columns bit for bit, and the padding's columns come out 0."""
    dev = card_device()
    a1 = sym_a1(n, seed=n + d).to(dev)
    r = int(a1.sum(1, dtype=torch.int64).max())
    g = torch.Generator().manual_seed(7 * d + n)
    x = torch.randn(n, d, generator=g).to(torch.bfloat16).to(dev)
    gr = (torch.randn(n, d, generator=g) * torch.exp2(torch.randint(
        -8, 9, (n, d), generator=g).float())).to(dev)
    for inp in (x, gr):
        out = ppa.pp_aggregate_cuda(a1, inp)
        assert out.shape == (n, d) and out.dtype == torch.float32
        assert ulps_of_sum(out, a1, inp) <= 4 * math.sqrt(r)
        c0, c1, w = ppa.column_blocks(d)[-1]
        if c1 - c0 < w:  # the last block is padded: the same bits as
            # the kernel on the padded operand
            xp = torch.nn.functional.pad(inp[:, c0:c1], (0, w - (c1 - c0)))
            full = ppa.pp_aggregate_cuda(a1, xp)
            assert torch.equal(out[:, c0:c1], full[:, : c1 - c0])
            assert not full[:, c1 - c0:].any()
    ob = ppa.pp_aggregate_cuda(a1, gr, out_dtype=torch.bfloat16)
    assert torch.equal(ob, ppa.pp_aggregate_cuda(a1, gr).to(torch.bfloat16))


@pytest.mark.card
@pytest.mark.parametrize("d", [6, 24, 40])
def test_on_the_card_function_at_an_odd_width(d):
    """The autograd.Function on CUDA at widths no layer of the cells uses:
    forward and x's gradient within the plain version's bound, the
    gradient bf16, one launch a column block each way."""
    from tip_tpu_torch import kernels

    dev = card_device()
    n = 300
    a1 = sym_a1(n, seed=d).to(dev)
    r = int(a1.sum(1, dtype=torch.int64).max())
    g = torch.Generator().manual_seed(d)
    x = torch.randn(n, d, generator=g).to(torch.bfloat16).to(dev)
    ct = torch.randn(n, d, generator=g).to(dev)
    x.requires_grad_(True)
    kernels.reset_launch_counts()
    out = ppa.pp_aggregate(a1, x)
    (out * ct).sum().backward()
    assert kernels.LAUNCHES[ppa.KERNEL] == 2 * len(ppa.column_blocks(d))
    assert ulps_of_sum(out.detach(), a1, x.detach()) <= 4 * math.sqrt(r)
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == (n, d)
    want = ppa.pp_aggregate_plain(a1, ct)  # (A+I)^T ct, (A+I) symmetric
    scale = ppa.pp_aggregate_plain(a1, ct.abs())
    # the float32 sum within the bound, then one rounding to bf16
    assert torch.all((x.grad.float() - want).abs()
                     <= 4 * math.sqrt(r) * 2.0**-24 * scale
                     + 2.0**-8 * want.abs())
