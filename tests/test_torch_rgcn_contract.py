"""Kernel B15's module (tip_tpu_torch/ops/rgcn_contract.py) on the CPU: the
autograd.Function against the expression it replaced in
nn/rgcn.py:dense_rgcn_pair_apply_sym (the bf16-rounded attention table
times the float32 upcast of the int8 strips), forward and the attention
table's gradient bit for bit, at the basis widths and relation counts the
cells and an EP rank use and at ragged ones; what the Function saves for
the backward; the exact three-way bf16 split of the backward's operand;
the wrapper's column blocks, slab counts and argument checks; and the
backend's route through the R-GCN pair.  The CUDA kernel itself is held to
the plain version on the card, at Decagon shape by chip_smoke.py
(check_rgcn_contract) and at the cells' widths and ragged shapes by the
tests marked ``card`` (they skip themselves here): ``python -m pytest
tests/test_torch_rgcn_contract.py -m card --noconftest -q`` (this module
imports nothing of the JAX package)."""

import math

import pytest
import torch

from tip_tpu_torch.nn.rgcn import dense_rgcn_pair_apply_sym
from tip_tpu_torch.ops import pp_aggregate as ppa
from tip_tpu_torch.ops import rgcn_contract as rc
from tip_tpu_torch.ops.matmul import bf16_round, set_matmul_precision

B = 128  # rows of a strip (data/packing.py:SYM_BLOCK)


def strips_of(r: int, nb: int, seed: int, p: float = 0.02,
              signed: bool = False) -> torch.Tensor:
    """Random sparse int8 strips [r, 128, nb (nb + 1) / 2 * 128]: counts 1-3
    at density p (with ``signed``, any int8 value there, -128 included)."""
    g = torch.Generator().manual_seed(seed)
    shape = (r, B, nb * (nb + 1) // 2 * B)
    hit = torch.rand(shape, generator=g) < p
    lo, hi = (-128, 128) if signed else (1, 4)
    vals = torch.randint(lo, hi, shape, generator=g, dtype=torch.int8)
    return torch.where(hit, vals, torch.zeros((), dtype=torch.int8))


def parent_contract(att, strips):
    """M as nn/rgcn.py computed it before the kernel: the bf16 rounding of
    att (float32 [R, Bt]) times the float32 upcast of the strips."""
    r = strips.shape[0]
    return bf16_round(att).T @ bf16_round(strips).reshape(r, -1)


@pytest.mark.parametrize("bt", [16, 32, 64])
@pytest.mark.parametrize("r,nb", [(1, 6), (7, 2), (275, 2), (1097, 1)])
def test_function_bit_equal_to_the_upcast_product(bt, r, nb):
    """Forward and the float32 attention table's gradient (through the
    bf16 cast, as the R-GCN pair takes it) equal the parent expression's,
    bit for bit, on the CPU; the gradient is float32 and bf16-valued."""
    strips = strips_of(r, nb, seed=r + nb + bt)
    g = torch.Generator().manual_seed(bt * r)
    att0 = torch.randn(r, bt, generator=g)
    ct = torch.randn(bt, strips[0].numel(), generator=g)
    outs = []
    for fn in (lambda a: rc.rgcn_contract(a.to(torch.bfloat16), strips),
               lambda a: parent_contract(a, strips)):
        att = att0.clone().requires_grad_(True)
        m = fn(att)
        (m * ct).sum().backward()
        outs.append((m.detach(), att.grad))
    (m, da), (want_m, want_da) = outs
    assert m.shape == (bt, strips[0].numel()) and m.dtype == torch.float32
    assert torch.equal(m, want_m)
    assert da.dtype == torch.float32 and torch.equal(da, want_da)
    assert torch.equal(da, bf16_round(da))


def test_plain_versions_are_the_function_on_the_cpu():
    strips = strips_of(7, 2, seed=1, signed=True)
    g = torch.Generator().manual_seed(2)
    att = torch.randn(7, 32, generator=g).to(torch.bfloat16)
    ct = torch.randn(32, strips[0].numel(), generator=g)
    a = att.clone().requires_grad_(True)
    m = rc.rgcn_contract(a, strips)
    m.backward(ct)
    assert torch.equal(m, rc.rgcn_contract_plain(att, strips))
    want = rc.rgcn_contract_grad_plain(strips, ct).to(torch.bfloat16)
    assert a.grad.dtype == torch.bfloat16 and torch.equal(a.grad, want)
    # signed counts upcast exactly: the plain version against float64
    exact = att.double().T @ strips.reshape(7, -1).double()
    scale = att.double().abs().T @ strips.reshape(7, -1).double().abs()
    assert torch.all((m.detach().double() - exact).abs()
                     <= 7 * 2.0**-24 * scale)


def saved_bytes(fn) -> int:
    """Bytes of the tensors autograd saves for the backward while fn runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


def test_function_saves_only_the_strips_and_att():
    """The Function keeps the int8 strips and the bf16 table, R C + 2 R Bt
    bytes; the expression it replaced kept the float32 upcast (4 R C)."""
    r, bt = 275, 64
    strips = strips_of(r, 2, seed=4)
    att = torch.randn(r, bt).requires_grad_(True)
    c = strips[0].numel()
    got = saved_bytes(lambda: rc.rgcn_contract(att.to(torch.bfloat16),
                                               strips))
    assert got == r * c + 2 * r * bt
    assert saved_bytes(lambda: parent_contract(att, strips)) >= 4 * r * c
    m = rc.rgcn_contract(att.to(torch.bfloat16), strips)
    saved = m.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bfloat16, torch.int8]
    assert saved[1].data_ptr() == strips.data_ptr()


def test_split3_is_exact_on_the_backward_operand():
    """M's gradient as the backward receives it (float32 of spread
    exponents) is the sum of the three bf16 terms the kernel multiplies,
    and every int8 value times a term is exact in float32."""
    g = torch.Generator().manual_seed(6)
    gm = torch.randn(64, 4096, generator=g) * torch.exp2(
        torch.randint(-30, 31, (64, 4096), generator=g).float())
    hi, mid, lo = ppa.split3_plain(gm)
    for t in (hi, mid, lo):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert torch.equal(hi.double() + mid.double() + lo.double(), gm.double())
    # each int8 x term product is exact in float32, as on the tensor cores
    v = torch.arange(-128, 128, dtype=torch.int8).float()[:, None, None]
    for t in (hi, mid, lo):
        t = t[:8]
        assert torch.equal((v * t).double(), v.double() * t.double())


@pytest.mark.parametrize("bt", [1, 16, 17, 32, 33, 48, 64, 65, 96, 128, 130])
def test_column_blocks_cover_every_width(bt):
    """Blocks of at most 64 bases tile [0, bt) in order, each padded to the
    least instantiated width that holds it."""
    blocks = rc.column_blocks(bt)
    assert [b0 for b0, _, _ in blocks] == list(range(0, bt, 64))
    assert blocks[-1][1] == bt
    for (b0, b1, w), nxt in zip(blocks, blocks[1:] + [(bt, None, None)]):
        assert b1 == nxt[0] and 0 < b1 - b0 <= w and w in rc.WIDTHS
        assert all(v < b1 - b0 for v in rc.WIDTHS if v < w)


@pytest.mark.parametrize("r,c,w,sms,want", [
    (1097, 344064, 64, 132, 26),  # TIP-cat: 5 relation tiles x 26 = 130
    (1097, 344064, 32, 132, 44),  # DR-NN: 3 tiles x 44 = 132
    (275, 344064, 64, 132, 66),  # an EP rank's block: 2 tiles x 66
    (7, 16384, 32, 132, 132),
    (1, 16384, 64, 132, 132)])
def test_slabs(r, c, w, sms, want):
    """The backward's column slabs fill the SMs with whole waves of one
    block each."""
    ks = rc.slabs(r, c, w, sms)
    assert ks == want and 1 <= ks <= c // rc.B_KC
    tiles = -(-r // rc.relation_tile(w))
    assert tiles * ks <= sms


@pytest.mark.parametrize("case", ["att_rows", "att_float", "att_1d",
                                  "strips_float", "strips_uint8", "no_bases"])
def test_argument_checks_raise(case):
    strips = strips_of(7, 1, seed=1)
    att = torch.randn(7, 16).to(torch.bfloat16)
    bad = {"att_rows": (att[:5], strips), "att_float": (att.float(), strips),
           "att_1d": (att[:, 0], strips),
           "strips_float": (att, strips.float()),
           "strips_uint8": (att, strips.to(torch.uint8)),
           "no_bases": (att[:, :0], strips)}[case]
    with pytest.raises(ValueError):
        rc.rgcn_contract(*bad)


def test_kernel_checks_want_whole_column_tiles():
    att = torch.randn(3, 16).to(torch.bfloat16)
    rc.check_args(att, strips_of(3, 1, seed=2), kernel=True)
    with pytest.raises(ValueError, match="multiple of 256"):
        rc.check_args(att, torch.zeros((3, 4, 100), dtype=torch.int8),
                      kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        rc.check_args(att, strips_of(3, 2, seed=2)[:, :, :256], kernel=True)


def test_cuda_wrappers_refuse_cpu_tensors():
    strips = strips_of(7, 1, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        rc.rgcn_contract_cuda(torch.randn(7, 16).to(torch.bfloat16), strips)
    with pytest.raises(ValueError, match="CUDA"):
        rc.rgcn_contract_grad_cuda(strips, torch.randn(16, 16384))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_rgcn_pair_takes_the_backends_route(backend, monkeypatch):
    """``backend="xla"`` takes the float32 product of the upcast strips and
    never reaches B15's module; 'pallas' goes through it once; on the CPU
    both give the same bits, forward and gradients."""
    from tip_tpu_torch.nn import rgcn

    n, nb, n_et = 200, 2, 5
    strips = strips_of(n_et, nb, seed=8)
    g = torch.Generator().manual_seed(9)

    def params(d_in, d_out, n_base):
        return {"att": torch.randn(n_et, n_base, generator=g),
                "basis": torch.randn(n_base, d_in, d_out, generator=g) * 0.2,
                "root": torch.randn(d_in, d_out, generator=g) * 0.2}

    p1, p2 = params(12, 8, 4), params(8, 6, 4)
    x = torch.randn(n, 12, generator=g)
    deg = torch.randint(1, 9, (n,), generator=g).float()
    ct = torch.randn(n, 6, generator=g)
    calls = []
    real = rgcn.rgcn_contract
    monkeypatch.setattr(rgcn, "rgcn_contract",
                        lambda *a: calls.append(1) or real(*a))
    results = []
    for route in (backend, "xla"):
        leaves = [p1["att"], p2["att"], p1["basis"], x]
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        out = dense_rgcn_pair_apply_sym(p1, p2, x, strips, deg,
                                        backend=route)
        (out * ct).sum().backward()
        results.append([out.detach()] + [t.grad.clone() for t in leaves])
    assert len(calls) == (1 if backend == "pallas" else 0)
    for got, want in zip(*results):
        assert torch.equal(got, want)


# ---------------------------------------------------------------- the card

def card_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_matmul_precision()  # the plain version's float32 GEMM, no TF32
    return torch.device("cuda", 0)


def units(got, want, scale) -> float:
    """max |got - want| in units of 2^-24 sum|terms| of each element."""
    return float(((got.double() - want.double()).abs()
                  / (scale.double() * 2.0**-24).clamp_min(1e-300)).max())


def bounds(strips) -> tuple:
    """(forward, backward) error bounds, 4 sqrt(n) units of 2^-24 sum|terms|,
    n the most nonzero terms an element sums: the nonzero relations of a
    column (forward) and the nonzero columns of a relation (backward, three
    terms each)."""
    nz = strips.reshape(strips.shape[0], -1) != 0
    n_fwd = int(nz.sum(0, dtype=torch.int64).max())
    n_bwd = 3 * int(nz.sum(1, dtype=torch.int64).max())
    return 4 * math.sqrt(max(n_fwd, 1)), 4 * math.sqrt(max(n_bwd, 1))


@pytest.mark.card
@pytest.mark.parametrize("r,nb,bt", [(1097, 6, 64), (1097, 6, 32),
                                     (275, 6, 64), (300, 2, 96), (7, 2, 16),
                                     (77, 1, 40), (1, 1, 32)])
def test_on_the_card_against_the_plain_version(r, nb, bt):
    """Forward and backward (a float32 gradient of spread exponents) within
    4 sqrt(n) units of 2^-24 sum|terms| of the plain version, at the
    cells' widths (64: TIP-cat, 32: DR-NN), an EP rank's block (275) and
    ragged counts and widths (signed int8 values, -128 included); a rerun
    bit-equal each way."""
    dev = card_device()
    strips = strips_of(r, nb, seed=r * nb + bt, signed=True).to(dev)
    g = torch.Generator().manual_seed(bt + r)
    att = torch.randn(r, bt, generator=g).to(torch.bfloat16).to(dev)
    c = strips[0].numel()
    gm = (torch.randn(bt, c, generator=g) * torch.exp2(torch.randint(
        -8, 9, (bt, c), generator=g).float())).to(dev)
    b_fwd, b_bwd = bounds(strips)
    sf = strips.reshape(r, -1).float()

    m = rc.rgcn_contract_cuda(att, strips)
    want = rc.rgcn_contract_plain(att, strips)
    scale = att.float().abs().T @ sf.abs()
    assert m.shape == (bt, c) and m.dtype == torch.float32
    assert units(m, want, scale) <= b_fwd
    assert torch.equal(m, rc.rgcn_contract_cuda(att, strips))
    del want, scale

    da = rc.rgcn_contract_grad_cuda(strips, gm)
    want = rc.rgcn_contract_grad_plain(strips, gm)
    scale = sf.abs() @ gm.abs().t()
    assert da.shape == (r, bt) and da.dtype == torch.float32
    assert units(da, want, scale) <= b_bwd
    assert torch.equal(da, rc.rgcn_contract_grad_cuda(strips, gm))


@pytest.mark.card
@pytest.mark.parametrize("bt", [32, 64, 80])
def test_on_the_card_function_launches_and_gradient(bt):
    """The autograd.Function on CUDA: one launch a column block each way,
    the gradient bf16 and within the backward's bound of the plain
    version before its rounding to bf16."""
    from tip_tpu_torch import kernels

    dev = card_device()
    r = 300
    strips = strips_of(r, 2, seed=bt).to(dev)
    g = torch.Generator().manual_seed(bt)
    att = torch.randn(r, bt, generator=g).to(torch.bfloat16).to(dev)
    ct = torch.randn(bt, strips[0].numel(), generator=g).to(dev)
    a = att.clone().requires_grad_(True)
    kernels.reset_launch_counts()
    m = rc.rgcn_contract(a, strips)
    m.backward(ct)
    assert kernels.LAUNCHES[rc.KERNEL] == 2 * len(rc.column_blocks(bt))
    assert a.grad.dtype == torch.bfloat16 and a.grad.shape == (r, bt)
    sf = strips.reshape(r, -1).float()
    want = rc.rgcn_contract_grad_plain(strips, ct)
    scale = sf.abs() @ ct.abs().t()
    _, b_bwd = bounds(strips)
    assert torch.all((a.grad.float() - want).abs()
                     <= b_bwd * 2.0**-24 * scale + 2.0**-8 * want.abs())
