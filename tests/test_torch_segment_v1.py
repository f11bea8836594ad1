"""Kernels B6 and B7 of the port (tip_tpu_torch/ops/typed_segment.py: the
v1 DistMult and NN-decoder SDDMMs) against the JAX package's
distmult_logits_padded and nn_logits_padded on the CPU.

The CPU runs the plain PyTorch versions; chip_smoke.py holds the CUDA
kernels against them on the card.  The JAX kernels run in interpret mode,
as tests/test_torch_sddmm2.py runs B8.  Logits agree to atol 1e-5 and the
gradients to atol/rtol 1e-4 (float32 sums in another order: the TPU
kernels accumulate dz and dh over all chunks and dw per relation block).
Both get the same cotangent, so the bf16 rounding of each scattered
contribution sees the same float32 inputs.  dw is compared on the
relations that own a chunk: the TPU kernel never writes the others, the
port writes 0 there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import synthetic_trigraph
from tip_tpu.data.packing import pad_typed_edges, sort_typed_edges, split_typed_edges
from tip_tpu.ops.pallas_segment import distmult_logits_padded as j_dm1
from tip_tpu.ops.pallas_segment import nn_logits_padded as j_nn1
from tip_tpu_torch import kernels
from tip_tpu_torch.ops import sddmm2
from tip_tpu_torch.ops import typed_segment as port

N_ET = 7  # relations 5 and 6 own no chunk


def _setup(n_drug, seed=2):
    raw = synthetic_trigraph(n_drug=n_drug, n_prot=10, n_et=5,
                             pairs_per_et=70, seed=seed)
    edges, _ = split_typed_edges(raw.dd_pair_list, p=0.95, seed=0)
    padded = pad_typed_edges(sort_typed_edges(edges), n_drug, chunk=32)
    nc = padded.chunk_type.shape[0]
    bufs = (padded.src.reshape(nc, 32), padded.dst.reshape(nc, 32),
            padded.chunk_type)
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n_drug, 16)).astype(np.float32)
    h1, h2 = (np.maximum(rng.normal(size=(n_drug, 16)), 0).astype(np.float32)
              for _ in range(2))
    w1, w2, w = (rng.normal(size=(N_ET, 16)).astype(np.float32)
                 for _ in range(3))
    valid = padded.valid.reshape(nc, 32).astype(np.float32)
    cot = rng.normal(size=valid.shape).astype(np.float32)
    owned = np.unique(padded.chunk_type)
    assert len(owned) < N_ET
    return bufs, dict(z=z, w=w, h1=h1, h2=h2, w1=w1, w2=w2), valid, cot, owned


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("n_drug", [40, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distmult_v1_matches_jax(n_drug, dtype):
    bufs, x, valid, cot, owned = _setup(n_drug)
    jb = list(map(jnp.asarray, bufs))

    def jloss(z, w):
        lg = j_dm1(z, w, *jb, jnp.dtype(dtype))
        return jnp.sum(lg * cot), lg

    with pltpu.force_tpu_interpret_mode():
        (_, jlg), (jgz, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                  has_aux=True)(x["z"], x["w"])
    zt = torch.tensor(x["z"], requires_grad=True)
    wt = torch.tensor(x["w"], requires_grad=True)
    lg = port.distmult_logits_padded(zt, wt, *_t(bufs), dtype)
    (lg * torch.from_numpy(cot)).sum().backward()
    _close(lg.detach(), jlg, 1e-5)
    _close(zt.grad, jgz, 1e-4, 1e-4)
    _close(wt.grad[owned], np.asarray(jgw)[owned], 1e-4, 1e-4)
    others = np.setdiff1d(np.arange(N_ET), owned)
    assert torch.all(wt.grad[others] == 0)
    pad = valid == 0
    assert pad.any()
    assert np.all(lg.detach().numpy()[pad] == 0.0)
    assert np.all(np.asarray(jlg)[pad] == 0.0)


@pytest.mark.parametrize("n_drug", [40, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nn_v1_matches_jax(n_drug, dtype):
    bufs, x, valid, cot, owned = _setup(n_drug)
    jb = list(map(jnp.asarray, bufs))
    names = ("h1", "h2", "w1", "w2")

    def jloss(*args):
        lg = j_nn1(*args, *jb, jnp.dtype(dtype))
        return jnp.sum(lg * cot), lg

    with pltpu.force_tpu_interpret_mode():
        (_, jlg), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                          has_aux=True)(*(x[k] for k in names))
    tx = [torch.tensor(x[k], requires_grad=True) for k in names]
    lg = port.nn_logits_padded(*tx, *_t(bufs), dtype)
    (lg * torch.from_numpy(cot)).sum().backward()
    # every slot, pad slots too: their src term is the same garbage in both
    _close(lg.detach(), jlg, 1e-5)
    _close(tx[0].grad, jg[0], 1e-4, 1e-4)
    _close(tx[1].grad, jg[1], 1e-4, 1e-4)
    others = np.setdiff1d(np.arange(N_ET), owned)
    for t, j in zip(tx[2:], jg[2:]):
        _close(t.grad[owned], np.asarray(j)[owned], 1e-4, 1e-4)
        assert torch.all(t.grad[others] == 0)
    pad = valid == 0
    assert pad.any() and np.any(np.asarray(jlg)[pad] != 0.0)


@pytest.mark.parametrize("kernel", ["distmult", "nn"])
def test_plain_backward_matches_autograd_of_plain_forward(kernel):
    """The hand-written backward (the CUDA kernels' arithmetic) equals
    autograd through the plain forward in float32."""
    bufs, x, _, cot, _ = _setup(300, seed=3)
    names = ("z", "w") if kernel == "distmult" else ("h1", "h2", "w1", "w2")
    fwd, bwd = ((port.distmult_v1_fwd_plain, port.distmult_v1_bwd_plain)
                if kernel == "distmult"
                else (port.nn_v1_fwd_plain, port.nn_v1_bwd_plain))
    tx = [torch.tensor(x[k], requires_grad=True) for k in names]
    (fwd(*tx, *_t(bufs)) * torch.from_numpy(cot)).sum().backward()
    got = bwd(*(torch.from_numpy(x[k]) for k in names), *_t(bufs),
              torch.from_numpy(cot))
    for g, t in zip(got, tx):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-4,
                                   rtol=1e-5)


def test_v1_equals_v2_in_float32_on_valid_slots():
    """B6 and B8, B7 and B9 compute the same logits and gradients; they
    round to bf16 at other points, so they agree in float32 only."""
    bufs, x, valid, cot, _ = _setup(300, seed=4)
    tb = _t(bufs)
    g = torch.from_numpy(cot * valid)  # a masked loss: pad slots carry no g
    ok = torch.from_numpy(valid) > 0
    z, w = torch.from_numpy(x["z"]), torch.from_numpy(x["w"])
    _close(port.distmult_v1_fwd_plain(z, w, *tb)[ok],
           sddmm2.distmult_logits_plain(z, w, *tb)[ok], 1e-5)
    for a, b in zip(port.distmult_v1_bwd_plain(z, w, *tb, g),
                    sddmm2.distmult_bwd_plain(z, w, *tb, g)):
        _close(a, b, 1e-4, 1e-4)
    hw = [torch.from_numpy(x[k]) for k in ("h1", "h2", "w1", "w2")]
    _close(port.nn_v1_fwd_plain(*hw, *tb)[ok],
           sddmm2.nn_logits_plain(*hw, *tb)[ok], 1e-5)
    for a, b in zip(port.nn_v1_bwd_plain(*hw, *tb, g),
                    sddmm2.nn_bwd_plain(*hw, *tb, g)):
        _close(a, b, 1e-4, 1e-4)


def test_cpu_tensors_take_the_plain_versions_and_cuda_wrappers_refuse_them():
    bufs, x, _, _, _ = _setup(40)
    tb = _t(bufs)
    kernels.reset_launch_counts()
    zt = torch.tensor(x["z"], requires_grad=True)
    port.distmult_logits_padded(zt, torch.from_numpy(x["w"]), *tb).sum().backward()
    hw = [torch.tensor(x[k], requires_grad=True) for k in ("h1", "h2", "w1", "w2")]
    port.nn_logits_padded(*hw, *tb, "bfloat16").sum().backward()
    assert kernels.LAUNCHES[port.DM1] == 0 and kernels.LAUNCHES[port.NN1] == 0
    z, w = torch.from_numpy(x["z"]), torch.from_numpy(x["w"])
    for call in (lambda: port.distmult_v1_fwd_cuda(z, w, *tb),
                 lambda: port.distmult_v1_bwd_cuda(z, w, *tb, z[:0]),
                 lambda: port.nn_v1_fwd_cuda(z, z, w, w, *tb),
                 lambda: port.nn_v1_bwd_cuda(z, z, w, w, *tb, z[:0])):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("bad", ["width", "relations", "nodes", "dtype",
                                 "g_shape", "table"])
@pytest.mark.parametrize("kernel", ["distmult", "nn"])
def test_cuda_argument_checks(kernel, bad):
    """What the CUDA wrappers refuse before they hand pointers to a kernel
    (the checks need no card)."""
    bufs, x, _, cot, _ = _setup(40)
    if kernel == "distmult":
        nodes = {"z": torch.from_numpy(x["z"])}
        rels = {"w": torch.from_numpy(x["w"])}
    else:
        nodes = {k: torch.from_numpy(x[k]) for k in ("h1", "h2")}
        rels = {k: torch.from_numpy(x[k]) for k in ("w1", "w2")}
    tb, g = _t(bufs), torch.from_numpy(cot)
    port._check_v1_args(nodes, rels, tb, True, "shared", g)  # valid: passes
    table = "shared"
    if bad == "width":  # the kernels are built for width 16 only
        nodes = {k: v[:, :12].contiguous() for k, v in nodes.items()}
    elif bad == "relations":  # relation rows of another width
        rels = {k: v[:, :8].contiguous() for k, v in rels.items()}
    elif bad == "nodes":  # the shared-memory tables no longer fit
        nodes = {k: torch.zeros(3500, 16) for k in nodes}
    elif bad == "dtype":
        tb[0] = tb[0].long()
    elif bad == "g_shape":
        g = g[:, :16].contiguous()
    else:
        table = "device"
    with pytest.raises(ValueError):
        port._check_v1_args(nodes, rels, tb, True, table, g)


@pytest.mark.parametrize("tables,grads,n_max", [
    (1, False, 3417), (1, True, 3402), (2, False, 1708), (2, True, 1693)])
def test_shared_table_boundary(tables, grads, n_max):
    """The largest graph whose tables B6 (one) or B7 (two) keep in shared
    memory; one node more takes the global-memory mode, which has no
    limit."""
    assert port.v1_shared_fits(n_max, tables, grads)
    assert not port.v1_shared_fits(n_max + 1, tables, grads)
    bufs, x, _, _, _ = _setup(40)
    names = ("z",) if tables == 1 else ("h1", "h2")
    rels = {k: torch.from_numpy(x[k]) for k in (("w",) if tables == 1
                                                else ("w1", "w2"))}
    for n, shared in ((n_max, True), (n_max + 1, False), (40_000, False)):
        nodes = {k: torch.zeros(n, 16) for k in names}
        assert port._check_v1_args(nodes, rels, _t(bufs), grads) == (n, shared)
        assert port._check_v1_args(nodes, rels, _t(bufs), grads,
                                   "global") == (n, False)
