"""Kernels B4 (typed neighbour sum) and B5 (windowed P-P SpMM) of the port
(tip_tpu_torch/ops/typed_segment.py) against the JAX package on the CPU.

The CPU runs the plain PyTorch versions; chip_smoke.py holds the CUDA
kernels against them on the card.  The JAX kernels run in interpret mode,
as tests/test_pallas.py runs them, with its XLA segment path as a second
oracle; tolerances are test_pallas.py's (1e-5 forward, 1e-4 gradient):
float32 sums in another order.
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import synthetic_trigraph
from tip_tpu.data.packing import (
    gcn_normalize,
    pad_typed_edges,
    pad_windowed_edges,
    sort_typed_edges,
    split_typed_edges,
)
from tip_tpu.ops.pallas_segment import (
    gcn_spmm_padded as j_spmm,
    typed_neighbor_sum_padded_t as j_tns,
)
from tip_tpu.ops.segment import typed_neighbor_sum, weighted_gather_sum
from tip_tpu_torch import kernels
from tip_tpu_torch.ops import typed_segment as port

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def packed():
    raw = synthetic_trigraph(n_drug=40, n_prot=10, n_et=5, pairs_per_et=70,
                             seed=2)
    edges, _ = split_typed_edges(raw.dd_pair_list, p=0.95, seed=0)
    edges = sort_typed_edges(edges)
    padded = pad_typed_edges(edges, raw.n_drug, chunk=32)
    n_chunks = padded.chunk_type.shape[0]
    bufs = (padded.src.reshape(n_chunks, 32), padded.dst.reshape(n_chunks, 32),
            padded.chunk_type)
    return raw.n_drug, edges, bufs


@pytest.fixture(scope="module")
def windowed():
    rng = np.random.default_rng(5)
    n = 200
    e = rng.integers(0, n, size=(2, 600), dtype=np.int32)
    e = e[:, e[0] != e[1]]
    e = np.unique(np.stack([np.minimum(e[0], e[1]), np.maximum(e[0], e[1])]),
                  axis=1)
    e = np.concatenate([e, e[::-1]], axis=1)
    idx, w = gcn_normalize(e, n)
    win = pad_windowed_edges(idx, w, n, window=64, chunk=32)
    nc = win.chunk_window.shape[0]
    bufs = (win.src.reshape(nc, 32), win.dst_local.reshape(nc, 32),
            win.weight.reshape(nc, 32), win.chunk_window)
    return n, idx, w, bufs, (win.n_windows, win.window, n)


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_typed_neighbor_sum_forward_matches_jax(packed, dtype):
    n, edges, bufs = packed
    x = np.random.default_rng(0).normal(size=(n, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_tns(jnp.asarray(x), *map(jnp.asarray, bufs),
                                edges.n_et, jnp.dtype(dtype)))
    got = port.typed_neighbor_sum_padded_t(torch.from_numpy(x), *_t(bufs),
                                           edges.n_et, dtype)
    assert got.dtype == torch.float32 and got.shape == (edges.n_et, 16, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if dtype == "float32":  # the XLA segment path agrees too
        xla = typed_neighbor_sum(jnp.asarray(x), *edges.edge_index,
                                 edges.edge_type, n, edges.n_et)
        np.testing.assert_allclose(got.numpy(),
                                   np.swapaxes(np.asarray(xla), 1, 2),
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_typed_neighbor_sum_grad_matches_jax(packed, dtype):
    n, edges, bufs = packed
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    cot = rng.normal(size=(edges.n_et, 8, n)).astype(np.float32)
    jb = list(map(jnp.asarray, bufs))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(lambda x: jnp.vdot(
            j_tns(x, *jb, edges.n_et, jnp.dtype(dtype)), jnp.asarray(cot)))(
                jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    out = port.typed_neighbor_sum_padded_t(xt, *_t(bufs), edges.n_et, dtype)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-4)


def test_typed_neighbor_sum_pad_slots_and_empty_rows(packed):
    """Pad slots (dst = n) add nothing, and (relation, dst) pairs without
    edges are exactly zero."""
    n, edges, bufs = packed
    x = torch.ones(n, 4)
    out = port.typed_neighbor_sum_padded_t(x, *_t(bufs), edges.n_et)
    counts = np.zeros((edges.n_et, n))
    np.add.at(counts, (edges.edge_type, edges.edge_index[1]), 1.0)
    np.testing.assert_array_equal(out[:, 0].numpy(), counts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_spmm_forward_and_grad_match_jax(windowed, dtype):
    n, idx, w, bufs, static = windowed
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    cot = rng.normal(size=(n, 16)).astype(np.float32)
    jb = list(map(jnp.asarray, bufs))

    def jf(x):
        return j_spmm(x, *jb, *static, jnp.dtype(dtype))

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jf(jnp.asarray(x)))
        gwant = np.asarray(jax.grad(lambda x: jnp.vdot(jf(x), cot))(
            jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = port.gcn_spmm_padded(xt, *_t(bufs), *static, dtype)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), gwant, atol=1e-4)
    if dtype == "float32":  # the XLA COO path agrees too
        xla = weighted_gather_sum(jnp.asarray(x), idx[0], idx[1],
                                  jnp.asarray(w), n)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(xla),
                                   atol=1e-5)


def test_gcn_spmm_backward_is_the_adjoint(windowed):
    """The backward reruns the forward on dout, which is A_hat^T dout only
    because A_hat is symmetric: check both against the dense matrix."""
    n, idx, w, bufs, static = windowed
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (idx[1], idx[0]), w)
    assert np.allclose(a, a.T)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(n, 4)).astype(np.float32),
                     requires_grad=True)
    cot = rng.normal(size=(n, 4)).astype(np.float32)
    out = port.gcn_spmm_padded(x, *_t(bufs), *static)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), a @ x.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), a.T @ cot, atol=1e-5)


def test_gcn_spmm_last_window_rows_past_n(windowed):
    """n = 200 over windows of 64: the last window runs to row 256 and the
    output stops at n."""
    n, _, _, bufs, static = windowed
    assert static[0] * static[1] > n
    out = port.gcn_spmm_padded(torch.ones(n, 2), *_t(bufs), *static)
    assert out.shape == (n, 2) and bool(torch.isfinite(out).all())


def test_cpu_tensors_take_plain_versions_and_cuda_wrappers_refuse_them(
        packed, windowed):
    n, edges, bufs = packed
    kernels.reset_launch_counts()
    x = torch.randn(n, 8, requires_grad=True)
    port.typed_neighbor_sum_padded_t(x, *_t(bufs), edges.n_et).sum().backward()
    nw, _, _, wbufs, static = windowed
    port.gcn_spmm_padded(torch.randn(nw, 4), *_t(wbufs), *static)
    assert kernels.LAUNCHES[port.TNS] == 0 and kernels.LAUNCHES[port.SPMM] == 0
    with pytest.raises(ValueError, match="CUDA"):
        port.typed_neighbor_sum_fwd_cuda(x.detach(), *_t(bufs), edges.n_et)
    with pytest.raises(ValueError, match="CUDA"):
        port.typed_neighbor_sum_bwd_cuda(torch.zeros(edges.n_et, 8, n),
                                         *_t(bufs))
    with pytest.raises(ValueError, match="CUDA"):
        port.gcn_spmm_cuda(torch.randn(nw, 4), *_t(wbufs), *static)


def test_backward_feature_slice_fits_shared_memory():
    assert port.tns_bwd_kslice(645, 64) == 64
    assert port.tns_bwd_kslice(1536, 64) == 32
    assert port.tns_bwd_kslice(1536, 48) == 16
    # the narrowest slice is 8 features; past it the backward accumulates
    # in global memory (kslice 0), at any node count
    assert port.tns_bwd_kslice(6456, 64) == 8
    assert port.tns_bwd_kslice(6457, 64) == 0
    assert port.tns_bwd_kslice(10**6, 64) == 0


_CTYPE_CHAR = {"int": "i", "unsigned int": "u", "float": "f", "long long": "q"}


def _c_signature(params: str) -> str:
    """Signature characters of a C entry point, the stream left out."""
    chars = []
    for p in params.split(",")[:-1]:
        decl = " ".join(p.split()[:-1])  # drop the parameter name
        chars.append("p" if "*" in p else _CTYPE_CHAR[decl.replace("const ", "")])
    return "".join(chars)


def test_kernel_launch_signatures_match_c_entry_points():
    """Every kernels.launch call in the ops modules types its arguments as
    the C entry point declares them (ctypes would silently cut a pointer
    passed where an int is declared)."""
    entries = {}
    for cu in (ROOT / "tip_tpu_torch" / "csrc").glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       cu.read_text()):
            entries[name] = _c_signature(params)
    calls = []
    for py in (ROOT / "tip_tpu_torch" / "ops").glob("*.py"):
        calls += re.findall(r'kernels\.launch\(\w+, "(\w+)", "(\w+)"',
                            py.read_text())
    assert len(calls) == 15
    for entry, sig in calls:
        assert entries[entry] == sig, entry
