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
    """The backward adds into dx in device memory; a block holds only its
    16 warps' dP^T tiles [slice, 17], the slice the widest power of two up
    to 64 dividing d, so three blocks share an SM at d = 64."""
    for d, ks in ((64, 64), (32, 32), (48, 16), (16, 16), (12, 4), (7, 1)):
        assert port._pow2_slice(d) == ks
        assert port._tns_warps(0, ks) == 16
    assert 3 * 4 * 16 * 64 * 17 <= port.kernels.SMEM_BYTES


def test_forward_feature_slice_fits_shared_memory():
    """The forward keeps x whole in shared memory at Decagon's 645 drugs
    and in two 32-feature slices at 1,536 (one plan serves both
    directions); a slice always divides d, and the warps' staging tiles fit
    beside it."""
    assert port.tns_fwd_kslice(645, 64) == 64
    assert port.tns_fwd_kslice(645, 32) == 32
    assert port.tns_fwd_kslice(1536, 64) == 32
    assert port.tns_fwd_kslice(7128, 64) == 8
    assert port.tns_fwd_kslice(7129, 64) == 0
    for n in (40, 645, 1536, 3000, 7000, 7129):
        for d in (4, 8, 16, 24, 32, 48, 64, 128):
            ks = port.tns_fwd_kslice(n, d)
            if ks:
                assert d % ks == 0 and ks <= 64 and ks & (ks - 1) == 0
                assert ks >= min(8, d)
                warps = port._tns_warps(n, ks)
                assert 8 <= warps <= 16
                assert 4 * (n * ks + warps * ks * 17) <= port.kernels.SMEM_BYTES
            gks = port._pow2_slice(d)  # the global mode's slice
            assert d % gks == 0 and port._tns_warps(0, gks) == 16


@pytest.mark.parametrize("n_shards", [1, 3])
def test_typed_csr_yardstick_matches_plain_versions(packed, n_shards):
    """torch.sparse.mm over the typed CSR reproduces the forward (P^T
    transposed to [n_et * n, d]) and over its transpose the backward, on
    the whole buffers and on a rank's contiguous share of the chunks
    (relations it does not hold are zero)."""
    n, edges, bufs = packed
    rng = np.random.default_rng(8)
    k = -(-bufs[0].shape[0] // n_shards)
    lo = k if n_shards > 1 else 0  # the second rank's share
    src2d, dst2d, ct = (b[lo:lo + k] for b in _t(bufs))
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    dpt = torch.from_numpy(rng.normal(size=(edges.n_et, 8, n)).astype(np.float32))
    want = port.typed_neighbor_sum_fwd_plain(x, src2d, dst2d, ct, edges.n_et)
    got = torch.sparse.mm(port.typed_csr(src2d, dst2d, ct, n, edges.n_et), x)
    np.testing.assert_allclose(
        got.numpy(), want.transpose(1, 2).reshape(-1, 8).numpy(), atol=1e-5)
    want_dx = port.typed_neighbor_sum_bwd_plain(dpt, src2d, dst2d, ct)
    adj_t = port.typed_csr(src2d, dst2d, ct, n, edges.n_et, transpose=True)
    assert adj_t.shape == (n, edges.n_et * n)
    got_dx = torch.sparse.mm(adj_t, dpt.transpose(1, 2).reshape(-1, 8))
    np.testing.assert_allclose(got_dx.numpy(), want_dx.numpy(), atol=1e-4)


@pytest.mark.parametrize("ranks", [2, 4])
def test_rank_blocks_split_the_sum_and_zero_the_relations_a_rank_lacks(
        ranks):
    """tns_bench.rank_blocks gives each rank its block of the padded chunk
    buffers, as the sharded path places them; the ranks' forwards sum to
    the whole one, and the P^T rows of the relations a block lacks are zero
    (kernel B4 writes them with no zero-fill pass before it)."""
    from tip_tpu_torch.data import build_trigraph
    from tip_tpu_torch.data import synthetic_trigraph as t_raw
    from tip_tpu_torch.scripts.tns_bench import rank_blocks
    from tip_tpu_torch.train.model import make_graph_arrays

    data = build_trigraph(t_raw(n_drug=40, n_prot=70, n_et=5, pairs_per_et=60,
                                seed=8), split_rate=0.9, seed=8)
    graph, gs = make_graph_arrays(data, "cpu", dense_dtype=None, dd_chunk=16,
                                  pp_window=64, pp_chunk=32)
    bufs = graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"]
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(gs.n_drug, 8)).astype(np.float32))
    whole = port.typed_neighbor_sum_fwd_plain(x, *bufs, gs.n_et)
    total, lacking = torch.zeros_like(whole), 0
    for src2d, dst2d, ct in rank_blocks(graph, gs, ranks):
        assert src2d.shape == (-(-bufs[0].shape[0] // ranks), 16)
        part = port.typed_neighbor_sum_fwd_plain(x, src2d, dst2d, ct, gs.n_et)
        owned = torch.zeros(gs.n_et, dtype=torch.bool)
        owned[ct.long()] = True
        assert not part[~owned].any()
        lacking += int((~owned).sum())
        total += part
    assert lacking > 0
    np.testing.assert_allclose(total.numpy(), whole.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def hub_windowed():
    """A P-P graph of 700 nodes whose node 3 is joined to 600 others: the
    hub's run (601 slots with its self loop) crosses 19 chunks of 32."""
    rng = np.random.default_rng(11)
    n = 700
    e = rng.integers(0, n, size=(2, 2000), dtype=np.int32)
    hub = np.stack([np.full(600, 3, np.int32),
                    rng.choice(np.delete(np.arange(n), 3), 600, replace=False)
                    .astype(np.int32)])
    e = np.concatenate([e, hub], axis=1)
    e = e[:, e[0] != e[1]]
    e = np.unique(np.stack([np.minimum(e[0], e[1]), np.maximum(e[0], e[1])]),
                  axis=1)
    e = np.concatenate([e, e[::-1]], axis=1)
    idx, w = gcn_normalize(e, n)
    win = pad_windowed_edges(idx, w, n, window=64, chunk=32)
    nc = win.chunk_window.shape[0]
    bufs = (win.src.reshape(nc, 32), win.dst_local.reshape(nc, 32),
            win.weight.reshape(nc, 32), win.chunk_window)
    return n, bufs, (win.n_windows, win.window, n)


def emulate_gcn_spmm(x, src2d, dstl2d, w2d, cw, window, n, bf16=False,
                     group=port.SPMM_GROUP):
    """csrc/gcn_spmm.cu in float32, in its order.  The slots are one flat
    array cut into groups of 32, a warp a group; a run (the slots of one
    row of one window) is cut into pieces at the groups' edges, each piece
    summed in slot order.  A run inside one group is its piece; the pieces
    of a run that crosses groups are added in group order.  Returns (out,
    rows written, the pieces of each run that crosses groups)."""
    f = np.float32
    src, dstl, w = src2d.reshape(-1), dstl2d.reshape(-1), w2d.reshape(-1)
    E, d = len(src), x.shape[1]
    win = np.repeat(cw, src2d.shape[1])
    out = np.zeros((n, d), f)
    writes = np.zeros(n, np.int64)
    crossing = []
    e = 0
    while e < E:
        if dstl[e] >= window:
            e += 1
            continue
        end = e
        while end < E and dstl[end] == dstl[e] and win[end] == win[e]:
            end += 1
        pieces = []
        for g0 in range(e // group * group, end, group):
            s = np.zeros(d, f)
            for j in range(max(e, g0), min(end, g0 + group)):
                m = (x[src[j]] * f(w[j])).astype(f)
                if bf16:
                    m = torch.from_numpy(m).to(torch.bfloat16).float().numpy()
                s = (s + m).astype(f)
            pieces.append(s)
        total = pieces[0]
        for p in pieces[1:]:
            total = (total + p).astype(f)
        row = win[e] * window + dstl[e]
        if row < n:
            out[row] = total
            writes[row] += 1
        if len(pieces) > 1:
            crossing.append(len(pieces))
        e = end
    return out, writes, crossing


@pytest.mark.parametrize("d", [32, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_spmm_group_emulation_with_hub_matches(hub_windowed, d, dtype):
    """The kernel's groups of 32 slots, a run's pieces added in group
    order (emulate_gcn_spmm), give the plain version and the JAX kernel
    (interpret mode) to 1e-5 on a graph whose hub run crosses 19 chunks,
    each row written once."""
    n, bufs, static = hub_windowed
    x = np.random.default_rng(12).normal(size=(n, d)).astype(np.float32)
    got, writes, crossing = emulate_gcn_spmm(
        x, *bufs, static[1], n, bf16=dtype == "bfloat16")
    assert max(crossing) >= 19  # the hub's run, across 19 groups or more
    win = np.repeat(bufs[3], bufs[0].shape[1])
    hub_slots = np.flatnonzero((win * static[1] + bufs[1].reshape(-1)) == 3)
    assert len(hub_slots) == 601
    assert hub_slots[-1] // 32 - hub_slots[0] // 32 >= 8  # chunks it crosses
    assert (writes <= 1).all()
    want = port.gcn_spmm_plain(torch.from_numpy(x), *_t(bufs), *static, dtype)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        jwant = np.asarray(j_spmm(jnp.asarray(x), *map(jnp.asarray, bufs),
                                  *static, jnp.dtype(dtype)))
    np.testing.assert_allclose(got, jwant, atol=1e-5)


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
    # with the launches of B13, B14, B15, B16 and B1's wide instance
    assert len(calls) == 23
    for entry, sig in calls:
        assert entries[entry] == sig, entry
