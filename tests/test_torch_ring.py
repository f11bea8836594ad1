"""The port's protein-row ring (parallel/ring.py, kernel B11's module
ops/ring.py) against the JAX package on the CPU.

``build_ring_pp`` must give the JAX package's blocks bit for bit.  The ring
SpMM runs in four spawned gloo ranks (the port's workers in
tip_tpu_torch/scripts/sharded.py, which import no JAX), on the fixture of
tests/test_pallas_ring.py; JAX runs ``ring_spmm`` (scan + ppermute) and
``ring_spmm_rdma`` in interpret mode on its virtual CPU mesh.  Forward
atol 1e-5, gradient atol 1e-4 (tests/test_pallas_ring.py's tolerances
where it has them: float32 in another summation order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tip_tpu.data import build_trigraph as j_build, synthetic_trigraph as j_raw
from tip_tpu.ops import weighted_gather_sum
from tip_tpu.ops.pallas_ring import ring_spmm_rdma as j_ring_spmm_rdma
from tip_tpu.parallel import make_mesh as j_make_mesh
from tip_tpu.parallel.mesh import EDGE_AXIS
from tip_tpu.parallel.ring import build_ring_pp as j_build_ring_pp
from tip_tpu.parallel.ring import ring_spmm as j_ring_spmm
from tip_tpu_torch import kernels
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.ops import ring as ops_ring
from tip_tpu_torch.parallel.ring import build_ring_pp, ring_shard_size
from tip_tpu_torch.scripts.sharded import RingJob, ring_spmm_rank, spawn_ranks

RAW = dict(n_drug=40, n_prot=300, n_et=4, pairs_per_et=50, seed=21)
K = 4
D = 8


@pytest.fixture(scope="module")
def data():
    return (j_build(j_raw(**RAW), split_rate=0.9, seed=21),
            build_trigraph(synthetic_trigraph(**RAW), split_rate=0.9, seed=21))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_build_ring_pp_is_bit_identical(data, k):
    jd, td = data
    want = j_build_ring_pp(jd.pp_norm_index, jd.pp_norm_weight,
                           jd.dp_edge_index, jd.n_prot, k)
    got = build_ring_pp(td.pp_norm_index, td.pp_norm_weight, td.dp_edge_index,
                        td.n_prot, k)
    for f in ("src_local", "dst_local", "weight", "dp_src_local", "dp_dst",
              "dp_weight"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert (got.n_shards, got.n_local) == (want.n_shards, want.n_local)
    # every block: real edges sorted by local dst, then the zero pad tail
    for blk in range(k * k):
        w = got.weight.reshape(k * k, -1)[blk]
        dl = got.dst_local.reshape(k * k, -1)[blk]
        n = int((w != 0).sum())
        assert np.all(w[n:] == 0) and np.all(dl[n:] == 0)
        assert np.all(np.diff(dl[:n]) >= 0)


@pytest.fixture(scope="module")
def ring_runs(data):
    """The port's plain ring and op (four gloo ranks) and JAX's two rings
    on the same blocks, input and cotangent."""
    jd, td = data
    n_local = ring_shard_size(td.n_prot, K)
    ring = build_ring_pp(td.pp_norm_index, td.pp_norm_weight, td.dp_edge_index,
                         td.n_prot, K, pad_multiple=128)
    rng = np.random.default_rng(6)
    h = np.zeros((K * n_local, D), np.float32)
    h[: td.n_prot] = rng.normal(size=(td.n_prot, D))
    cot = rng.normal(size=(K * n_local, D)).astype(np.float32)
    job = RingJob(ring.src_local, ring.dst_local, ring.weight,
                  inputs=((h, cot),), device="cpu")
    ranks = spawn_ranks(ring_spmm_rank, K, job, timeout_s=120)
    port = {route: (np.concatenate([r[route][0][0] for r in ranks]),
                    np.concatenate([r[route][0][1] for r in ranks]))
            for route in ("plain", "op")}

    mesh = j_make_mesh(K)
    blocks = tuple(jnp.asarray(a) for a in (ring.src_local, ring.dst_local,
                                             ring.weight))

    def run(fn):
        def loss(hs, src, dstl, w, cs):
            out = fn(hs, src[0], dstl[0], w[0])
            return jax.lax.psum(jnp.vdot(out, cs), EDGE_AXIS), out

        def both(hs, src, dstl, w, cs):
            (_, out), g = jax.value_and_grad(loss, has_aux=True)(
                hs, src, dstl, w, cs)
            return out, g

        out, g = jax.jit(shard_map(
            both, mesh=mesh, in_specs=(P(EDGE_AXIS),) * 5,
            out_specs=(P(EDGE_AXIS), P(EDGE_AXIS)), check_vma=False,
        ))(jnp.asarray(h), *blocks, jnp.asarray(cot))
        # every device backpropagates the psum'd loss and psum's transpose
        # sums the k cotangents: k times the gradient of sum(out * cot)
        return np.asarray(out), np.asarray(g) / K

    want = {
        "xla": run(lambda hs, s, dl, w: j_ring_spmm(hs, s, dl, w, n_local,
                                                    EDGE_AXIS)),
        "rdma": run(lambda hs, s, dl, w: j_ring_spmm_rdma(hs, s, dl, w,
                                                          EDGE_AXIS, 128, True)),
    }
    dense = np.asarray(weighted_gather_sum(
        jnp.asarray(h[: jd.n_prot]), jnp.asarray(jd.pp_norm_index[0]),
        jnp.asarray(jd.pp_norm_index[1]), jnp.asarray(jd.pp_norm_weight),
        jd.n_prot))
    return port, want, dense, ranks


def test_plain_ring_matches_jax_ppermute_ring(ring_runs):
    port, want, _, _ = ring_runs
    np.testing.assert_allclose(port["plain"][0], want["xla"][0], atol=1e-5)
    np.testing.assert_allclose(port["plain"][1], want["xla"][1], atol=1e-4)


def test_ring_op_matches_jax_rdma_kernel_in_interpret_mode(ring_runs):
    port, want, _, _ = ring_runs
    np.testing.assert_allclose(port["op"][0], want["rdma"][0], atol=1e-5)
    np.testing.assert_allclose(port["op"][1], want["rdma"][1], atol=1e-4)


def test_ring_equals_the_replicated_spmm_and_its_adjoint(ring_runs, data):
    """The row-sharded ring is A_hat @ h; its gradient A_hat^T @ cot is the
    same ring on the cotangent (A_hat symmetric)."""
    port, _, dense, _ = ring_runs
    n = data[1].n_prot
    np.testing.assert_allclose(port["op"][0][:n], dense, atol=1e-5)
    np.testing.assert_array_equal(port["op"][0], port["plain"][0])
    # the op reruns the ring on the cotangent; autograd through the plain
    # ring sums the same products in another order
    np.testing.assert_allclose(port["op"][1], port["plain"][1], atol=1e-6)


def test_cpu_ranks_take_the_plain_version(ring_runs):
    _, _, _, ranks = ring_runs
    assert all(not any(r["launches"].values()) for r in ranks)


def test_cuda_wrapper_refuses_cpu_tensors(data):
    _, td = data
    ring = build_ring_pp(td.pp_norm_index, td.pp_norm_weight, td.dp_edge_index,
                         td.n_prot, 2)
    blocks = [torch.from_numpy(a[0]) for a in (ring.src_local, ring.dst_local,
                                               ring.weight)]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops_ring.ring_spmm_cuda(torch.zeros(ring.n_local, 4), *blocks, None)
    assert kernels.LAUNCHES[ops_ring.KERNEL] == 0
    assert kernels.KERNELS[ops_ring.KERNEL].replaces == \
        "tip_tpu/ops/pallas_ring.py:124"


def test_ring_buffer_slots_are_aligned():
    """Comm slots start 256-byte aligned past the flag words, and a shard of
    any width fits a slot sized for it."""
    for n_local, d in ((4771, 32), (4771, 16), (18, 6), (9541, 32)):
        slot = ops_ring.RingComm.slot_size(n_local, d)
        assert slot % ops_ring.SLOT_ALIGN == 0 and slot >= n_local * d * 4
        comm = ops_ring.RingComm("cpu", 0, slot, 4, 1 << 20, 0, 0)
        assert comm.fits(n_local, d) and not comm.fits(n_local + 64, d)
        assert comm.slot(0, 1) - comm.slot(0, 0) == slot
        assert comm.slot(0, 0) == ops_ring.HEADER


def emulate_ring_block(h, src, dst, w):
    """csrc/ring_spmm.cu's SpMM over one ring block in float32, in its
    order: a warp a window of 32 slots finds the slots of its window where
    a run starts (slot 0, or a destination above the previous slot's: the
    pad tail, dst 0 after the last real row, starts none), and sums each
    such run in slot order, on past its window while the destination
    stays; one write a run."""
    f = np.float32
    out = np.zeros_like(h)
    writes = 0
    for e0 in range(len(dst)):
        if e0 and dst[e0 - 1] >= dst[e0]:
            continue
        s, e = np.zeros(h.shape[1], f), e0
        while e < len(dst) and dst[e] == dst[e0]:
            s = s + h[src[e]] * f(w[e])
            e += 1
        out[dst[e0]] = out[dst[e0]] + s
        writes += 1
    return out, writes


@pytest.mark.parametrize("case", ["ring", "ends_on_row0", "empty"])
def test_ring_kernel_run_order_emulation_matches_plain(data, case):
    """The ring kernel's run discovery and slot-order sums
    (emulate_ring_block) give the plain block product on every block of a
    ring of 4, on a block whose real edges end on row 0 (the pad tail
    extends that run by zeros) and on a block of pads only; one write a
    destination row."""
    _, td = data
    ring = build_ring_pp(td.pp_norm_index, td.pp_norm_weight, td.dp_edge_index,
                         td.n_prot, K)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((ring.n_local, D)).astype(np.float32)
    blocks = [(ring.src_local[i, s], ring.dst_local[i, s], ring.weight[i, s])
              for i in range(K) for s in range(K)]
    e_pad = blocks[0][0].shape[0]
    if case == "ends_on_row0":
        src = rng.integers(0, ring.n_local, e_pad).astype(np.int32)
        dst = np.zeros(e_pad, np.int32)
        w = np.zeros(e_pad, np.float32)
        w[:7] = rng.standard_normal(7)
        blocks = [(src, dst, w)]
    elif case == "empty":
        blocks = [(np.zeros(e_pad, np.int32), np.zeros(e_pad, np.int32),
                   np.zeros(e_pad, np.float32))]
    for src, dst, w in blocks:
        got, writes = emulate_ring_block(h, src, dst, w)
        want = np.zeros_like(h, dtype=np.float64)
        np.add.at(want, dst, h[src].astype(np.float64) * w[:, None])
        np.testing.assert_allclose(got, want, atol=1e-5)
        real = dst[w != 0]
        assert writes == max(1, len(np.unique(real)))
