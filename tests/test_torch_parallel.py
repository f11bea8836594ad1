"""The port's sharded TIP-cat step (parallel/, TIP.encode/loss under a
mesh, scripts/sharded.py) against the JAX package and against its own
single-device step, on the CPU.

The port's ranks are four spawned gloo processes running the port's worker
(tip_tpu_torch/scripts/sharded.py:train_rank, which imports no JAX); one
spawn runs every mesh of this file.  JAX runs its sharded encoder on its
virtual CPU mesh (tests/conftest.py).  The graph and widths are
tests/test_parallel.py's.  Tolerances:

  * z, COO ring on the 1-D (4) and 2-D (2x2) meshes: atol 1e-5 (float32 in
    another order, as test_parallel.py's ring tests);
  * z, dense P-P rows: atol 5e-5, test_parallel.py:376's (its layer 2
    rounds a float32 hidden to bf16, where one float32 ulp of difference
    can move a value by one bf16 ulp);
  * the sharded loss and gradients against the port's single-device ones
    under the same sampler draws: rtol 1e-5 (gradients also atol 1e-5 of
    each leaf's largest magnitude: sums over ranks in another order); with
    the dense P-P rows, loss atol 1e-5 (test_parallel.py:376's) and
    gradients atol 1e-2 of each leaf's largest magnitude: the backward of
    the bf16 operand rounding rounds each rank's partial cotangent, where
    one device rounds their sum.  Measured at these shapes: 3.3e-3 of the
    largest magnitude at worst (pp.conv1.weight), 5.0e-7 on the COO ring;
  * remat under the mesh (the "remat" twins of the COO ring on the 1-D
    and the 2x2 mesh and of the dense P-P rows) against the same run
    without it: tests/test_torch_checkpoint.py's remat bounds, loss rtol
    1e-6 and gradients atol 1e-5.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tip_tpu.config import ModelConfig as JModelConfig
from tip_tpu.data import build_trigraph as j_build, synthetic_trigraph as j_raw
from tip_tpu.parallel import add_ring_pp as j_add_ring_pp
from tip_tpu.parallel import make_mesh as j_make_mesh
from tip_tpu.parallel import shard_graph as j_shard_graph
from tip_tpu.parallel.mesh import make_mesh2 as j_make_mesh2, mesh_axes
from tip_tpu.parallel.sharded import mesh_graph_specs, place_graph as j_place
from tip_tpu.train.model import TIP as JTIP
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
from tip_tpu_torch import convert
from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.ops.sampler import draws_per_slot
from tip_tpu_torch.parallel import Mesh, place_graph, shard_graph
from tip_tpu_torch.parallel.sharded import graph_specs
from tip_tpu_torch.scripts import sharded
from tip_tpu_torch.train.model import TIP, fold_seed, make_graph_arrays
from tests import torch_mesh_counts

RAW = dict(n_drug=40, n_prot=70, n_et=5, pairs_per_et=60, seed=8)
SPLIT = dict(split_rate=0.9, seed=8)
PACK = dict(dd_chunk=16, pp_window=64, pp_chunk=32)
WIDTHS = dict(mode="cat", prot_drug_dim=6, n_embed=10, n_hid1=8, n_hid2=6,
              num_base=4, pp_hid1=8, pp_hid2=6)
WORLD = 4
RUNS = (sharded.ShardedRun("coo", n_ring=4, pp="coo", steps=8, probe=True),
        sharded.ShardedRun("2x2", n_ring=2, pp="coo", steps=1, probe=True),
        sharded.ShardedRun("dense", n_ring=4, pp="dense", steps=1, probe=True),
        sharded.ShardedRun("coo remat", n_ring=4, pp="coo", steps=2,
                           probe=True, remat=True),
        sharded.ShardedRun("dense remat", n_ring=4, pp="dense", steps=1,
                           probe=True, remat=True),
        sharded.ShardedRun("2x2 remat", n_ring=2, pp="coo", steps=1,
                           probe=True, remat=True))
REMAT_TWINS = {"coo remat": "coo", "dense remat": "dense", "2x2 remat": "2x2"}


@pytest.fixture(scope="module")
def setup():
    jdata = j_build(j_raw(**RAW), **SPLIT)
    tdata = build_trigraph(synthetic_trigraph(**RAW), **SPLIT)
    jgraph, jgs = j_graph_arrays(jdata, **PACK)
    jmodel = JTIP.for_data(JModelConfig(**WIDTHS), jdata, jgs, backend="xla")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0)))
    return jdata, tdata, jgraph, jgs, jmodel, params


@pytest.fixture(scope="module")
def ranks(setup):
    """{run name: [rank results]} of one spawn of four gloo ranks, and
    under "counts" each rank's calls of the plain versions with and
    without remat (tests/torch_mesh_counts.py)."""
    *_, params = setup
    job = sharded.ShardedJob(runs=RUNS, cfg=ModelConfig(**WIDTHS), raw=RAW,
                             split=SPLIT, pack=PACK, device="cpu",
                             params=params)
    out = sharded.spawn_ranks(torch_mesh_counts.train_and_count_rank, WORLD,
                              job, timeout_s=180)
    res = {run.name: [r[i] for r in out] for i, run in enumerate(RUNS)}
    res["counts"] = [r[-1] for r in out]
    return res


def _jax_sharded_z(setup, n_ring: int, dense_pp: bool):
    jdata, _, jgraph, jgs, jmodel, params = setup
    mesh = j_make_mesh(WORLD) if n_ring == WORLD else j_make_mesh2(
        n_ring, WORLD // n_ring)
    axes, _, n_flat = mesh_axes(mesh)
    sgraph, _ = j_shard_graph(jgraph, jgs, n_flat)
    rgraph, rgs = j_add_ring_pp(sgraph, jdata, jgs, n_ring, dense_pp=dense_pp)
    assert ("pp_a1r" in rgraph) == dense_pp
    rmodel = dataclasses.replace(jmodel, gs=rgs)
    rgraph = j_place(rgraph, mesh)
    return np.asarray(jax.jit(shard_map(
        lambda p, g: rmodel.encode(p, g, axis_name=axes), mesh=mesh,
        in_specs=(P(), mesh_graph_specs(rgraph, mesh)), out_specs=P(),
    ))(jax.tree.map(jnp.asarray, params), rgraph))


@pytest.mark.parametrize("run,n_ring,dense_pp,atol", [
    ("coo", 4, False, 1e-5), ("2x2", 2, False, 1e-5), ("dense", 4, True, 5e-5)])
def test_sharded_z_matches_jax_sharded_z(setup, ranks, run, n_ring, dense_pp,
                                         atol):
    want = _jax_sharded_z(setup, n_ring, dense_pp)
    for r in ranks[run]:  # z is replicated: every rank holds all of it
        np.testing.assert_allclose(r["z"], want, atol=atol)


def _single_device(setup, pp_dense: bool):
    """The port's single-device z, loss and gradients under the probe's
    draws (the unpadded chunk rows of the sharded draws), on the chunked
    D-D layout with the windowed (float32) or dense (bf16 operands) P-P
    side."""
    tdata, params = setup[1], setup[5]
    graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype=None,
                                  pp_dense=pp_dense, **PACK)
    assert gs.pp_layout == ("dense" if pp_dense else "windowed")
    model = TIP.for_data(ModelConfig(**WIDTHS), tdata, gs, device="cpu")
    n_padded = -(-gs.dd_n_chunks // WORLD) * WORLD
    u24 = sharded.probe_draws(sharded.DRAWS_SEED, n_padded,
                              draws_per_slot(gs.n_drug) * gs.dd_chunk)
    tp = convert.params_from_jax(params, requires_grad=True)
    loss = model.loss(tp, graph, seed=0,
                      u24=torch.from_numpy(u24[: gs.dd_n_chunks]))
    loss.backward()
    grads = convert.params_to_numpy(jax.tree.map(
        lambda p: p.grad, tp, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    with torch.no_grad():
        z = model.encode(convert.params_from_jax(params), graph).numpy()
    return loss.item(), grads, z


@pytest.fixture(scope="module")
def single_device(setup):
    return {pp: _single_device(setup, pp == "dense") for pp in ("coo", "dense")}


@pytest.mark.parametrize("run", [r.name for r in RUNS])
def test_sharded_loss_and_grads_match_single_device(ranks, single_device, run):
    """The dense P-P rows against the single-device dense P-P GCN, the COO
    ring against the windowed one."""
    pp = ranks[run][0]["pp"]
    loss, grads, _ = single_device[pp]
    for r in ranks[run]:
        got = jax.tree_util.tree_leaves_with_path(r["probe_grads"])
        want = jax.tree.leaves(grads)
        assert len(got) == len(want)
        if pp == "dense":
            assert abs(r["probe_loss"] - loss) < 1e-5
        else:
            np.testing.assert_allclose(r["probe_loss"], loss, rtol=1e-5)
        for (path, g), w in zip(got, want):
            scale = 1e-2 if pp == "dense" else 1e-5
            tol = dict(rtol=1e-5, atol=scale * np.abs(w).max())
            np.testing.assert_allclose(g, w, err_msg=f"{run} {path}", **tol)


def test_sharded_coo_z_matches_single_device_z(ranks, single_device):
    np.testing.assert_allclose(ranks["coo"][0]["z"], single_device["coo"][2],
                               atol=1e-5)


@pytest.mark.parametrize("twin,base", REMAT_TWINS.items())
def test_remat_under_the_mesh_matches_no_remat(ranks, twin, base):
    """The probe's loss and gradients with remat (the encoder recomputed
    in the backward, its collectives and ring steps too) against the same
    run's without it, on every rank, and the first step's loss;
    test_sharded_loss_and_grads_match_single_device holds the twin against
    the single-device reference under its own bounds."""
    for r, b in zip(ranks[twin], ranks[base]):
        assert r["remat"] and not b["remat"] and r["rank"] == b["rank"]
        np.testing.assert_allclose(r["probe_loss"], b["probe_loss"],
                                   rtol=1e-6)
        got = jax.tree_util.tree_leaves_with_path(r["probe_grads"])
        want = jax.tree.leaves(b["probe_grads"])
        assert len(got) == len(want)
        for (path, g), w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5,
                                       err_msg=f"{twin} {path}")
        np.testing.assert_allclose(r["losses"][0], b["losses"][0], rtol=1e-6)


def test_remat_under_the_mesh_recomputes_the_encoder(ranks):
    """On each of the four ranks (the 1-D COO ring): without remat the
    forward calls B4's forward and the ring SpMM twice (two layers) and
    sums over the ranks four times (the two R-GCN layers' aggregates, the
    hierarchy's, the loss), and the backward adds the ring's backward twice
    and the four sums' backwards; with remat the backward runs the whole
    encoder again first, its collectives included: B4's forward and the
    ring SpMM twice more and the encoder's three sums again."""
    plain = ({"tns_fwd": 2, "ring_spmm": 2, "all_reduce": 4},
             {"tns_fwd": 2, "ring_spmm": 4, "all_reduce": 8})
    remat = ({"tns_fwd": 2, "ring_spmm": 2, "all_reduce": 4},
             {"tns_fwd": 4, "ring_spmm": 6, "all_reduce": 11})
    for counts in ranks["counts"]:
        assert counts == {False: plain, True: remat}


@pytest.mark.parametrize("run", [r.name for r in RUNS])
def test_params_identical_on_every_rank_after_each_step(ranks, run):
    digests = [r["digests"] for r in ranks[run]]
    assert len(digests[0]) == {r.name: r.steps for r in RUNS}[run]
    assert all(d == digests[0] for d in digests)
    losses = [r["losses"] for r in ranks[run]]
    assert all(x == losses[0] for x in losses)  # the loss is replicated


@pytest.mark.parametrize("run", [r.name for r in RUNS])
def test_the_loss_folds_the_rank_into_the_sampler_seed(ranks, run):
    """Each rank's loss under the step seed equals its loss under the
    hashed draws of fold_seed(seed, rank) passed in, and the ranks' folded
    seeds differ."""
    for r in ranks[run]:
        hashed, passed = r["fold_losses"]
        assert hashed == passed
    assert len({fold_seed(0, rank) for rank in range(WORLD)}) == WORLD


def test_eight_sharded_steps_lower_the_loss(ranks):
    """As tests/test_parallel.py:172 (the ring training step runs)."""
    r0 = ranks["coo"][0]
    losses = r0["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    # under the same draws, as __graft_entry__.py's fixed-key probe
    assert r0["probe_loss_after"] < r0["probe_loss"]


def test_rank0_evaluates_unsharded(ranks, setup):
    n_et = setup[1].n_et
    r0 = ranks["coo"][0]
    for k in ("auprc", "auroc", "ap"):
        assert 0.0 <= r0["final"][k] <= 1.0
        assert r0["per_relation"][k].shape == (n_et,)
    assert all("final" not in r for r in ranks["coo"][1:])
    # CPU tensors: the plain versions, no kernel launched
    assert all(not any(r["launches"].values()) for r in ranks["coo"])


def test_ring_layout_of_each_mesh(ranks):
    assert [r["ring_rank"] for r in ranks["coo"]] == [0, 1, 2, 3]
    # (ring, edges) = (2, 2): rank r sits at (r // 2, r % 2)
    assert [r["ring_rank"] for r in ranks["2x2"]] == [0, 0, 1, 1]
    assert {r["dd_n_chunks"] % WORLD for r in ranks["coo"]} == {0}


def test_cli_remat_trains(monkeypatch):
    """``--cpu --synthetic --remat``: the Decagon-shaped graph is swapped
    for this file's small one (the job the CLI hands the ranks carries the
    shape); four ranks train two remat steps at published widths and
    agree."""
    monkeypatch.setattr(sharded, "DECAGON_SHAPE", RAW)
    monkeypatch.setattr(sharded, "spawn_ranks", functools.partial(
        sharded.spawn_ranks, timeout_s=180))
    lines = sharded.main(["--cpu", "--synthetic", "--remat", "--steps", "2"])
    assert [r["rank"] for r in lines] == list(range(WORLD))
    for r in lines:
        assert r["name"] == "tip sharded coo remat" and r["remat"]
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
        assert r["losses"] == lines[0]["losses"]
    assert 0.0 <= lines[0]["final"]["auroc"] <= 1.0


def test_failing_ranks_raise_and_stop(setup):
    """A ring of 3 does not divide 4 ranks: every rank raises; the launcher
    kills the ranks and raises instead of waiting on them."""
    job = sharded.ShardedJob(runs=(sharded.ShardedRun("bad", n_ring=3),),
                             cfg=ModelConfig(**WIDTHS), raw=RAW, split=SPLIT,
                             pack=PACK, device="cpu")
    with pytest.raises(RuntimeError, match="does not divide"):
        sharded.spawn_ranks(sharded.train_rank, WORLD, job, timeout_s=60)


def test_shard_graph_padding_is_inert_and_place_graph_splits(setup):
    """As tests/test_parallel.py's padding test; each rank's view holds its
    block of the chunk axis and of the ring axis."""
    from tip_tpu_torch.parallel import add_ring_pp

    _, tdata, *_ = setup
    graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16", **PACK,
                                  sampled=True)
    sgraph, sgs = shard_graph(graph, gs, WORLD)
    assert sgs.dd_layout == "chunked" and sgs.dd_n_chunks % WORLD == 0
    assert not {"dd_adj_sym", "dd_adj_t", "pp_a1"} & set(sgraph)
    n_orig = graph["dd_src2d"].shape[0]
    assert bool((sgraph["dd_dst2d"][n_orig:] == gs.n_drug).all())
    assert bool((sgraph["dd_chunk_type"][n_orig:] == gs.n_et - 1).all())
    assert float(sgraph["dd_valid"].sum()) == float(graph["dd_valid"].sum())
    rgraph, rgs = add_ring_pp(sgraph, tdata, sgs, 2, dense_pp=False)
    assert rgs.pp_ring_shards == 2 and "pp_a1r" not in rgraph
    # the ring's buffers replace the replicated P-P and P->D ones
    assert rgs.pp_layout == "none" and "dp_deg" in rgraph
    assert not {"ppw_src", "ppw_w", "pp_dinv", "dp_src", "dp_dst"} & set(rgraph)
    specs = graph_specs(rgraph)
    assert specs["ppr_src"] == "ring" and specs["dd_src2d"] == "edges"
    assert specs["dd_bitmap"] is None
    m = sgs.dd_n_chunks // WORLD
    for rank in range(WORLD):
        mesh = Mesh(axis_names=("ring", "edges"), rank=rank, world=WORLD,
                    n_ring=2, ring_rank=rank // 2)
        view = place_graph(rgraph, mesh)
        assert torch.equal(view["dd_src2d"],
                           sgraph["dd_src2d"][rank * m:(rank + 1) * m])
        assert torch.equal(view["ppr_w"], rgraph["ppr_w"][rank // 2:rank // 2 + 1])
        assert torch.equal(view["dd_bitmap"], rgraph["dd_bitmap"])


def test_mesh_runs_only_the_chunked_layout(setup):
    _, tdata, *_ = setup
    graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16", **PACK)
    with pytest.raises(ValueError, match="chunk-aligned"):
        shard_graph(graph, gs, WORLD)
    model = TIP.for_data(ModelConfig(**WIDTHS), tdata, gs, device="cpu")
    mesh = Mesh(axis_names=("edges",), rank=0, world=1, n_ring=1, ring_rank=0)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="chunked D-D layout"):
        model.encode(params, graph, mesh)
