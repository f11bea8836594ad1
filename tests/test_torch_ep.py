"""The port's relation-partitioned (EP) sharding (parallel/ep.py, the EP
branches of nn/rgcn.py, nn/encoders.py, train/model.py and
scripts/sharded.py) against the JAX package and against the port's own
single-process model, on the CPU.

The host re-layout (``partition_relations``, ``ep_shard_graph`` on the
chunked, pages and strips layouts, ``ep_params``/``unep_params``) must be
the JAX package's bit for bit.  The sharded runs are four spawned gloo
ranks running the port's worker (tip_tpu_torch/scripts/sharded.py:
train_rank, which imports no JAX); one module-scoped spawn runs every EP
run of this file.  JAX runs its EP encoders on its virtual CPU mesh
(tests/conftest.py).  The graph and widths are tests/test_parallel.py's,
and so are the tolerances of the EP tests ported from it:

  * the sharded loss against the single-process one: 2e-5
    (test_parallel.py:465; 1e-5 at :376 for the float32 pages);
  * the un-EP'd sharded gradients: atol 1e-4 (:465; 5e-5 at :376);
  * z against the replicated encode: atol 1e-5 (:197) on the float32
    layouts; on the strips, whose M-first pair rounds each rank's partial
    M to bf16 where one device rounds their sum (so does the JAX
    package's), z against the JAX package's own EP-sharded z: atol 5e-5,
    tests/test_torch_parallel.py's tolerance for bf16 operands;
  * the unsharded EP eval against the plain one: metrics atol 1e-6,
    per-relation AUPRC 1e-5 (:534).
"""

import dataclasses

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
from tip_tpu.parallel import ep_param_specs as j_ep_param_specs
from tip_tpu.parallel import ep_params as j_ep_params
from tip_tpu.parallel import ep_shard_graph as j_ep_shard_graph
from tip_tpu.parallel import make_mesh as j_make_mesh
from tip_tpu.parallel import partition_relations as j_partition
from tip_tpu.parallel import place_params as j_place_params
from tip_tpu.parallel import shard_graph as j_shard_graph
from tip_tpu.parallel import unep_params as j_unep_params
from tip_tpu.parallel.mesh import make_mesh2 as j_make_mesh2, mesh_axes
from tip_tpu.parallel.sharded import mesh_graph_specs, place_graph as j_place
from tip_tpu.train.model import TIP as JTIP
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
from tip_tpu.train.model import make_test_arrays as j_test_arrays
from tip_tpu_torch import convert
from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.ops.sampler import draws_per_slot
from tip_tpu_torch.parallel import (
    Mesh,
    ep_params,
    ep_shard_graph,
    partition_relations,
    place_graph,
    shard_graph,
    unep_params,
)
from tip_tpu_torch.parallel.ep import local_bins
from tip_tpu_torch.parallel.sharded import average_grads, graph_specs
from tip_tpu_torch.scripts import sharded
from tip_tpu_torch.train.model import TIP, make_graph_arrays, make_test_arrays

RAW = dict(n_drug=40, n_prot=70, n_et=5, pairs_per_et=60, seed=8)
SPLIT = dict(split_rate=0.9, seed=8)
PACK = dict(dd_chunk=16, pp_window=64, pp_chunk=32)
WIDTHS = dict(mode="cat", prot_drug_dim=6, n_embed=10, n_hid1=8, n_hid2=6,
              num_base=4, pp_hid1=8, pp_hid2=6)
WORLD = 4
Run = sharded.ShardedRun
RUNS = (
    Run("strips", n_ring=4, pp="dense", steps=4, probe=True, ep=True,
        layout="strips"),
    Run("2x2", n_ring=2, pp="coo", steps=1, probe=True, ep=True,
        layout="strips"),
    Run("pages", n_ring=4, pp="coo", steps=4, probe=True, ep=True,
        layout="pages"),
    Run("chunked", n_ring=4, pp="coo", steps=8, probe=True, ep=True),
    Run("nn", n_ring=4, pp="dense", steps=8, probe=True, ep=True,
        decoder="nn"),
)
BY_NAME = {r.name: r for r in RUNS}
DTYPE = sharded.LAYOUT_DTYPE


@pytest.fixture(scope="module")
def setup():
    jdata = j_build(j_raw(**RAW), **SPLIT)
    tdata = build_trigraph(synthetic_trigraph(**RAW), **SPLIT)
    return jdata, tdata


def _padded_chunks(jdata, dense_dtype):
    jgraph, jgs = j_graph_arrays(jdata, dense_dtype=dense_dtype, **PACK)
    sgraph, _ = j_shard_graph(jgraph, jgs, WORLD)
    return jgraph, jgs, sgraph


# ---------------------------------------------------------------------------
# host re-layout: bit-identical to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
def test_partition_relations_is_bit_identical(setup, n_dev):
    jgraph, jgs, sgraph = _padded_chunks(setup[0], None)
    ct = np.asarray(sgraph["dd_chunk_type"])
    want = j_partition(ct, jgs.n_et, n_dev)
    got = partition_relations(ct, jgs.n_et, n_dev)
    for f in ("dev_of_rel", "local_id", "slot"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.r_max, got.n_dev) == (want.r_max, want.n_dev)


def _torch_of(x):
    """A JAX array as a tensor of the same bits (bf16 through int16)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("layout,dense_dtype", [
    ("chunked", None), ("pages", "float32"), ("pages bf16", "bfloat16"),
    ("strips", "bfloat16")])
def test_ep_shard_graph_is_bit_identical(setup, layout, dense_dtype):
    jgraph, jgs, sgraph = _padded_chunks(setup[0], dense_dtype)
    part = j_partition(np.asarray(sgraph["dd_chunk_type"]), jgs.n_et, WORLD)
    pages = {}
    if layout.startswith("pages"):
        pages = dict(dense_adj=jgraph["dd_adj_t"], neg_q=jgraph["dd_neg_q"])
    elif layout == "strips":
        pages = dict(sym_pages=jgraph["dd_adj_sym"],
                     neg_q8=jgraph["dd_neg_q8"])
    want, wgs = j_ep_shard_graph(sgraph, jgs, part, **pages)
    keys = ("dd_src2d", "dd_dst2d", "dd_chunk_type", "dd_valid")
    from tip_tpu_torch.train.model import GraphStatic

    tgs = GraphStatic(n_drug=jgs.n_drug, n_prot=jgs.n_prot, n_et=jgs.n_et,
                      dd_n_valid=jgs.dd_n_valid, dd_chunk=jgs.dd_chunk,
                      dd_n_chunks=int(sgraph["dd_chunk_type"].shape[0]),
                      dd_layout="chunked")
    got, ggs = ep_shard_graph({k: _torch_of(sgraph[k]) for k in keys}, tgs,
                              partition_relations(
                                  np.asarray(sgraph["dd_chunk_type"]),
                                  jgs.n_et, WORLD),
                              **{k: _torch_of(v) for k, v in pages.items()})
    ep_keys = {k for k in want if k.startswith(("dd_", "ep_"))} - {
        "dd_deg", "dd_bitmap"}
    assert set(got) == ep_keys
    for k in ep_keys:
        a, b = _bits(want[k]), _bits(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert (ggs.dd_n_chunks, ggs.ep_r_max) == (wgs.dd_n_chunks, wgs.ep_r_max)
    assert ggs.dd_layout == layout.split()[0]
    # numpy pages in, the same bits out
    if layout in ("pages", "strips"):
        again, _ = ep_shard_graph({k: _torch_of(sgraph[k]) for k in keys},
                                  tgs, partition_relations(
                                      np.asarray(sgraph["dd_chunk_type"]),
                                      jgs.n_et, WORLD),
                                  **{k: np.asarray(v) for k, v in pages.items()})
        for k in ep_keys:
            assert np.array_equal(_bits(again[k]), _bits(got[k])), k


@pytest.mark.parametrize("decoder", ["distmult", "nn"])
def test_ep_params_are_bit_identical_and_round_trip(setup, decoder):
    jdata = setup[0]
    jgraph, jgs, sgraph = _padded_chunks(jdata, None)
    cfg = JModelConfig(**WIDTHS, decoder=decoder, nn_decoder_l1_dim=5)
    params = jax.tree.map(np.asarray, JTIP.for_data(
        cfg, jdata, jgs, backend="xla").init(jax.random.key(11)))
    ct = np.asarray(sgraph["dd_chunk_type"])
    jpart, part = j_partition(ct, jgs.n_et, WORLD), partition_relations(
        ct, jgs.n_et, WORLD)
    want = jax.tree.map(np.asarray, j_ep_params(params, jpart))
    got = ep_params(params, part)  # numpy leaves
    got_t = convert.params_to_numpy(ep_params(
        convert.params_from_jax(params), part))  # tensor leaves
    for (path, a), b, c in zip(jax.tree_util.tree_leaves_with_path(want),
                               jax.tree.leaves(got), jax.tree.leaves(got_t)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
        assert np.array_equal(a, c), path
    back = unep_params(got, part)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    jback = jax.tree.map(np.asarray, j_unep_params(want, jpart))
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_local_bins_are_runs_in_chunk_order():
    lt = np.array([2, 2, 0, 1, 1, 0, 0], np.int32)  # the last two: pads
    valid = np.ones((7, 4), np.float32)
    valid[5:] = 0
    bins, rel = local_bins(lt, valid, 4)
    assert bins.tolist() == [0, 0, 1, 2, 2, 2, 2]
    assert rel.tolist() == [2, 0, 1, 3]
    with pytest.raises(ValueError, match="one run"):
        local_bins(np.array([0, 1, 0], np.int32), np.ones((3, 2)), 2)


# ---------------------------------------------------------------------------
# the sharded runs: four gloo ranks, one spawn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(setup):
    """{run name: [rank results]} of one spawn of four gloo ranks."""
    job = sharded.ShardedJob(runs=RUNS, cfg=ModelConfig(**WIDTHS), raw=RAW,
                             split=SPLIT, pack=PACK, device="cpu")
    out = sharded.spawn_ranks(sharded.train_rank, WORLD, job, timeout_s=300)
    return {run.name: [r[i] for r in out] for i, run in enumerate(RUNS)}


def _port_params(tdata, gs, decoder):
    """The parameters the ranks start from (their init from SEED), whole."""
    cfg = ModelConfig(**WIDTHS, decoder=decoder)
    return TIP(cfg, gs, torch.device("cpu")).init(
        torch.Generator().manual_seed(sharded.SEED))


def _single_process(tdata, run):
    """The port's single-process z, loss and gradients for ``run``: the
    same layout and P-P side, its thresholds zeroed on the fused routes,
    the probe's draws (re-ordered from the EP chunk order) on the sampled
    ones."""
    cfg = ModelConfig(**WIDTHS, decoder=run.decoder)
    graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype=DTYPE[run.layout],
                                  pp_dense=run.pp == "dense",
                                  decoder=run.decoder, **PACK)
    model = TIP.for_data(cfg, tdata, gs, device="cpu")
    params = _port_params(tdata, gs, run.decoder)
    for p in convert.leaves(params):
        p.requires_grad_(True)
    u24 = None
    if sharded.sampled_route(cfg, gs):
        order = sharded.ep_order(tdata, WORLD, gs.dd_chunk)
        width = draws_per_slot(gs.n_drug) * gs.dd_chunk
        draws = sharded.probe_draws(sharded.DRAWS_SEED, order.shape[0], width)
        u24 = torch.from_numpy(sharded.reference_draws(draws, order,
                                                       gs.dd_n_chunks))
    else:
        graph = sharded.zero_thresholds(graph)
    loss = model.loss(params, graph, seed=0, u24=u24)
    loss.backward()
    grads = [p.grad.numpy() for p in convert.leaves(params)]
    with torch.no_grad():
        z = model.encode(params, graph).numpy()
    return loss.item(), grads, z, convert.params_to_numpy(params)


@pytest.fixture(scope="module")
def single(setup):
    return {run.name: _single_process(setup[1], run) for run in RUNS}


def _jax_ep_sharded_z(jdata, params, run):
    """The JAX package's EP-sharded encode of ``run``'s layout and mesh."""
    jgraph, jgs = j_graph_arrays(jdata, dense_dtype=DTYPE[run.layout],
                                 pp_dense=run.pp == "dense", **PACK)
    jmodel = JTIP.for_data(JModelConfig(**WIDTHS), jdata, jgs, backend="xla")
    mesh = (j_make_mesh(WORLD) if run.n_ring == WORLD
            else j_make_mesh2(run.n_ring, WORLD // run.n_ring))
    axes, _, n_flat = mesh_axes(mesh)
    sgraph, _ = j_shard_graph(jgraph, jgs, n_flat)
    rgraph, rgs = j_add_ring_pp(sgraph, jdata, jgs, run.n_ring,
                                dense_pp=run.pp == "dense")
    part = j_partition(np.asarray(rgraph["dd_chunk_type"]), rgs.n_et, n_flat)
    egraph, egs = j_ep_shard_graph(
        rgraph, rgs, part, dense_adj=jgraph.get("dd_adj_t"),
        neg_q=jgraph.get("dd_neg_q"), sym_pages=jgraph.get("dd_adj_sym"),
        neg_q8=jgraph.get("dd_neg_q8"))
    smodel = dataclasses.replace(jmodel, gs=egs)
    epp = j_ep_params(jax.tree.map(jnp.asarray, params), part)
    pspecs = j_ep_param_specs(epp, axes)
    egraph_p = j_place(egraph, mesh)
    return np.asarray(jax.jit(shard_map(
        lambda p, g: smodel.encode(p, g, axis_name=axes), mesh=mesh,
        in_specs=(pspecs, mesh_graph_specs(egraph_p, mesh)), out_specs=P(),
    ))(j_place_params(epp, mesh, pspecs), egraph_p))


def _check_grads(r, grads, atol):
    got = jax.tree_util.tree_leaves_with_path(r["probe_grads"])
    assert len(got) == len(grads)
    for (path, g), w in zip(got, grads):
        np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{r['name']} "
                                   f"rank {r['rank']} {path}")


def test_ep_sharding_matches_replicated(setup, ranks, single):
    """As tests/test_parallel.py:197 on the chunked layout: the EP-sharded
    encode equals the replicated one (the port's and the JAX package's);
    the un-EP'd round trip is exact (test_ep_params_...); the unsharded EP
    encode (slot gather) equals the replicated encode."""
    jdata, tdata = setup
    for name in ("chunked", "pages"):
        run = BY_NAME[name]
        _, _, z, params = single[name]
        jgraph, jgs = j_graph_arrays(jdata, dense_dtype=DTYPE[run.layout],
                                     pp_dense=run.pp == "dense", **PACK)
        jmodel = JTIP.for_data(JModelConfig(**WIDTHS), jdata, jgs,
                               backend="xla")
        z_jax = np.asarray(jmodel.encode(jax.tree.map(jnp.asarray, params),
                                         jgraph))
        np.testing.assert_allclose(z, z_jax, atol=1e-5)
        for r in ranks[name]:  # z is replicated: every rank holds all of it
            np.testing.assert_allclose(r["z"], z, atol=1e-5)
            np.testing.assert_allclose(r["z"], z_jax, atol=1e-5)
    # the unsharded EP encode of the chunked layout (att gathered by slot)
    run = BY_NAME["chunked"]
    eg = sharded.ep_graphs(tdata, run, WORLD, PACK)
    tparams = convert.params_from_jax(single["chunked"][3])
    eval_graph, eval_gs = eg.eval_graph()
    emodel = TIP(ModelConfig(**WIDTHS), eval_gs, torch.device("cpu"))
    with torch.no_grad():
        z_ep = emodel.encode(ep_params(tparams, eg.part), eval_graph)
    np.testing.assert_allclose(z_ep.numpy(), single["chunked"][2], atol=1e-5)


@pytest.mark.parametrize("decoder", ["distmult", "nn"])
def test_unsharded_ep_loss_matches_replicated(setup, decoder):
    """An EP graph's loss without a mesh (the JAX package's unsharded EP
    branch: the sampled route, rows gathered back by slot, the chunks in
    relation order) equals the replicated loss under the same draws: in
    relation order the EP chunks are the graph's, then inert pads."""
    tdata = setup[1]
    run = Run("one", n_ring=WORLD, ep=True, decoder=decoder)
    cfg = ModelConfig(**WIDTHS, decoder=decoder)
    eg = sharded.ep_graphs(tdata, run, WORLD, PACK)
    graph, gs = eg.base, eg.base_gs
    model = TIP.for_data(cfg, tdata, gs, device="cpu")
    params = _port_params(tdata, gs, decoder)
    width = draws_per_slot(gs.n_drug) * gs.dd_chunk
    u24 = torch.from_numpy(sharded.probe_draws(1, gs.dd_n_chunks, width))
    want = model.loss(params, graph, seed=0, u24=u24)
    eval_graph, eval_gs = eg.eval_graph()
    n_pad = eval_gs.dd_n_chunks - gs.dd_n_chunks
    got = TIP(cfg, eval_gs, torch.device("cpu")).loss(
        ep_params(params, eg.part), eval_graph, seed=0,
        u24=torch.cat([u24, torch.zeros((n_pad,) + u24.shape[1:],
                                        dtype=u24.dtype)]))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


@pytest.mark.parametrize("name", ["strips", "2x2"])
def test_sym_strips_z_matches_jax_ep_sharded_z(setup, ranks, single, name):
    want = _jax_ep_sharded_z(setup[0], single[name][3], BY_NAME[name])
    for r in ranks[name]:
        np.testing.assert_allclose(r["z"], want, atol=5e-5)


@pytest.mark.parametrize("name", ["strips", "2x2"])
def test_sym_sharded_parity(ranks, single, name):
    """tests/test_parallel.py:465 ("1d" the 1-D mesh with the dense P-P
    rows, "2x2" the (ring 2, edges 2) mesh with the COO ring): the
    EP-sharded loss on the strips with zeroed thresholds and its un-EP'd
    gradients against the single-process ones."""
    loss, grads, _, _ = single[name]
    for r in ranks[name]:
        assert r["layout"] == "strips" and r["r_max"] > 0
        assert abs(r["probe_loss"] - loss) < 2e-5, (r["probe_loss"], loss)
        _check_grads(r, grads, 1e-4)


def test_dense_sharded_parity_and_training(ranks, single):
    """tests/test_parallel.py:376 on the float32 pages: loss within 1e-5
    and gradients within 5e-5 of the single-process ones (zeroed
    thresholds), then the fixed-seed loss with live Poisson negatives
    falls over the run's steps."""
    loss, grads, _, _ = single["pages"]
    for r in ranks["pages"]:
        assert r["layout"] == "pages"
        assert abs(r["probe_loss"] - loss) < 1e-5
        _check_grads(r, grads, 5e-5)
    r0 = ranks["pages"][0]
    assert np.isfinite([r0["live_loss"], r0["live_loss_after"]]).all()
    assert r0["live_loss_after"] < r0["live_loss"]


@pytest.mark.parametrize("name", ["chunked", "nn"])
def test_ep_sampled_route_parity(ranks, single, name):
    """The sampled route under EP (B10 on global ids, B4 with R = r_max, B8
    or B9 on local rows): the loss under the same draws and the un-EP'd
    gradients against the single-process ones; the COO ring in float32
    to 1e-5, the dense P-P rows (bf16 operands) to
    tests/test_torch_parallel.py's 1e-2 of each leaf's largest
    magnitude."""
    loss, grads, _, _ = single[name]
    for r in ranks[name]:
        if r["pp"] == "coo":
            np.testing.assert_allclose(r["probe_loss"], loss, rtol=1e-5)
            _check_grads(r, grads, 1e-4)
        else:
            assert abs(r["probe_loss"] - loss) < 2e-5
            for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(
                    r["probe_grads"]), grads):
                np.testing.assert_allclose(
                    g, w, rtol=1e-5, atol=1e-2 * np.abs(w).max(),
                    err_msg=f"{name} {path}")
        hashed, passed = r["fold_losses"]
        assert hashed == passed


@pytest.mark.parametrize("name", ["chunked", "nn"])
def test_ep_training_step_runs(ranks, name):
    """tests/test_parallel.py:241 (DistMult) and :280 (the NN decoder):
    the EP-sharded step trains, the fixed-draw loss falls, and the
    replicated parameters and the losses are the same on every rank."""
    r0 = ranks[name][0]
    losses = r0["losses"]
    assert len(losses) == BY_NAME[name].steps and np.isfinite(losses).all()
    assert r0["probe_loss_after"] < r0["probe_loss"]
    assert all(r["losses"] == losses and r["digests"] == r0["digests"]
               for r in ranks[name])


@pytest.mark.parametrize("name", [r.name for r in RUNS])
def test_every_rank_agrees_and_rank0_evaluates(ranks, setup, name):
    rs = ranks[name]
    assert all(r["digests"] == rs[0]["digests"] for r in rs)
    assert all(r["losses"] == rs[0]["losses"] for r in rs)
    assert rs[0]["r_max"] > 0 and rs[0]["dd_n_chunks"] % WORLD == 0
    for k in ("auprc", "auroc", "ap"):
        assert 0.0 <= rs[0]["final"][k] <= 1.0
        assert rs[0]["per_relation"][k].shape == (setup[1].n_et,)
    assert all("final" not in r for r in rs[1:])
    # CPU tensors: the plain versions, no kernel launched
    assert all(not any(r["launches"].values()) for r in rs)


# ---------------------------------------------------------------------------
# the unsharded EP eval, in this process
# ---------------------------------------------------------------------------


def _evals(setup, layout, decoder, pp_dense):
    """(plain, EP, JAX EP) evaluate of the same parameters and test
    negatives: the port's replicated model, the port's EP model on the
    re-laid unsharded graph, the JAX package's EP model on its own."""
    jdata, tdata = setup
    run = Run("eval", n_ring=WORLD, pp="dense" if pp_dense else "coo",
              ep=True, layout=layout, decoder=decoder)
    cfg = ModelConfig(**WIDTHS, decoder=decoder)
    graph, gs = make_graph_arrays(tdata, "cpu", dense_dtype=DTYPE[layout],
                                  pp_dense=pp_dense, decoder=decoder, **PACK)
    model = TIP.for_data(cfg, tdata, gs, device="cpu")
    params = _port_params(tdata, gs, decoder)
    test = make_test_arrays(tdata, "cpu")
    test_neg = model.sample_test_negatives(torch.Generator().manual_seed(6),
                                           test)
    plain = model.evaluate(params, graph, test, test_neg)
    eg = sharded.ep_graphs(tdata, run, WORLD, PACK)
    eval_graph, eval_gs = eg.eval_graph()
    emodel = TIP(cfg, eval_gs, torch.device("cpu"))
    ep = emodel.evaluate(ep_params(params, eg.part), eval_graph, test,
                         test_neg)
    jgraph, jgs = j_graph_arrays(jdata, dense_dtype=DTYPE[layout],
                                 pp_dense=pp_dense, **PACK)
    jcfg = JModelConfig(**WIDTHS, decoder=decoder)
    jmodel = JTIP.for_data(jcfg, jdata, jgs, backend="xla")
    sgraph, _ = j_shard_graph(jgraph, jgs, WORLD)
    part = j_partition(np.asarray(sgraph["dd_chunk_type"]), jgs.n_et, WORLD)
    jegraph, jegs = j_ep_shard_graph(
        jgraph, jgs, part, dense_adj=jgraph.get("dd_adj_t"),
        neg_q=jgraph.get("dd_neg_q"), sym_pages=jgraph.get("dd_adj_sym"),
        neg_q8=jgraph.get("dd_neg_q8"))
    jparams = j_ep_params(jax.tree.map(
        jnp.asarray, convert.params_to_numpy(params)), part)
    jtest = j_test_arrays(jdata)
    jneg = {k: jnp.asarray(v.numpy().astype(np.int32))
            for k, v in test_neg.items()}
    jep = dataclasses.replace(jmodel, gs=jegs).evaluate(jparams, jegraph,
                                                        jtest, jneg)
    return plain, ep, jep


def _same_metrics(a, b, atol):
    for k in a[1]:
        np.testing.assert_allclose(float(a[1][k]), float(b[1][k]), atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(np.asarray(a[0]["auprc"]),
                               np.asarray(b[0]["auprc"]), atol=1e-5)


@pytest.mark.parametrize("layout", ["strips", "pages"])
def test_ep_unsharded_dense_eval_matches_plain(setup, layout):
    """tests/test_parallel.py:534: the unsharded EP eval rides the
    slot-ordered strips (or pages) and equals the replicated eval, and
    the JAX package's EP eval of the same parameters and negatives."""
    plain, ep, jep = _evals(setup, layout, "distmult", pp_dense=True)
    _same_metrics(plain, ep, 1e-6)
    _same_metrics(ep, jep, 1e-6)


def test_ep_nn_decoder_unsharded_eval_matches_plain(setup):
    """tests/test_parallel.py:280's eval half: the NN decoder's relation
    rows gathered back through the slot table, on the chunked layout."""
    plain, ep, jep = _evals(setup, "chunked", "nn", pp_dense=False)
    _same_metrics(plain, ep, 1e-6)
    _same_metrics(ep, jep, 1e-6)


def test_average_grads_scales_rank_local_leaves_without_summing():
    """A world of one: the replicated leaves' sum is themselves; the
    EP leaf's gradient is divided by the world and never reduced."""
    import os
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "rdv"), rank=0, world_size=1)
        try:
            mesh = Mesh(axis_names=("edges",), rank=0, world=1, n_ring=1,
                        ring_rank=0)
            params = {"decoder": {"weight": torch.ones(1, 2, 3,
                                                       requires_grad=True)},
                      "encoder": {"root": torch.ones(2, requires_grad=True)}}
            specs = {"decoder": {"weight": "edges"},
                     "encoder": {"root": None}}
            (params["decoder"]["weight"].sum() * 3
             + params["encoder"]["root"].sum() * 5).backward()
            average_grads(params, mesh, specs)
            assert torch.equal(params["decoder"]["weight"].grad,
                               torch.full((1, 2, 3), 3.0))
            assert torch.equal(params["encoder"]["root"].grad,
                               torch.full((2,), 5.0))
        finally:
            dist.destroy_process_group()


def test_shard_graph_keeps_ep_pages_and_specs_ride_the_chunk_axis(setup):
    tdata = setup[1]
    eg = sharded.ep_graphs(tdata, BY_NAME["strips"], WORLD, PACK)
    g, gs = shard_graph(eg.host, eg.gs, WORLD)
    assert gs.dd_layout == "strips" and "dd_adj_sym" in g
    specs = graph_specs(g)
    for k in ("dd_adj_sym", "dd_neg_q8", "dd_chunk_type_local"):
        assert specs[k] == "edges", k
    r_max = gs.ep_r_max
    assert g["dd_adj_sym"].shape[0] == WORLD * r_max
    mesh = Mesh(axis_names=("edges",), rank=1, world=WORLD, n_ring=WORLD,
                ring_rank=1)
    view = place_graph(g, mesh, gs)
    assert torch.equal(view["dd_adj_sym"], g["dd_adj_sym"][r_max:2 * r_max])
    assert view["dd_chunk_bin"].shape == view["dd_chunk_type_local"].shape
    assert bool((view["dd_chunk_bin"][1:] >= view["dd_chunk_bin"][:-1]).all())
    # a replicated dense graph under a mesh still raises
    graph, rgs = make_graph_arrays(tdata, "cpu", dense_dtype="bfloat16",
                                   **PACK)
    model = TIP.for_data(ModelConfig(**WIDTHS), tdata, rgs, device="cpu")
    one = Mesh(axis_names=("edges",), rank=0, world=1, n_ring=1, ring_rank=0)
    with pytest.raises(ValueError, match="partitioned by relation"):
        model.encode(model.init(torch.Generator().manual_seed(0)), graph, one)
