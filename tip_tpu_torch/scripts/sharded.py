"""Sharded TIP-cat training over k ranks of ``torch.distributed`` (port of
__graft_entry__.py:dryrun_multichip / _dryrun_on_mesh, and of
scripts/sharded_train_real.py's relation-partitioned dense stack).

    python -m tip_tpu_torch.scripts.sharded --ranks 4 [--mesh 2x2]
        [--pp coo|dense] [--ep] [--layout strips|pages|chunked]
        [--decoder distmult|nn] [--steps N] [--cpu] [--synthetic]
        [--data-dir DIR]

Spawns ``--ranks`` processes (gloo, ``file://`` rendezvous in a temporary
directory), each driving ``cuda:(rank % device_count)`` (or the CPU with
``--cpu``; without a GPU and without ``--cpu`` it stops with an error), so
k ranks share one card where the machine has one.  Each rank packs the
graph chunked, keeps its shard (parallel/sharded.py), trains TIP-cat at
published widths for ``--steps`` Adam steps: edge-chunk sharding (kernels
B10, B8, B4 on its chunks) plus the protein-row ring P-P GCN on the
``ring`` axis, COO (kernel B11) or dense row blocks (``--pp dense``).
``--mesh RxE`` lays the ranks out as (ring, edges) = (R, E); the default is
the 1-D mesh.  ``--ep`` partitions the relations over the ranks
(parallel/ep.py): each rank keeps its relations' chunks, its block of the
dense strips (``--layout strips``: kernel B1 on the block) or float32
pages (``--layout pages``: B2), and its rows of ``att`` and of the
decoder; ``--layout chunked`` (the default) bins its chunks over its
local relations (B4 with R = r_max), samples by global relation (B10) and
scores by local row (B8, or B9 with ``--decoder nn``).  Without ``--ep`` a
mesh runs the chunked layout only.  Rank 0 then runs one unsharded eval
(EP: on the parameters gathered from every rank).  Prints one JSON line
per rank: losses, step ms, peak device bytes, the kernels' launch counts.
``--synthetic`` is the Decagon-shaped random graph
(scripts/decoder_ab.py:DECAGON_SHAPE); otherwise the Decagon files are read
from ``--data-dir`` (or ``$TIP_DATA_DIR``).

The rank workers (:func:`train_rank`, :func:`ring_spmm_rank`) and the
launcher (:func:`spawn_ranks`) also serve the tests and chip_smoke.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import json
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tip_tpu_torch import convert, kernels
from tip_tpu_torch.config import ModelConfig
from tip_tpu_torch.scripts.decoder_ab import DECAGON_SHAPE, SPLIT

# the kernels a sharded step and the eval launch on CUDA tensors
SHARDED_KERNELS = ("typed_neighbor_sum", "gcn_spmm", "distmult_sddmm",
                   "typed_neg_sampler", "ring_spmm", "dense_bce_sym",
                   "dense_bce", "nn_sddmm")
# an EP run's layout -> the page dtype make_graph_arrays packs it with
LAYOUT_DTYPE = {"strips": "bfloat16", "pages": "float32", "chunked": None}
SEED = 0  # the parameters' init, the step seeds, the eval's test negatives
LR = 0.01  # Adam, as __graft_entry__.py's dry run
DRAWS_SEED = 7  # the probe's fixed sampler draws


@dataclass(frozen=True)
class ShardedRun:
    """One training run on the ranks' shared process group."""

    name: str
    n_ring: int  # ranks on the ring axis; the mesh is (n_ring, world/n_ring)
    pp: str = "coo"  # the ring P-P GCN: "coo" (kernel B11) or "dense" rows
    steps: int = 3
    # z, and the loss and its gradients under fixed draws (the fused routes:
    # their thresholds zeroed) before training; the same loss after it
    probe: bool = False
    ep: bool = False  # relation-partitioned (parallel/ep.py)
    layout: str = "chunked"  # the D-D layout: strips | pages | chunked
    decoder: str = "distmult"  # TIP's decoder: distmult | nn

    def __post_init__(self) -> None:
        if self.layout not in LAYOUT_DTYPE:
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.layout != "chunked" and not self.ep:
            raise ValueError(f"a mesh runs the {self.layout} layout only "
                             "relation-partitioned: set ep (--ep)")


@dataclass(frozen=True)
class ShardedJob:
    runs: tuple
    cfg: ModelConfig = field(default_factory=ModelConfig.tip_cat)
    raw: Optional[dict] = None  # synthetic_trigraph kwargs; None: the files
    data_dir: Optional[str] = None
    split: dict = field(default_factory=lambda: dict(SPLIT))
    pack: dict = field(default_factory=dict)  # make_graph_arrays kwargs
    device: str = "cuda"
    params: Optional[dict] = None  # numpy params; None: init from SEED


@dataclass(frozen=True)
class RingJob:
    """Ring SpMM inputs: build_ring_pp's blocks and [(h, cot)] pairs of
    padded [k * n_local, d] arrays."""

    src_local: np.ndarray
    dst_local: np.ndarray
    weight: np.ndarray
    inputs: tuple
    device: str = "cuda"


def probe_draws(seed: int, n_chunks: int, width: int) -> np.ndarray:
    """Fixed sampler draws u24 [n_chunks, 1, width] of a seed."""
    return np.random.default_rng(seed).integers(
        0, 1 << 24, (n_chunks, 1, width), dtype=np.int32)


def load_data(job: ShardedJob):
    from tip_tpu_torch.data import (
        build_trigraph, load_decagon_raw, synthetic_trigraph,
    )

    if job.raw is not None:
        raw = synthetic_trigraph(**job.raw)
    else:
        raw = load_decagon_raw(**({"data_dir": job.data_dir}
                                  if job.data_dir else {}))
    return build_trigraph(raw, **job.split)


def sharded_graph(data, graph, gs, world: int, n_ring: int, pp: str):
    """The host graph of a run: chunk axis padded for ``world`` ranks, ring
    buffers for ``n_ring``.  Returns (graph, gs)."""
    from tip_tpu_torch.parallel import add_ring_pp, shard_graph

    sgraph, sgs = shard_graph(graph, gs, world)
    rgraph, rgs = add_ring_pp(sgraph, data, sgs, n_ring,
                              dense_pp=pp == "dense")
    if pp == "dense" and "pp_a1r" not in rgraph:
        raise ValueError("the dense P-P rows cannot be built for this graph "
                         "(infeasible or duplicate P-P edges); use --pp coo")
    return rgraph, rgs


@dataclass
class EPGraphs:
    """An EP run's graphs: ``host`` (the sharded host graph, re-laid by
    relation, with its ``gs``), ``base``/``base_gs`` (the unsharded graph,
    its P-P side whole), the pages handed to the re-lay, and ``part``."""

    host: dict
    gs: object
    base: dict
    base_gs: object
    pages: dict
    part: object

    def eval_graph(self):
        """(graph, gs) of rank 0's unsharded eval: the unsharded graph
        re-laid by the same partition (slot-ordered pages)."""
        from tip_tpu_torch.parallel import ep_shard_graph

        return ep_shard_graph(self.base, self.base_gs, self.part, **self.pages)


def ep_graphs(data, run: ShardedRun, world: int, pack: dict) -> EPGraphs:
    """Pack ``data`` in ``run.layout`` for ``run.decoder`` (the P-P side
    dense where ``run.pp`` is 'dense', else windowed), with the chunk
    buffers beside a dense layout (the partition balances chunk counts);
    pad and ring-shard it (:func:`sharded_graph`), partition the relations
    over ``world`` ranks and re-lay it (parallel/ep.py)."""
    from tip_tpu_torch.parallel import ep_shard_graph, partition_relations
    from tip_tpu_torch.train.model import chunk_arrays, make_graph_arrays

    g0, gs0 = make_graph_arrays(data, "cpu", dense_dtype=LAYOUT_DTYPE[run.layout],
                                pp_dense=run.pp == "dense",
                                decoder=run.decoder, **pack)
    if gs0.dd_layout != run.layout:
        raise ValueError(f"the graph packs as {gs0.dd_layout!r}, not "
                         f"{run.layout!r}")
    if "dd_src2d" not in g0:
        g0.update(chunk_arrays(data, gs0.dd_chunk))
        gs0 = dataclasses.replace(gs0, dd_n_chunks=g0["dd_src2d"].shape[0])
    sgraph, sgs = sharded_graph(data, g0, gs0, world, run.n_ring, run.pp)
    part = partition_relations(sgraph["dd_chunk_type"].numpy(), sgs.n_et,
                               world)
    pages = {k: g0.get(v) for k, v in (
        ("dense_adj", "dd_adj_t"), ("neg_q", "dd_neg_q"),
        ("sym_pages", "dd_adj_sym"), ("neg_q8", "dd_neg_q8"))}
    host, hgs = ep_shard_graph(sgraph, sgs, part, **pages)
    return EPGraphs(host=host, gs=hgs, base=g0, base_gs=gs0, pages=pages,
                    part=part)


def ep_order(data, world: int, dd_chunk: int = 1024) -> np.ndarray:
    """ep_chunk_order of ``data``'s chunks padded for ``world`` ranks, as
    :func:`ep_graphs` lays them out (the partition depends on the chunk
    types alone): the input chunk at each position of the EP graph's chunk
    axis, -1 for an inert pad chunk (:func:`reference_draws` reads it)."""
    from tip_tpu_torch.data.packing import pad_typed_edges
    from tip_tpu_torch.parallel import partition_relations
    from tip_tpu_torch.parallel.ep import ep_chunk_order

    ct = pad_typed_edges(data.dd_train, data.n_drug, chunk=dd_chunk).chunk_type
    ct = np.concatenate([ct, np.full((-ct.shape[0]) % world, data.n_et - 1,
                                     ct.dtype)])
    return ep_chunk_order(ct, partition_relations(ct, data.n_et, world))


def reference_draws(draws: np.ndarray, order: np.ndarray,
                    n_chunks: int) -> np.ndarray:
    """The rows of draws laid out in an EP graph's chunk order (``order``,
    ep_chunk_order) for the first ``n_chunks`` chunks of the unpadded
    graph: the single-process draws of the same negatives."""
    real = order >= 0
    pos = np.empty(order.shape[0], np.int64)
    pos[order[real]] = np.nonzero(real)[0]
    return draws[pos[:n_chunks]]


def zero_thresholds(graph: dict) -> dict:
    """The graph with its Poissonized thresholds zeroed: the fused dense
    BCE then draws no negatives and its value is deterministic."""
    return {k: (torch.zeros_like(v) if k in ("dd_neg_q", "dd_neg_q8") else v)
            for k, v in graph.items()}


def sampled_route(cfg, gs) -> bool:
    """Whether TIP's loss on ``gs`` samples its negatives (B10), as
    train/model.py:TIP.loss picks under a mesh."""
    return (gs.dd_layout == "chunked" or cfg.decoder == "nn"
            or cfg.negatives == "sampled")


def params_digest(params) -> str:
    h = hashlib.sha256()
    for p in convert.leaves(params):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_setup(rank: int, world: int, device: str):
    from tip_tpu_torch.ops.matmul import set_matmul_precision
    from tip_tpu_torch.parallel.mesh import rank_device

    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        set_matmul_precision()
    return dev


def _mesh(run: ShardedRun, world: int, device: str):
    from tip_tpu_torch.parallel import make_mesh, make_mesh2

    if world % run.n_ring:
        raise ValueError(f"a ring of {run.n_ring} does not divide {world} ranks")
    if run.n_ring == world:
        return make_mesh(world, device_type=device)
    return make_mesh2(run.n_ring, world // run.n_ring, device_type=device)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_rank(rank: int, world: int, job: ShardedJob) -> list:
    """Rank ``rank``'s part of every run of ``job``: [one dict a run]."""
    from tip_tpu_torch.parallel import (
        ep_param_specs, ep_params, gather_params, make_sharded_train_step,
        place_graph, shard_params, unep_params,
    )
    from tip_tpu_torch.parallel.sharded import average_grads
    from tip_tpu_torch.ops.sampler import draws_per_slot, sampler_u24
    from tip_tpu_torch.train.loop import step_seed
    from tip_tpu_torch.train.model import (
        TIP, fold_seed, make_graph_arrays, make_test_arrays,
    )

    dev = _rank_setup(rank, world, job.device)
    data = load_data(job)
    graph0, gs0 = make_graph_arrays(data, "cpu", dense_dtype=None, **job.pack)

    out = []
    for run in job.runs:
        cfg = dataclasses.replace(job.cfg, decoder=run.decoder)
        mesh = _mesh(run, world, job.device)
        specs = part = eg = None
        if run.ep:
            eg = ep_graphs(data, run, world, job.pack)
            rgraph, rgs, part, init_gs = eg.host, eg.gs, eg.part, eg.base_gs
        else:
            rgraph, rgs = sharded_graph(data, graph0, gs0, world, run.n_ring,
                                        run.pp)
            init_gs = gs0
        graph = place_graph(rgraph, mesh, rgs)
        del rgraph
        model = TIP(cfg=cfg, gs=rgs, device=dev)
        sampled = sampled_route(cfg, rgs)
        res = {"name": run.name, "rank": rank, "device": str(dev),
               "ring_rank": mesh.ring_rank, "n_ring": mesh.n_ring,
               "pp": run.pp, "dd_n_chunks": rgs.dd_n_chunks, "ep": run.ep,
               "layout": rgs.dd_layout, "decoder": cfg.decoder,
               "r_max": rgs.ep_r_max}

        def fresh_params():
            nonlocal specs
            if job.params is not None:
                full = convert.params_from_jax(job.params, dev)
            else:
                full = TIP(cfg, init_gs, dev).init(
                    torch.Generator().manual_seed(SEED))
            if run.ep:
                full = ep_params(full, part)
                specs = ep_param_specs(full)
                full = shard_params(full, specs, rank)
            return convert.params_from_jax(convert.params_to_numpy(full), dev,
                                           requires_grad=True)

        def whole(tree):  # the params (or grads) of every rank, EP laid
            return gather_params(tree, specs, mesh) if run.ep else tree

        m = rgs.dd_n_chunks // world
        width = draws_per_slot(rgs.n_drug) * rgs.dd_chunk
        u24 = torch.from_numpy(probe_draws(
            DRAWS_SEED, rgs.dd_n_chunks, width)[rank * m:(rank + 1) * m])
        probe_graph = graph if sampled else zero_thresholds(graph)

        def probe_loss(params):  # fixed draws, or no negatives at all
            return model.loss(params, probe_graph, seed=0,
                              u24=u24 if sampled else None, mesh=mesh)

        if run.probe:
            params = fresh_params()
            with torch.no_grad():
                res["z"] = model.encode(params, graph, mesh).cpu().numpy()
            loss = probe_loss(params)
            loss.backward()
            average_grads(params, mesh, specs)
            res["probe_loss"] = loss.item()
            grads = whole({k: _grads(v) for k, v in params.items()})
            if run.ep:
                grads = unep_params(grads, part)
            res["probe_grads"] = convert.params_to_numpy(grads)
            with torch.no_grad():  # live negatives of a fixed seed
                res["live_loss"] = model.loss(params, graph, seed=0,
                                              mesh=mesh).item()
            if sampled:
                # the loss of the rank-folded seed's hashed draws, and of the
                # same draws passed in: equal where the sampler folds the
                # rank into the seed and hashes as the plain field does
                with torch.no_grad():
                    folded = sampler_u24(fold_seed(0, rank), m, width, dev)
                    res["fold_losses"] = (
                        model.loss(params, graph, seed=0, mesh=mesh).item(),
                        model.loss(params, graph, seed=0, u24=folded,
                                   mesh=mesh).item())
                del folded  # 18 MB at Decagon shape: not resident in training
        params = fresh_params()
        opt = torch.optim.Adam(convert.leaves(params), lr=LR)
        step = make_sharded_train_step(model, opt, mesh, specs)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        losses, step_ms, digests = [], [], []
        for k in range(run.steps):
            t0 = time.perf_counter()
            losses.append(float(step(params, graph, step_seed(SEED, k))))
            _sync(dev)
            step_ms.append(1e3 * (time.perf_counter() - t0))
            digests.append(params_digest(whole(params)))
        res.update(losses=losses, step_ms=step_ms, digests=digests,
                   train_launches=dict(kernels.LAUNCHES))
        eval_params = whole(params)  # a collective: every rank gathers
        if rank == 0:  # one unsharded eval
            eval_graph, eval_gs = eg.eval_graph() if run.ep else (graph0, gs0)
            eval_model = TIP(cfg=cfg, gs=eval_gs, device=dev)
            egraph = {k: v.to(dev) for k, v in eval_graph.items()}
            del eval_graph
            test = make_test_arrays(data, dev)
            test_neg = eval_model.sample_test_negatives(
                torch.Generator().manual_seed(SEED), test)
            per_rel, avg = eval_model.evaluate(eval_params, egraph, test,
                                               test_neg)
            res["final"] = {k: float(v) for k, v in avg.items()}
            res["per_relation"] = {k: v.cpu().numpy() for k, v in per_rel.items()}
            del egraph
        del eval_params
        _sync(dev)
        res["launches"] = dict(kernels.LAUNCHES)
        if dev.type == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if run.probe:  # the probe's losses after training (uncounted)
            with torch.no_grad():
                res["probe_loss_after"] = probe_loss(params).item()
                res["live_loss_after"] = model.loss(params, graph, seed=0,
                                                    mesh=mesh).item()
        mesh.close()
        del graph, probe_graph, params, opt, eg
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.append(res)
    return out


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad


def ring_spmm_rank(rank: int, world: int, job: RingJob) -> dict:
    """This rank's rows of the ring SpMM and of its gradient for a cotangent,
    by the plain version (parallel/ring.py:ring_spmm) and by the op
    (ops/ring.py:ring_spmm_rdma: kernel B11 on CUDA), on the 1-D mesh of
    all ranks.  Returns {"plain": [(out, dh)], "op": [(out, dh)],
    "launches": ...}."""
    from tip_tpu_torch.ops.ring import ring_spmm_rdma
    from tip_tpu_torch.parallel import make_mesh
    from tip_tpu_torch.parallel.ring import ring_spmm

    dev = _rank_setup(rank, world, job.device)
    mesh = make_mesh(world, device_type=job.device)
    blocks = [torch.from_numpy(np.ascontiguousarray(a[rank])).to(dev)
              for a in (job.src_local, job.dst_local, job.weight)]
    routes = {"plain": lambda h, n: ring_spmm(h, *blocks, n, mesh),
              "op": lambda h, n: ring_spmm_rdma(h, *blocks, mesh)}
    res = {"plain": [], "op": []}
    for h_full, cot_full in job.inputs:
        n_local = h_full.shape[0] // world
        rows = slice(rank * n_local, (rank + 1) * n_local)
        cot = torch.from_numpy(cot_full[rows]).to(dev)
        for route, fn in routes.items():
            h = torch.from_numpy(h_full[rows]).to(dev).requires_grad_(True)
            y = fn(h, n_local)
            (y * cot).sum().backward()
            res[route].append((y.detach().cpu().numpy(), h.grad.cpu().numpy()))
    _sync(dev)
    res["launches"] = dict(kernels.LAUNCHES)
    mesh.close()
    return res


def _rank_entry(fn, rank: int, world: int, init: str, job, results,
                timeout_s: float) -> None:
    # the ranks are processes of one machine: gloo talks over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, world, job)
        dist.destroy_process_group()
    except Exception:  # the boundary: report the rank's failure and exit 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def spawn_ranks(fn, world: int, job, timeout_s: float = 900.0) -> list:
    """Run fn(rank, world, job) in ``world`` spawned processes joined by a
    gloo process group (``file://`` rendezvous in a temporary directory,
    ``timeout_s`` on every collective).  Returns the ranks' results in rank
    order.  A rank that fails, or a run past ``timeout_s``, kills every
    rank and raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(fn, r, world, init, job, results, timeout_s))
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        started = []
        try:
            for p in procs:
                p.start()
                started.append(p)
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} "
                                       f"did not finish within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 5.0))
                except queue.Empty:
                    dead = [(i, p.exitcode) for i, p in enumerate(procs)
                            if p.exitcode is not None and i not in got]
                    if dead:
                        raise RuntimeError(f"ranks exited without a result "
                                           f"(rank, exit code): {dead}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"ranks did not exit cleanly: {bad}")
        finally:
            for p in started:
                if p.is_alive():
                    p.kill()
                p.join(30)
    return [got[r] for r in range(world)]


def summary(res: dict) -> dict:
    """The JSON-able fields of a rank's run."""
    keep = ("name", "rank", "device", "ring_rank", "n_ring", "pp", "ep",
            "layout", "decoder", "r_max", "losses", "step_ms", "peak_bytes",
            "train_launches", "launches", "final", "dd_n_chunks")
    return {k: res[k] for k in keep if k in res}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        description="Sharded TIP-cat training over torch.distributed ranks")
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--mesh", default=None,
                        help="RxE: (ring, edges) ranks; default the 1-D mesh")
    parser.add_argument("--pp", default="coo", choices=["coo", "dense"],
                        help="ring P-P GCN: COO blocks (B11) or dense rows")
    parser.add_argument("--ep", action="store_true",
                        help="partition the relations over the ranks")
    parser.add_argument("--layout", default="chunked",
                        choices=["strips", "pages", "chunked"],
                        help="the D-D layout (strips, pages: with --ep)")
    parser.add_argument("--decoder", default="distmult",
                        choices=["distmult", "nn"])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--cpu", action="store_true",
                        help="run the ranks on the CPU (the plain versions)")
    parser.add_argument("--synthetic", action="store_true",
                        help="the Decagon-shaped random graph")
    parser.add_argument("--data-dir", default=None, help="Decagon data dir")
    args = parser.parse_args(argv)

    from tip_tpu_torch.train.model import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda").type
    n_ring = args.ranks
    if args.mesh:
        n_ring, n_edges = (int(v) for v in args.mesh.lower().split("x"))
        if n_ring * n_edges != args.ranks:
            parser.error(f"--mesh {args.mesh} is not {args.ranks} ranks")
    if args.layout != "chunked" and not args.ep:
        parser.error(f"--layout {args.layout} shards only with --ep")
    if device == "cuda":  # build before spawning: ranks would race on _build/
        kernels.build(SHARDED_KERNELS)
    name = f"tip{'-nn' if args.decoder == 'nn' else ''} sharded " + (
        f"ep {args.layout} {args.pp}" if args.ep else args.pp)
    run = ShardedRun(name=name, n_ring=n_ring, pp=args.pp, steps=args.steps,
                     ep=args.ep, layout=args.layout, decoder=args.decoder)
    job = ShardedJob(runs=(run,), raw=DECAGON_SHAPE if args.synthetic else None,
                     data_dir=args.data_dir, device=device)
    ranks = spawn_ranks(train_rank, args.ranks, job)
    lines = [summary(r[0]) for r in ranks]
    for line in lines:
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main()
