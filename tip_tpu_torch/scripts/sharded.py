"""Sharded TIP-cat training over k ranks of ``torch.distributed`` (port of
__graft_entry__.py:dryrun_multichip / _dryrun_on_mesh without the
relation-partitioned EP layout).

    python -m tip_tpu_torch.scripts.sharded --ranks 4 [--mesh 2x2]
        [--pp coo|dense] [--steps N] [--cpu] [--synthetic] [--data-dir DIR]

Spawns ``--ranks`` processes (gloo, ``file://`` rendezvous in a temporary
directory), each driving ``cuda:(rank % device_count)`` (or the CPU with
``--cpu``; without a GPU and without ``--cpu`` it stops with an error), so
k ranks share one card where the machine has one.  Each rank packs the
graph chunked, keeps its shard (parallel/sharded.py), trains TIP-cat at
published widths for ``--steps`` Adam steps: edge-chunk sharding (kernels
B10, B8, B4 on its chunks) plus the protein-row ring P-P GCN on the
``ring`` axis, COO (kernel B11) or dense row blocks (``--pp dense``).
``--mesh RxE`` lays the ranks out as (ring, edges) = (R, E); the default is
the 1-D mesh.  Rank 0 then runs one unsharded eval.  Prints one JSON line
per rank: losses, step ms, peak device bytes, the kernels' launch counts.
``--synthetic`` is the Decagon-shaped random graph
(scripts/decoder_ab.py:DECAGON_SHAPE); otherwise the Decagon files are read
from ``--data-dir`` (or ``$TIP_DATA_DIR``).

The rank workers (:func:`train_rank`, :func:`ring_spmm_rank`) and the
launcher (:func:`spawn_ranks`) also serve the tests and chip_smoke.py.
"""

from __future__ import annotations

import argparse
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
                   "typed_neg_sampler", "ring_spmm")
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
    # z, and the loss and its gradients under fixed draws before training;
    # the same loss after it
    probe: bool = False


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
    from tip_tpu_torch.parallel import make_sharded_train_step, place_graph
    from tip_tpu_torch.parallel.sharded import average_grads
    from tip_tpu_torch.ops.sampler import draws_per_slot, sampler_u24
    from tip_tpu_torch.train.loop import step_seed
    from tip_tpu_torch.train.model import (
        TIP, fold_seed, make_graph_arrays, make_test_arrays,
    )

    dev = _rank_setup(rank, world, job.device)
    data = load_data(job)
    graph0, gs0 = make_graph_arrays(data, "cpu", dense_dtype=None, **job.pack)

    def fresh_params():
        if job.params is not None:
            return convert.params_from_jax(job.params, dev, requires_grad=True)
        params = TIP(job.cfg, gs0, dev).init(torch.Generator().manual_seed(SEED))
        for p in convert.leaves(params):
            p.requires_grad_(True)
        return params

    out = []
    for run in job.runs:
        mesh = _mesh(run, world, job.device)
        rgraph, rgs = sharded_graph(data, graph0, gs0, world, run.n_ring, run.pp)
        graph = place_graph(rgraph, mesh)
        model = TIP(cfg=job.cfg, gs=rgs, device=dev)
        res = {"name": run.name, "rank": rank, "device": str(dev),
               "ring_rank": mesh.ring_rank, "n_ring": mesh.n_ring,
               "pp": run.pp, "dd_n_chunks": rgs.dd_n_chunks}
        m = rgs.dd_n_chunks // world
        width = draws_per_slot(rgs.n_drug) * rgs.dd_chunk
        u24 = torch.from_numpy(probe_draws(
            DRAWS_SEED, rgs.dd_n_chunks, width)[rank * m:(rank + 1) * m])

        def probe_loss(params):  # this rank's slice of the fixed draws
            return model.loss(params, graph, seed=0, u24=u24, mesh=mesh)

        if run.probe:
            params = fresh_params()
            with torch.no_grad():
                res["z"] = model.encode(params, graph, mesh).cpu().numpy()
            loss = probe_loss(params)
            loss.backward()
            average_grads(params, mesh)
            res["probe_loss"] = loss.item()
            res["probe_grads"] = convert.params_to_numpy(
                {k: _grads(v) for k, v in params.items()})
            # the loss of the rank-folded seed's hashed draws, and of the
            # same draws passed in: equal where the sampler folds the rank
            # into the seed and hashes as the plain field does
            with torch.no_grad():
                folded = sampler_u24(fold_seed(0, rank), m, width, dev)
                res["fold_losses"] = (
                    model.loss(params, graph, seed=0, mesh=mesh).item(),
                    model.loss(params, graph, seed=0, u24=folded,
                               mesh=mesh).item())
            del folded  # 18 MB at Decagon shape: not resident in training
        params = fresh_params()
        opt = torch.optim.Adam(convert.leaves(params), lr=LR)
        step = make_sharded_train_step(model, opt, mesh)
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
            digests.append(params_digest(params))
        res.update(losses=losses, step_ms=step_ms, digests=digests,
                   train_launches=dict(kernels.LAUNCHES))
        if rank == 0:  # one unsharded eval
            eval_model = TIP(cfg=job.cfg, gs=gs0, device=dev)
            egraph = {k: v.to(dev) for k, v in graph0.items()}
            test = make_test_arrays(data, dev)
            test_neg = eval_model.sample_test_negatives(
                torch.Generator().manual_seed(SEED), test)
            per_rel, avg = eval_model.evaluate(params, egraph, test, test_neg)
            res["final"] = {k: float(v) for k, v in avg.items()}
            res["per_relation"] = {k: v.cpu().numpy() for k, v in per_rel.items()}
            del egraph
        _sync(dev)
        res["launches"] = dict(kernels.LAUNCHES)
        if dev.type == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if run.probe:  # the fixed-draws loss after training (uncounted)
            with torch.no_grad():
                res["probe_loss_after"] = probe_loss(params).item()
        mesh.close()
        del graph, params, opt
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
    keep = ("name", "rank", "device", "ring_rank", "n_ring", "pp", "losses",
            "step_ms", "peak_bytes", "train_launches", "launches", "final",
            "dd_n_chunks")
    return {k: res[k] for k in keep if k in res}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        description="Sharded TIP-cat training over torch.distributed ranks")
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--mesh", default=None,
                        help="RxE: (ring, edges) ranks; default the 1-D mesh")
    parser.add_argument("--pp", default="coo", choices=["coo", "dense"],
                        help="ring P-P GCN: COO blocks (B11) or dense rows")
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
    if device == "cuda":  # build before spawning: ranks would race on _build/
        kernels.build(SHARDED_KERNELS)
    run = ShardedRun(name=f"tip sharded {args.pp}", n_ring=n_ring, pp=args.pp,
                     steps=args.steps)
    job = ShardedJob(runs=(run,), raw=DECAGON_SHAPE if args.synthetic else None,
                     data_dir=args.data_dir, device=device)
    ranks = spawn_ranks(train_rank, args.ranks, job)
    lines = [summary(r[0]) for r in ranks]
    for line in lines:
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main()
