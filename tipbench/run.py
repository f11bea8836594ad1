"""Run one cell of the port's benchmark once, on the card.

    python3 tipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is a ``workloads`` entry of BENCHMARK.json.  Every file it needs is
found by a name, so that a new cell, configuration or metric is new files:

* ``configs/<config>.json``: the model's sizes; ``model`` names its plain
  reference ``reference/models/<model>.py`` (parameter tree, encoder,
  decoder) and its operation count ``counts/models/<model>.py``;
  ``driver`` names ``drivers/<driver>.py``, the entry of the program that
  builds its device graph and model (``build``);
* ``traffic/<traffic>.json``: the graph (its ``kind`` names a generator
  ``generators/<kind>.py``), the split, the D-D layout the program is to
  pick, the stated precision, the estimator, the evaluation cadence, and
  a "train" group passed to the model's ``loss`` as keywords;
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``;
* ``metrics/<name>.py``: a per-layer metric's reader.

Set-up makes the seeded raw graph, packs it through the program's cached
packing (``TIP_CACHE_DIR`` = tipbench/cache), builds the device graph and
the model through the entry's own functions, makes the weights on the
card from ``--seed``, draws the test negatives, and runs the warm-up: one
full evaluation and 3 training steps through the timed call.  With
``--trace 0`` the window then trains for ``--seconds``, evaluating every
``eval_every`` steps; after it closes, ``trace_steps`` more steps run
under torch.profiler for the device's busy time a step; the end-to-end
metrics are printed.  With ``--trace 1`` those steps run under the
profiler without a window and the per-layer metrics are printed.  Then
the program's state is freed and the plain reference (tipbench/reference)
follows the warm-up's evaluation and steps; the numbers compared print
beside their limits, as the last lines of standard error and under
``checks`` in the result line, which is the last line of standard output.

Exits 2 without a CUDA device (or with fewer than the cell asks for), 3
where ``sys.modules`` holds JAX, jaxlib, flax or the JAX package after the
window; either way no result is printed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tipbench.lib.found import BENCH_DIR, load_module  # noqa: E402

CACHE_DIR = os.path.join(BENCH_DIR, "cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "tip_tpu")  # top-level names, whole
WARMUP_STEPS = 3  # the steps the reference follows
GIB = 2**30


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix, limits and metrics."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of "
                         f"{sorted(cells)}")
    cell = cells[workload]

    def listed(m):
        return workload in m.get("workloads", [workload])

    return {
        "cell": cell,
        "config": load_json(os.path.join(BENCH_DIR, "configs",
                                         f"{cell['config']}.json")),
        "traffic": load_json(os.path.join(BENCH_DIR, "traffic",
                                          f"{cell['traffic']}.json")),
        "limits": load_json(os.path.join(BENCH_DIR, "limits",
                                         f"{workload}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
        "per_layer": [m for m in bench["per_layer"] if listed(m)],
    }


def forbidden_modules() -> list:
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def shape_of(config: dict, gs, data) -> dict:
    """The sizes the operation and byte counts read (counts/work.py)."""
    s = {k: v for k, v in config.items() if isinstance(v, (int, float, str))}
    s.update(n_drug=gs.n_drug, n_prot=gs.n_prot, n_et=gs.n_et,
             n_train=gs.dd_n_valid, e_pp=int(data.pp_norm_index.shape[1]),
             e_dp=int(data.dp_edge_index.shape[1]),
             dd_n_chunks=gs.dd_n_chunks, dd_layout=gs.dd_layout)
    return s


def _norms(named, of) -> dict:
    return {path: float(of(p).double().norm()) for path, p in named}


@contextlib.contextmanager
def shadowed(model, name: str, fn):
    """``model.<name>`` replaced by ``fn(method)`` (an instance attribute
    of the frozen dataclass shadows its method), then put back."""
    had = name in vars(model)
    method = getattr(model, name)
    object.__setattr__(model, name, fn(method))
    try:
        yield
    finally:
        if had:
            object.__setattr__(model, name, method)
        else:
            object.__delattr__(model, name)


def recording(store: list, first_only: bool):
    """A wrapper that keeps its calls' results, detached, in ``store``."""
    def wrap(method):
        def call(*args, **kwargs):
            out = method(*args, **kwargs)
            if not (first_only and store):
                store.append(out.detach().clone())
            return out
        return call
    return wrap


def warm_up(ts, named, w0: dict, steps: int) -> dict:
    """One full evaluation at the weights as made (its scores kept), then
    the first ``steps`` steps through the timed call (the first forward's
    z kept); the program's readings of them (lib/check.py)."""
    import torch

    scores, zs = [], []
    with shadowed(ts.model, "score", recording(scores, False)):
        out = {"eval": ts.evaluate(), "losses": []}
    pos, neg = (x.float().cpu().numpy() for x in scores)
    out["neg_scores"] = neg[ts.neg_order]
    out["pos_scores"] = pos
    with shadowed(ts.model, "encode", recording(zs, True)):
        for k in range(steps):
            out["losses"].append(ts(k))
            if k == 0:  # Adam's first moment is (1 - beta1) g after a step
                out["grad_norms"] = _norms(named, lambda p: ts.opt.state[
                    p].get("exp_avg", torch.zeros_like(p)) / (1 - 0.9))
    out["z"] = zs[0]
    out["delta"] = {path: (p.detach() - w0[path]).cpu() for path, p in named}
    return out


def window(ts, seconds: float, first: int, eval_every: int, n_train: int,
           cuda: bool = True):
    """Train for ``seconds``, evaluating every ``eval_every`` steps;
    returns (end-to-end values, attempted, failed).  Off the card (the
    CPU tests) the peak reads NaN."""
    import numpy as np
    import torch

    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps, evals, failed = [], [], 0
    k = first
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        loss = ts(k)
        steps.append(time.perf_counter() - a)
        failed += not math.isfinite(loss)
        k += 1
        if eval_every and k % eval_every == 0:
            a = time.perf_counter()
            ts.evaluate()
            evals.append(time.perf_counter() - a)
        if time.perf_counter() - t0 >= seconds:
            break
    if not evals:  # a window shorter than the cadence evaluates once
        a = time.perf_counter()
        ts.evaluate()
        evals.append(time.perf_counter() - a)
    total = time.perf_counter() - t0
    values = {
        "train_edges_per_s": n_train * len(steps) / (total - sum(evals)),
        "step_ms_p95": 1e3 * float(np.percentile(steps, 95)),
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / GIB if cuda
                         else float("nan")),
        "eval_ms": 1e3 * sum(evals) / len(evals),
    }
    print(json.dumps({"window_s": total, "steps": len(steps),
                      "evals": len(evals),
                      "step_ms_median": 1e3 * float(np.median(steps))}),
          file=sys.stderr)
    return values, len(steps), failed


def prepare(files: dict, dev) -> dict:
    """Set-up that does not depend on the seed: the raw graph, the cached
    packing, the device graph and the model through the entry's driver."""
    import torch

    from tip_tpu_torch.data.cache import cached_trigraph
    from tipbench.lib.generator import make_raw

    config, traffic = files["config"], files["traffic"]
    raw = make_raw(traffic["graph"])
    driver = load_module("drivers", config["driver"])
    t = time.perf_counter()
    data = cached_trigraph(raw, traffic["split"]["split_rate"],
                           traffic["split"]["seed"], cache_dir=CACHE_DIR)
    model, graph, test, gs = driver.build(data, config, traffic, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    pack_s = time.perf_counter() - t
    if gs.dd_layout != traffic["dd_layout"]:
        raise RuntimeError(f"the program picked the {gs.dd_layout!r} layout; "
                           f"the mix states {traffic['dd_layout']!r}")
    return {"raw": raw, "driver": driver, "data": data, "model": model,
            "graph": graph, "test": test, "gs": gs, "pack_s": pack_s}


def run(files: dict, seed: int, seconds: float, trace: bool, device,
        plant=None, t_start: float = T_START, ctx=None) -> dict:
    """One run of a cell; returns the result line's fields and the
    numbers compared.  ``ctx``: a :func:`prepare` to reuse, kept after the
    run (calibration); without it set-up runs here and its state is freed
    before the reference.  ``plant(ts, data)``, where given, breaks the
    timed path after set-up and returns what undoes it (tests and
    calibration only)."""
    import numpy as np
    import torch

    from tip_tpu_torch.convert import leaves
    from tip_tpu_torch.train.loop import step_seed
    from tipbench.lib import check, weights
    from tipbench.lib.step import TrainStep
    from tipbench.reference.follow import draw_test_negatives, follow
    from tipbench.reference.model import leaves as named_leaves
    from tipbench.reference.model import model_of

    config, traffic = files["config"], files["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    own = ctx is None
    if own:
        ctx = prepare(files, dev)
    raw, data, gs = ctx["raw"], ctx["data"], ctx["gs"]
    spec = model_of(config["model"]).param_spec(config, gs)
    w0 = weights.make(spec, seed, dev)
    params = weights.tree({k: v.clone() for k, v in w0.items()})
    ts = TrainStep(ctx["model"], ctx["graph"], ctx["test"], params,
                   config["lr"], seed, step_seed, leaves,
                   loss_kwargs=traffic.get("train"))
    neg = draw_test_negatives(raw, traffic, seed)
    ts.set_test_negatives(*neg)
    undo = plant(ts, data) if plant is not None else None
    named = named_leaves(params)
    prog = warm_up(ts, named, w0, WARMUP_STEPS)
    test = {k: ctx["test"][k].cpu().numpy().astype(np.int64)
            for k in ("src", "dst", "et")}
    keys = (test["et"] * gs.n_drug + test["dst"]) * gs.n_drug + test["src"]
    order = np.argsort(keys, kind="stable")
    prog["pos_keys"], prog["pos_scores"] = keys[order], prog["pos_scores"][order]
    shape = shape_of(config, gs, data)
    graph_bytes = ts.graph_bytes()
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    out = {"attempted": 0, "failed": 0, "metrics": {},
           "setup_s": time.perf_counter() - t_start}
    from tipbench.lib.trace import traced_steps

    if trace:
        summary = traced_steps(ts, WARMUP_STEPS, traffic["trace_steps"])
        summary.update(shape=shape, pack_s=ctx["pack_s"],
                       graph_bytes=graph_bytes)
        out["attempted"] = traffic["trace_steps"]
        for m in files["per_layer"]:
            v = load_module("metrics", m["name"]).read(summary)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["busy_s"], out["window_s"] = summary["busy_s"], summary["wall_s"]
        out["breakdown"] = summary["breakdown"]
    else:
        values, out["attempted"], out["failed"] = window(
            ts, seconds, WARMUP_STEPS, traffic["eval_every"], gs.dd_n_valid,
            cuda)
        values["setup_s"] = out["setup_s"]
        # the device's busy time a step, from steps traced after the window
        values["device_ms_per_step"] = float("nan")
        if cuda:
            summary = traced_steps(ts, WARMUP_STEPS + out["attempted"],
                                   traffic["trace_steps"])
            values["device_ms_per_step"] = \
                1e3 * summary["busy_s"] / summary["steps"]
        for m in files["end_to_end"]:
            out["metrics"][m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    sync()
    out["memory_peak_bytes"] = max(
        setup_peak, torch.cuda.max_memory_allocated() if cuda else 0)
    out["failed"] += sum(not math.isfinite(x) for x in prog["losses"])

    if undo is not None:
        undo()
    del ts, params, named
    if own:
        ctx.clear()
    del data
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = follow(config["model"], raw, traffic, config["lr"], w0, seed,
                 WARMUP_STEPS, neg, dev)
    out["reference_s"] = time.perf_counter() - t
    values = check.numbers(prog, ref)
    out["readings"] = check.readings(prog, ref)
    correct, out["checks"] = check.judge(values, files["limits"])
    out["correct"] = correct and out["failed"] == 0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    files = cell_files(load_json(os.path.join(ROOT, "BENCHMARK.json")),
                       args.workload)
    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{torch.cuda.device_count()} CUDA devices; the cell asks for "
              f"{chips}", file=sys.stderr)
        return 2
    os.environ["TIP_CACHE_DIR"] = CACHE_DIR
    out = run(files, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if args.trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    print(json.dumps({"setup_s": out["setup_s"],
                      "reference_s": out["reference_s"],
                      "readings": out["readings"]}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
