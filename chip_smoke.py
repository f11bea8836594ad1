#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tip_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each fatal on failure:
  1. print the card (nvidia-smi name and power limit) and torch/CUDA versions;
  2. build every CUDA kernel from tip_tpu_torch/csrc with nvcc, in parallel;
  3. build a Decagon-shaped synthetic tri-graph (645 drugs, 19,081
     proteins, 1,097 relations) and hold each kernel against its plain
     PyTorch version at the main path's shapes (kernel checks below);
  4. hold the whole training loss and its gradients on the GPU against the
     same slice on the CPU, on a small graph;
  5. train TIP-cat at full width for a few Adam steps on the Decagon-shaped
     graph through tip_tpu_torch.train.loop.train, then the final eval, with
     every kernel launch counter set to 0 just before and read just after;
  6. profile a few more steps: device time by kernel and the idle share;
  7. print the kernels line, the card line and, last, the result line
     {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet) used for the roofline bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Decagon shape: 645 drugs, 19,081 proteins, 1,097 relations; ~4,600 drawn
# pairs a relation give Decagon's ~8.3 M directed D-D train edges after
# de-duplication and the 90/10 split
DECAGON_SHAPE = dict(n_drug=645, n_prot=19081, n_et=1097, pairs_per_et=4600,
                     n_pp_pairs=715612, n_dp=18596, seed=0)
TRAIN_STEPS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dense_bce_sym_oracle(w, z, da, mode: str, chunk: int = 64):
    """float64 full-matrix oracle of the symmetric estimator in its two
    deterministic threshold modes (tests/test_tpu_kernels.py): q = 0 (no
    negatives) and q = 2^24 (count 4 on every valid non-positive stored
    cell, i.e. 4 inside diagonal 128-blocks and 2 per mirrored cell
    elsewhere).  da: uint16 numpy [R, n, n]."""
    import torch

    wn, zn = w.double(), z.double()
    n = zn.shape[0]
    ii = torch.arange(n, device=z.device)
    same_block = (ii[:, None] // 128) == (ii[None, :] // 128)
    val = torch.zeros((), dtype=torch.float64, device=z.device)
    dw = torch.zeros_like(wn)
    dz = torch.zeros_like(zn)
    for c0 in range(0, da.shape[0], chunk):
        dac = torch.from_numpy(da[c0:c0 + chunk].astype("float32")).to(
            z.device).double()
        wc = wn[c0:c0 + chunk]
        L = torch.einsum("nf,tf,mf->tnm", zn, wc, zn)
        sp = torch.nn.functional.softplus(-L, threshold=1e9)
        if mode == "positives_only":
            cnt = torch.zeros_like(L)
        else:
            cnt = torch.where(same_block, 4.0, 2.0) * (dac == 0)
        val += (sp * dac + (sp + L) * cnt).sum()
        g = cnt - (dac + cnt) * torch.sigmoid(-L)
        dw[c0:c0 + chunk] = torch.einsum("tnm,nf,mf->tf", g, zn, zn)
        dz += (torch.einsum("tf,tnm,mf->nf", wc, g, zn)
               + torch.einsum("tf,tnm,nf->mf", wc, g, zn))
    return val, dw, dz


def check_dense_bce_sym_widths(dev) -> list:
    """B1's other feature widths (d = 8, 32) and strip counts (nb = 1, 2, 3)
    against the plain version on small random symmetric pages, with the
    tolerances of the main-shape check."""
    import numpy as np
    import torch

    from tip_tpu_torch.data.packing import sym_strip_pack
    from tip_tpu_torch.ops import dense_bce_sym as bce

    rng = np.random.default_rng(11)
    out = []
    for d, n, r in ((8, 100, 5), (32, 300, 3), (16, 129, 4)):
        da = (rng.random((r, n, n)) < 0.05).astype(np.uint16)
        da = da | da.transpose(0, 2, 1)
        pages = torch.from_numpy(sym_strip_pack(da)).to(dev)
        q8 = torch.from_numpy(
            rng.integers(0, 1 << 23, (r, 8)).astype(np.int32)).to(dev)
        w = torch.from_numpy(0.3 * rng.standard_normal((r, d))).float().to(dev)
        z = torch.from_numpy(0.5 * rng.standard_normal((n, d))).float().to(dev)
        lk, dwk, dzk = bce.dense_bce_sym_cuda(w, z, pages, q8, 5, True)
        lp, dwp, dzp = bce.dense_bce_sym_plain(w, z, pages, q8, 5, True)
        vk = bce.dense_bce_sym_cuda(w, z, pages, q8, 5, False)
        rel = abs(float(lk) - float(lp)) / abs(float(lp))
        edw = float((dwk - dwp).abs().max() / dwp.abs().max())
        edz = float((dzk - dzp).abs().max() / dzp.abs().max())
        shape = f"d={d} n={n} R={r}"
        check(rel < 1e-5, f"B1 {shape} loss rel err {rel}")
        check(edw <= 1e-3 and edz <= 1e-3, f"B1 {shape} grads {edw} {edz}")
        check(float(vk) == float(lk), f"B1 {shape} value-only != fused")
        out.append({"shape": shape, "loss_rel_err": rel, "dw_err_frac": edw,
                    "dz_err_frac": edz})
    return out


def check_dense_bce_sym(graph, data, dev) -> dict:
    """Kernel B1 against its plain version and the float64 oracle at the
    main path's shapes (R = 1097, n = 645, d = 16)."""
    import torch

    from tip_tpu_torch.data.packing import dense_relation_adj
    from tip_tpu_torch.ops import dense_bce_sym as bce

    pages, q8 = graph["dd_adj_sym"], graph["dd_neg_q8"]
    n_et, _, totcols = pages.shape
    n, d = data.n_drug, 16
    gen = torch.Generator().manual_seed(7)
    w = (0.3 * torch.randn(n_et, d, generator=gen)).to(dev)
    z = (0.5 * torch.randn(n, d, generator=gen)).to(dev)
    seed = 12345
    rep = {}

    # hashed field: kernel against the plain version, same field
    loss_k, dw_k, dz_k = bce.dense_bce_sym_cuda(w, z, pages, q8, seed, True)
    loss_p, dw_p, dz_p = bce.dense_bce_sym_plain(w, z, pages, q8, seed, True)
    torch.cuda.synchronize()
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    err_dw = float((dw_k - dw_p).abs().max())
    err_dz = float((dz_k - dz_p).abs().max())
    # per-block partial sums vs torch reductions: f32 order only
    check(rel < 1e-5, f"B1 loss vs plain: rel err {rel}")
    # dz, dw partials are summed in another order than the plain version's
    check(err_dw <= 1e-3 * float(dw_p.abs().max()), f"B1 dw err {err_dw}")
    check(err_dz <= 1e-3 * float(dz_p.abs().max()), f"B1 dz err {err_dz}")
    rep.update(loss=float(loss_k), loss_rel_err=rel, dw_max_abs_err=err_dw,
               dz_max_abs_err=err_dz, max_abs_err=max(err_dw, err_dz))

    # value-only equals fused, bit for bit
    val_only = bce.dense_bce_sym_cuda(w, z, pages, q8, seed, False)
    check(float(val_only) == float(loss_k),
          f"B1 value-only {float(val_only)!r} != fused {float(loss_k)!r}")
    rep["other_shapes"] = check_dense_bce_sym_widths(dev)

    # deterministic modes against the float64 oracle
    da = dense_relation_adj(data.dd_train, n)
    for mode, qv in (("positives_only", 0), ("saturated", 1 << 24)):
        qm = torch.full_like(q8, qv)
        lk, dwk, dzk = bce.dense_bce_sym_cuda(w, z, pages, qm, seed, True)
        ov, odw, odz = dense_bce_sym_oracle(w, z, da, mode)
        vrel = abs(float(lk) - float(ov)) / abs(float(ov))
        edw = float((dwk.double() - odw).abs().max() / odw.abs().max())
        edz = float((dzk.double() - odz).abs().max() / odz.abs().max())
        check(vrel < 1e-4, f"B1 {mode} value rel err {vrel}")
        check(edw < 2e-2 and edz < 2e-2, f"B1 {mode} grads {edw} {edz}")
        rep[mode] = {"value_rel_err": vrel, "dw_err_frac": edw,
                     "dz_err_frac": edz}
    del da

    # first-order descent: the fused gradients predict the value-only drop
    g2 = float((dw_k.double() ** 2).sum() + (dz_k.double() ** 2).sum())
    lr = 1e-4 * abs(float(loss_k)) / g2  # a predicted drop of 1e-4 of the loss
    after = bce.dense_bce_sym_cuda(w - lr * dw_k, z - lr * dz_k, pages, q8,
                                   seed, False)
    drop = float(loss_k) - float(after)
    check(abs(drop - lr * g2) < 0.2 * lr * g2, f"B1 descent {drop} vs {lr * g2}")
    rep["descent"] = {"drop": drop, "predicted": lr * g2}

    # times at the main path's shapes
    rep["ms"] = cuda_ms(lambda: bce.dense_bce_sym_cuda(
        w, z, pages, q8, seed, True), reps=20)
    rep["value_only_ms"] = cuda_ms(lambda: bce.dense_bce_sym_cuda(
        w, z, pages, q8, seed, False), reps=20)
    rep["plain_ms"] = cuda_ms(lambda: bce.dense_bce_sym_plain(
        w, z, pages, q8, seed, True), reps=3, warmup=1)

    # bound: each input read once, each output written once; float32
    # operations over the cells this graph needs (those inside n x n)
    nb = -(-n // 128)
    cells = sum(min(128, n - i * 128) * (n - i * 128) for i in range(nb)) * n_et
    flops = cells * (6 * d + 20)  # three d-long dots + ~20 elementwise ops
    nbytes = (pages.numel() + 4 * (w.numel() + z.numel() + q8.numel())
              + 4 * (1 + w.numel() + z.numel()))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    rep.update(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               cells=cells, bytes=nbytes, flops=flops, library_ms=None)
    return rep


KERNEL_CHECKS = {"dense_bce_sym": check_dense_bce_sym}


def check_small_slice_cpu_vs_gpu(dev) -> dict:
    """TIP.loss and its gradients on a small graph, on the GPU (kernel) and
    on the CPU (plain version) with the same parameters and seed.  The
    hashed field is the same on both, so only f32 order and bf16 re-rounding
    of activations differ: loss rtol 1e-3, grads atol 2e-2 of their max."""
    import torch

    from tip_tpu_torch import convert
    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
    from tip_tpu_torch.train.model import TIP, make_graph_arrays

    data = build_trigraph(synthetic_trigraph(
        n_drug=200, n_prot=300, n_et=7, pairs_per_et=200, seed=5), 0.9, 5)
    cfg = ModelConfig.tip_cat()
    out = {}
    params_np = None
    for name in ("cpu", "cuda"):
        graph, gs = make_graph_arrays(data, device=name)
        model = TIP.for_data(cfg, data, gs, device=name)
        if params_np is None:
            params_np = convert.params_to_numpy(
                model.init(torch.Generator().manual_seed(3)))
        params = convert.params_from_jax(params_np, device=name,
                                         requires_grad=True)
        loss = model.loss(params, graph, seed=99)
        loss.backward()
        grads = [p.grad.cpu() for p in convert.leaves(params)]
        out[name] = (loss.item(), grads)
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    check(abs(lg - lc) <= 1e-3 * abs(lc), f"slice loss gpu {lg} cpu {lc}")
    worst = 0.0
    for a, b in zip(gg, gc):
        frac = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, frac)
    check(worst < 2e-2, f"slice grads gpu vs cpu: {worst} of max")
    return {"loss_gpu": lg, "loss_cpu": lc, "grad_err_frac": worst}


def profile_steps(graph, gs, data, dev, steps: int = 3, warmup: int = 2) -> dict:
    """Device time by kernel over a few TIP-cat training steps (the loop's
    step: loss, backward, Adam), from torch.profiler; wall time from the
    host clock around the synchronised window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tip_tpu_torch import convert
    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.train.loop import step_seed
    from tip_tpu_torch.train.model import TIP

    model = TIP.for_data(ModelConfig.tip_cat(), data, gs, dev)
    params = model.init(torch.Generator().manual_seed(0))
    for p in convert.leaves(params):
        p.requires_grad_(True)
    opt = torch.optim.Adam(convert.leaves(params), lr=0.01)

    def step(k):
        opt.zero_grad(set_to_none=True)
        model.loss(params, graph, step_seed(0, k)).backward()
        opt.step()

    for k in range(warmup):
        step(k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for k in range(steps):
            step(warmup + k)
        torch.cuda.synchronize()
        wall = time.time() - t0

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies, sets): the CPU ops that
    # launched them, and annotations such as the optimizer step's, report
    # the same time again
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {
        "steps": steps,
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "top": [{"name": k[:100], "ms_per_step": us / 1e3 / steps,
                 "calls_per_step": c / steps}
                for us, k, c in rows[:20] if us > 0],
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tip_tpu_torch import kernels
    from tip_tpu_torch.config import ModelConfig, TrainConfig
    from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
    from tip_tpu_torch.ops.matmul import set_matmul_precision
    from tip_tpu_torch.train.loop import train
    from tip_tpu_torch.train.model import make_graph_arrays

    t_all = time.time()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    set_matmul_precision()

    t0 = time.time()
    logs = kernels.build(verbose=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s")

    print("small slice gpu vs cpu:",
          json.dumps(check_small_slice_cpu_vs_gpu(dev)))

    t0 = time.time()
    data = build_trigraph(synthetic_trigraph(**DECAGON_SHAPE), 0.9, 1111)
    print("graph:", json.dumps({
        "n_drug": data.n_drug, "n_prot": data.n_prot, "n_et": data.n_et,
        "dd_train_edges": data.dd_train.n_edges,
        "dd_test_edges": data.dd_test.n_edges,
        "pp_train_edges": int(data.pp_train.shape[1]),
        "dp_edges": int(data.dp_edge_index.shape[1]),
        "build_sec": time.time() - t0,
    }))

    graph, gs = make_graph_arrays(data, dev)
    checks = {}
    for name in kernels.KERNELS:
        checks[name] = KERNEL_CHECKS[name](graph, data, dev)
        print(f"kernel {name}:", json.dumps(checks[name]))

    # the main path, counters at 0 just before and read just after
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _, result = train(ModelConfig.tip_cat(), TrainConfig(epochs=TRAIN_STEPS),
                      data, log=print, device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in result["history"]]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train losses {losses}")
    for k in ("auprc", "auroc", "ap"):
        v = result["final"][k]
        check(0.0 <= v <= 1.0, f"metric {k} = {v}")
        per = result["per_relation"][k]
        check(per.shape == (data.n_et,) and np.all((per >= 0) & (per <= 1)),
              f"per-relation {k}")
    for name in kernels.KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched in training")
    step_sec = sorted(h["sec"] for h in result["history"][1:])
    print("train:", json.dumps({
        "losses": losses, "final": result["final"], "launches": launches,
        "step_ms_median": 1e3 * step_sec[len(step_sec) // 2],
        "step_ms_all": [1e3 * h["sec"] for h in result["history"]],
        "peak_mem_bytes": peak,
    }))

    entries = []
    for name, spec in kernels.KERNELS.items():
        c = checks[name]
        entries.append({
            "name": name, "route": spec.route, "source": spec.source,
            "replaces": spec.replaces, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    print("profile:", json.dumps(profile_steps(graph, gs, data, dev)))
    print(f"total {time.time() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
