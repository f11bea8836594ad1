#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tip_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each fatal on failure:
  1. print the card (nvidia-smi name and power limit) and torch/CUDA versions;
  2. build every CUDA kernel from tip_tpu_torch/csrc with nvcc, in parallel;
  3. hold the whole training loss and its gradients on the GPU against the
     same slice on the CPU, on a small graph: TIP-cat and DR-NN on the
     strips and the chunked layout, TIP-cat and DR-DF on the float32 full
     pages, TIP-cat with sampled negatives on the strips, TIP-cat with the
     NN decoder on the strips and chunked, DR-NN on the float32 pages;
  4. build a Decagon-shaped synthetic tri-graph (645 drugs, 19,081
     proteins, 1,097 relations), pack it in both layouts, and hold each
     kernel against its plain PyTorch version (KERNEL_CHECKS: B1 on the
     dense strips, B2 on the full float32 and bf16 pages and B3 on DR-NN's
     uint8, bf16 and float32 pages, the dense paths' shapes; B4-B10 on the
     chunked buffers, B6 and B7 also against B8 and B9);
  5. the dense TIP paths: train TIP-cat at full width for a few Adam steps
     on the Decagon-shaped graph through tip_tpu_torch.train.loop.train,
     then the final eval, with every kernel launch counter set to 0 just
     before and read just after; then profile a few more steps (device
     time by kernel, idle share).  "tip dense" on the strips (B1), "tip
     pages" with float32 matmuls pinned (train(..., matmul_precision=
     "highest")), which takes the float32 full pages (B2), "tip strips
     sampled" with sampled negatives on the strips (B10, B8; unprofiled),
     and "tip-nn dense", TIP-cat with the NN decoder: the strips for the
     encoder, the chunk buffers for its sampled loss (B10, B9);
  6. the model variants through the models runner (build_variant,
     train_variant) on the same graph, each at the default widths, counters
     as in 5: DR-NN on the strips and uint8 pages (B3; profiled), DR-NN
     with float32 matmuls pinned ("dr-nn pages": B3 on the float32 pages),
     then DR-DF (B1), PR-HMP-NN and PP-GAE (no kernel), and DR-DF with
     float32 matmuls pinned ("dr-df pages", B2);
  7. the decoder A/B entry point (tip_tpu_torch/scripts/decoder_ab.py) on
     the same graph in float32, counters as in 5: v1 (B6, B7) against v2
     (B8, B9) against a plain gather, the sampler (B10), the positives' BCE;
  8. hold B4-B10 against their plain versions again on the graph beyond
     the dense budget (BEYOND_DENSE: the chunked paths' own shapes, timed)
     and on a graph too wide for any shared-memory table (WIDE: the
     kernels' global-memory and two-draw modes);
  9. the chunked paths on BEYOND_DENSE: TIP-cat and TIP-cat with the NN
     decoder as in 5 (B10, B8 or B9, B4, B5; profiled) and DR-NN as in 6
     (B10, B9, B4; profiled);
 10. print the kernels line (each kernel timed at the shapes of the path
     whose launches it reports, KERNEL_PATH), the card line and, last, the
     result line {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import faulthandler
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

# The Decagon shape (645 drugs, 19,081 proteins, 1,097 relations) is the
# decoder A/B's DECAGON_SHAPE (tip_tpu_torch/scripts/decoder_ab.py).
# Beyond the dense budget: bf16 pages would take 800 x 1536^2 x 2 B =
# 3.77 GB > 2.5 GB, so train() picks the chunked layout.  The D-D side is
# bench.py's beyond-dense lane (1536 drugs); the per-relation pair count and
# the protein side are Decagon's.
BEYOND_DENSE = dict(n_drug=1536, n_prot=19081, n_et=800, pairs_per_et=4600,
                    n_pp_pairs=715612, n_dp=18596, seed=0)
# Wider than any shared-memory table: B8 (> 3,417 drugs forward, > 1,693
# backward) and B4's backward (> 6,456) take their global-memory modes, and
# B10 (> 4,096) draws src and dst separately
WIDE = dict(n_drug=7000, n_prot=300, n_et=3, pairs_per_et=40000,
            n_pp_pairs=600, n_dp=400, seed=0)
TRAIN_STEPS = 5  # TIP-cat paths
VARIANT_STEPS = 5  # the DR-NN paths (kernels B3, B9)
OTHER_STEPS = 2  # DR-DF, PR-HMP-NN, PP-GAE


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, primed: bool = False) -> float:
    """Mean time of fn() over reps launches, by CUDA events.  Unprimed, that
    is the larger of the host's and the device's time.  ``primed`` (kernel
    wrappers): a spin kernel holds the stream while the host enqueues every
    rep, so the events time the device alone and leave out the wrapper's
    host work, which can outlast a small kernel; the spin is lengthened
    until it outlasts the enqueue, or the check fails."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24  # ~10 ms at the H100's clock; x4 each retry
    for _ in range(4 if primed else 1):
        if primed:
            torch.cuda._sleep(cycles)
        held = torch.cuda.Event()
        held.record()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        still_held = not held.query()
        torch.cuda.synchronize()
        if still_held or not primed:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    raise AssertionError(f"could not prime the stream: enqueueing {reps} "
                         f"calls outlasted a spin of {cycles // 4} cycles")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def distmult_bce_oracle(w, z, da, count, chunk: int = 64):
    """float64 value and gradients (dw, dz) of the DistMult estimator
    (B1, B2) for a fixed count field: ``count(dac)`` gives the counts of a
    chunk of pages ``dac`` (float64 [chunk, n, n]).  da: numpy counts
    [R, n, n]."""
    import torch

    wn, zn = w.double(), z.double()
    val = torch.zeros((), dtype=torch.float64, device=z.device)
    dw = torch.zeros_like(wn)
    dz = torch.zeros_like(zn)
    for c0 in range(0, da.shape[0], chunk):
        dac = torch.from_numpy(da[c0:c0 + chunk].astype("float32")).to(
            z.device).double()
        wc = wn[c0:c0 + chunk]
        L = torch.einsum("nf,tf,mf->tnm", zn, wc, zn)
        sp = torch.nn.functional.softplus(-L, threshold=1e9)
        cnt = count(dac)
        val += (sp * dac + (sp + L) * cnt).sum()
        g = cnt - (dac + cnt) * torch.sigmoid(-L)
        dw[c0:c0 + chunk] = torch.einsum("tnm,nf,mf->tf", g, zn, zn)
        dz += (torch.einsum("tf,tnm,mf->nf", wc, g, zn)
               + torch.einsum("tf,tnm,nf->mf", wc, g, zn))
    return val, dw, dz


def dense_bce_sym_oracle(w, z, da, mode: str):
    """float64 full-matrix oracle of the symmetric estimator in its two
    deterministic threshold modes (tests/test_tpu_kernels.py): q = 0 (no
    negatives) and q = 2^24 (count 4 on every valid non-positive stored
    cell, i.e. 4 inside diagonal 128-blocks and 2 per mirrored cell
    elsewhere).  da: uint16 numpy [R, n, n]."""
    import torch

    ii = torch.arange(z.shape[0], device=z.device)
    same_block = (ii[:, None] // 128) == (ii[None, :] // 128)
    if mode == "positives_only":
        return distmult_bce_oracle(w, z, da, torch.zeros_like)
    return distmult_bce_oracle(
        w, z, da, lambda dac: torch.where(same_block, 4.0, 2.0) * (dac == 0))


def dense_bce_oracle(w, z, da, mode: str):
    """float64 oracle of B2's estimator over the full pages in its two
    deterministic threshold modes: q = 0 (no negatives) and q = 2^24 (count
    3 on every non-positive cell, self-pairs included)."""
    import torch

    if mode == "positives_only":
        return distmult_bce_oracle(w, z, da, torch.zeros_like)
    return distmult_bce_oracle(w, z, da, lambda dac: 3.0 * (dac == 0))


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


def check_dense_bce_sym(graph, gs, data, dev, timed: bool = True) -> dict:
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
    if not timed:
        return rep

    # times at the main path's shapes
    rep["ms"] = cuda_ms(lambda: bce.dense_bce_sym_cuda(
        w, z, pages, q8, seed, True), reps=20, primed=True)
    rep["value_only_ms"] = cuda_ms(lambda: bce.dense_bce_sym_cuda(
        w, z, pages, q8, seed, False), reps=20, primed=True)
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


def check_dense_bce_shapes(dev) -> list:
    """B2 against its plain version on small random pages in both page
    dtypes, at its other feature widths and with ragged tiles (n = 100: one
    partial tile; n = 1,000: eight tiles a side, the last partial), with
    the main check's tolerances."""
    import numpy as np
    import torch

    from tip_tpu_torch.ops import dense_bce as bce
    from tip_tpu_torch.train.model import pages_tensor

    rng = np.random.default_rng(13)
    out = []
    for d, n, r in ((8, 100, 5), (16, 1000, 3), (32, 300, 3)):
        da = rng.poisson(0.05, (r, n, n)).astype(np.uint16)
        q = torch.from_numpy(
            rng.integers(0, 1 << 22, (r, 3)).astype(np.int32)).to(dev)
        w = torch.from_numpy(0.3 * rng.standard_normal((r, d))).float().to(dev)
        z = torch.from_numpy(0.5 * rng.standard_normal((n, d))).float().to(dev)
        for dtype in ("float32", "bfloat16"):
            pages = pages_tensor(da, dtype, dev)
            lk, dwk, dzk = bce.dense_bce_cuda(w, z, pages, q, 5, True)
            lp, dwp, dzp = bce.dense_bce_plain(w, z, pages, q, 5, True)
            vk = bce.dense_bce_cuda(w, z, pages, q, 5, False)
            rel = abs(float(lk) - float(lp)) / abs(float(lp))
            errs = _frac_errs((dwk, dzk), (dwp, dzp))
            shape = f"d={d} n={n} R={r} {dtype}"
            check(rel < 1e-5, f"B2 {shape} loss rel err {rel}")
            check(max(errs) <= 1e-3, f"B2 {shape} grads {errs}")
            check(float(vk) == float(lk), f"B2 {shape} value-only != fused")
            out.append({"shape": shape, "loss_rel_err": rel,
                        "grad_err_frac": errs})
    return out


def check_dense_bce(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B2 against its plain version and the float64 oracle on the
    full count pages of the Decagon-shaped graph (R = 1097, n = 645,
    d = 16), in both page dtypes: the float32 pages the "tip pages" path
    trains on, then the bf16 pages a graph whose strips cannot be built
    falls back to.  Per-block partial sums vs torch reductions: f32 order
    only (loss rel. err 1e-5, grads 1e-3 of their max)."""
    import torch

    from tip_tpu_torch.data.packing import (
        dense_relation_adj, poisson_neg_thresholds,
    )
    from tip_tpu_torch.ops import dense_bce as bce
    from tip_tpu_torch.train.model import pages_tensor

    n = data.n_drug
    da = dense_relation_adj(data.dd_train, n)
    q = torch.from_numpy(poisson_neg_thresholds(data.dd_train, n)).to(dev)
    n_et, d = data.n_et, 16
    gen = torch.Generator().manual_seed(9)
    w = (0.3 * torch.randn(n_et, d, generator=gen)).to(dev)
    z = (0.5 * torch.randn(n, d, generator=gen)).to(dev)
    seed = 12345
    rep = {}
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        pages = pages_tensor(da, dtype, dev)
        r = {}
        loss_k, dw_k, dz_k = bce.dense_bce_cuda(w, z, pages, q, seed, True)
        loss_p, dw_p, dz_p = bce.dense_bce_plain(w, z, pages, q, seed, True)
        rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        errs = _frac_errs((dw_k, dz_k), (dw_p, dz_p))
        check(rel < 1e-5, f"B2 {dtype} loss vs plain: rel err {rel}")
        check(max(errs) <= 1e-3, f"B2 {dtype} grads vs plain (dw, dz): {errs}")
        worst = max(worst, max_err(dw_k, dw_p)[0], max_err(dz_k, dz_p)[0])
        r.update(loss=float(loss_k), loss_rel_err=rel, grad_err_frac=errs)
        # value-only equals fused bit for bit; launches are deterministic
        val_only = bce.dense_bce_cuda(w, z, pages, q, seed, False)
        check(float(val_only) == float(loss_k),
              f"B2 {dtype} value-only {float(val_only)!r} != fused "
              f"{float(loss_k)!r}")
        again = bce.dense_bce_cuda(w, z, pages, q, seed, True)
        check(all(torch.equal(a, b) for a, b in zip(again, (loss_k, dw_k, dz_k))),
              f"B2 {dtype} is not deterministic")
        # deterministic modes against the float64 oracle
        for mode, qv in (("positives_only", 0), ("saturated", 1 << 24)):
            lk, dwk, dzk = bce.dense_bce_cuda(w, z, pages, torch.full_like(q, qv),
                                              seed, True)
            ov, odw, odz = dense_bce_oracle(w, z, da, mode)
            vrel = abs(float(lk) - float(ov)) / abs(float(ov))
            e = _frac_errs((dwk, dzk), (odw, odz))
            check(vrel < 1e-4, f"B2 {dtype} {mode} value rel err {vrel}")
            check(max(e) < 1e-3, f"B2 {dtype} {mode} grads {e}")
            r[mode] = {"value_rel_err": vrel, "grad_err_frac": e}
        # first-order descent: the fused gradients predict the value-only drop
        g2 = float((dw_k.double() ** 2).sum() + (dz_k.double() ** 2).sum())
        lr = 1e-4 * abs(float(loss_k)) / g2  # a predicted drop of 1e-4 of the loss
        after = bce.dense_bce_cuda(w - lr * dw_k, z - lr * dz_k, pages, q,
                                   seed, False)
        drop = float(loss_k) - float(after)
        check(abs(drop - lr * g2) < 0.2 * lr * g2,
              f"B2 {dtype} descent {drop} vs {lr * g2}")
        r["descent"] = {"drop": drop, "predicted": lr * g2}
        if timed:
            r["ms"] = cuda_ms(lambda: bce.dense_bce_cuda(
                w, z, pages, q, seed, True), reps=20, primed=True)
            r["value_only_ms"] = cuda_ms(lambda: bce.dense_bce_cuda(
                w, z, pages, q, seed, False), reps=20, primed=True)
            r["plain_ms"] = cuda_ms(lambda: bce.dense_bce_plain(
                w, z, pages, q, seed, True), reps=3, warmup=1)
            # bound: each input read once, each output written once; three
            # d-long dots and ~20 elementwise float operations a cell
            cells = n_et * n * n
            r.update(bound(nbytes(pages, w, z, q) + 4 * (1 + w.numel() + z.numel()),
                           cells * (6 * d + 20)))
            r["cells"] = cells
        rep[dtype] = r
        del pages
        torch.cuda.empty_cache()
    rep["other_shapes"] = check_dense_bce_shapes(dev)
    rep["max_abs_err"] = worst
    if timed:  # the kernels line reports the float32 pages of "tip pages"
        main = rep["float32"]
        rep.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
        rep["library_ms"] = None  # no single PyTorch call computes it
    return rep


def bound(nbytes: float, flops: float) -> dict:
    """The least time for the work: bytes at the memory rate or float32
    operations at the peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "flops": int(flops)}


def max_err(got, want) -> tuple:
    """(max |got - want|, max |want|) as floats."""
    return (float((got.double() - want.double()).abs().max()),
            float(want.double().abs().max()))


def library_call(fn, want, tol: float, what: str):
    """Time of one PyTorch library call that computes what a kernel
    computes (checked against ``want`` within ``tol`` of its largest
    magnitude), or None, with the reason printed, where this PyTorch build
    cannot run it."""
    try:
        got = fn()
    except (RuntimeError, NotImplementedError) as e:
        print(f"{what}: library call unavailable: {e}")
        return None
    err, m = max_err(got, want)
    check(err <= tol * m, f"{what}: library yardstick disagrees: {err}")
    return cuda_ms(fn, reps=10)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_typed_neighbor_sum(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B4 forward and backward against the plain version at both
    R-GCN widths (d = 64, layer 1; d = 32, layer 2), the backward in the
    mode the wrapper picks for this graph (a shared-memory feature slice,
    two slices at n = 1,536 and d = 64, or global memory past 6,456 nodes)
    and forced to global memory.  The kernel sums each (relation, dst) run
    in slot order, the plain version with index_add_: float32 order only,
    hence 1e-5 (forward) and 1e-4 (backward) of the largest magnitude."""
    import torch

    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.ops import typed_segment as ts

    src2d, dst2d, ct = graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"]
    n, n_et = gs.n_drug, gs.n_et
    cfg = ModelConfig.tip_cat()
    args = (src2d, dst2d, ct)
    gen = torch.Generator().manual_seed(21)
    rep, worst = {}, 0.0
    for d in (cfg.rgcn_in_dim, cfg.n_hid1):
        x = torch.randn(n, d, generator=gen).to(dev)
        dpt = torch.randn(n_et, d, n, generator=gen).to(dev)
        pk = ts.typed_neighbor_sum_fwd_cuda(x, *args, n_et)
        pp = ts.typed_neighbor_sum_fwd_plain(x, *args, n_et)
        dxp = ts.typed_neighbor_sum_bwd_plain(dpt, *args)
        ef, mf = max_err(pk, pp)
        check(ef <= 1e-5 * mf, f"B4 d={d} forward err {ef} of max {mf}")
        check(torch.equal(pk, ts.typed_neighbor_sum_fwd_cuda(x, *args, n_et)),
              f"B4 d={d} forward is not deterministic")
        r = {"kslice": ts.tns_bwd_kslice(n, d), "fwd_max_abs_err": ef,
             "fwd_max": mf}
        for table in (None, "global"):
            dxk = ts.typed_neighbor_sum_bwd_cuda(dpt, *args, table=table)
            eb, mb = max_err(dxk, dxp)
            check(eb <= 1e-4 * mb,
                  f"B4 d={d} backward ({table or 'auto'}) err {eb} of max {mb}")
            r[f"bwd_{table or 'auto'}_max_abs_err"] = eb
            worst = max(worst, eb)
        r["bwd_max"] = mb
        worst = max(worst, ef)
        rep[f"d{d}"] = r
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    # times at layer 1's width (the wider, slower call)
    d = cfg.rgcn_in_dim
    x = torch.randn(n, d, generator=gen).to(dev)
    dpt = torch.randn(n_et, d, n, generator=gen).to(dev)
    rep["d"] = d
    rep["ms"] = cuda_ms(lambda: ts.typed_neighbor_sum_fwd_cuda(x, *args, n_et),
                        reps=20, primed=True)
    rep["bwd_ms"] = cuda_ms(lambda: ts.typed_neighbor_sum_bwd_cuda(dpt, *args),
                            reps=20, primed=True)
    rep["bwd_global_ms"] = cuda_ms(lambda: ts.typed_neighbor_sum_bwd_cuda(
        dpt, *args, table="global"), reps=20, primed=True)
    rep["plain_ms"] = cuda_ms(
        lambda: ts.typed_neighbor_sum_fwd_plain(x, *args, n_et), reps=3, warmup=1)
    rep["bwd_plain_ms"] = cuda_ms(
        lambda: ts.typed_neighbor_sum_bwd_plain(dpt, *args), reps=3, warmup=1)

    # yardstick: the typed adjacency as one [n_et * n, n] CSR matrix times x
    valid = dst2d < n
    rows = (ct.long()[:, None] * n + dst2d.long())[valid]
    cols = src2d.long()[valid]
    crow = torch.zeros(n_et * n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n_et * n), 0)
    adj = torch.sparse_csr_tensor(crow, cols, torch.ones_like(cols, dtype=torch.float32),
                                  (n_et * n, n))
    rep["library_ms"] = library_call(
        lambda: torch.sparse.mm(adj, x),
        ts.typed_neighbor_sum_fwd_plain(x, *args, n_et).transpose(1, 2).reshape(
            n_et * n, d), 1e-5, "B4")

    e_valid = int(valid.sum())
    fwd = bound(nbytes(src2d, dst2d, ct, x) + n_et * d * n * 4, e_valid * d)
    bwd = bound(nbytes(src2d, dst2d, ct, dpt) + n * d * 4, e_valid * d)
    rep.update(fwd)
    rep.update(bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
               slots=src2d.numel(), valid_edges=e_valid)
    return rep


def check_gcn_spmm(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B5 against the plain version at both GCN widths (d = 32 and
    16) on the windowed P-P buffers, in float32 and with the bf16 message
    rounding, plus the adjoint identity <c, A x> = <A c, x> that its
    backward relies on.  Runs summed in slot order vs index_add_: float32
    order only, 1e-5 of the largest magnitude."""
    import torch

    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.ops import typed_segment as ts

    bufs = (graph["ppw_src"], graph["ppw_dstl"], graph["ppw_w"],
            graph["ppw_chunk_window"], gs.pp_n_windows, gs.pp_window, gs.n_prot)
    cfg = ModelConfig.tip_cat()
    gen = torch.Generator().manual_seed(22)
    rep, worst = {}, 0.0
    for d in (cfg.pp_hid1, cfg.pp_hid2):
        x = torch.randn(gs.n_prot, d, generator=gen).to(dev)
        cot = torch.randn(gs.n_prot, d, generator=gen).to(dev)
        for dt in ("float32", "bfloat16"):
            k = ts.gcn_spmm_cuda(x, *bufs, compute_dtype=dt)
            p = ts.gcn_spmm_plain(x, *bufs, compute_dtype=dt)
            e, m = max_err(k, p)
            check(e <= 1e-5 * m, f"B5 d={d} {dt} err {e} of max {m}")
            rep[f"d{d}_{dt}_max_abs_err"] = e
            worst = max(worst, e)
        lhs = float((cot.double() * ts.gcn_spmm_cuda(x, *bufs).double()).sum())
        rhs = float((ts.gcn_spmm_cuda(cot, *bufs).double() * x.double()).sum())
        check(abs(lhs - rhs) <= 1e-5 * abs(lhs), f"B5 d={d} adjoint {lhs} vs {rhs}")
        rep[f"d{d}_adjoint"] = {"lhs": lhs, "rhs": rhs}
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    d = cfg.pp_hid1
    x = torch.randn(gs.n_prot, d, generator=gen).to(dev)
    rep["d"] = d
    rep["ms"] = cuda_ms(lambda: ts.gcn_spmm_cuda(x, *bufs), reps=50,
                        primed=True)
    rep["plain_ms"] = cuda_ms(lambda: ts.gcn_spmm_plain(x, *bufs), reps=5,
                              warmup=1)
    # yardstick: A_hat as one CSR matrix (gcn_normalize sorts it by dst)
    dst = torch.from_numpy(data.pp_norm_index[1].astype("int64")).to(dev)
    crow = torch.zeros(gs.n_prot + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(dst, minlength=gs.n_prot), 0)
    adj = torch.sparse_csr_tensor(
        crow, torch.from_numpy(data.pp_norm_index[0].astype("int64")).to(dev),
        torch.from_numpy(data.pp_norm_weight).to(dev), (gs.n_prot, gs.n_prot))
    rep["library_ms"] = library_call(lambda: torch.sparse.mm(adj, x),
                                     ts.gcn_spmm_plain(x, *bufs), 1e-5, "B5")
    e_valid = int(data.pp_norm_index.shape[1])
    rep.update(bound(nbytes(*bufs[:4], x) + gs.n_prot * d * 4,
                     2 * e_valid * d))
    rep.update(slots=bufs[0].numel(), valid_edges=e_valid)
    return rep


def check_distmult_sddmm(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B8 forward (logits) and backward (dz, dw) against the plain
    version at d = 16, with its tables where the wrapper puts them for this
    graph (shared memory up to 3,417 nodes forward and 1,693 backward,
    global memory past that) and forced to global memory, and the backward
    with the bf16 rounding of each scattered contribution; pad logits must
    be exactly 0.  Float32 order only: 1e-5 of the largest logit, 1e-4 of
    the largest dz and dw."""
    import torch

    from tip_tpu_torch.ops import sddmm2
    from tip_tpu_torch.ops.matmul import bf16_round

    src2d, dst2d, ct = graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"]
    d = sddmm2.D
    gen = torch.Generator().manual_seed(23)
    z = (0.5 * torch.randn(gs.n_drug, d, generator=gen)).to(dev)
    w = (0.3 * torch.randn(gs.n_et, d, generator=gen)).to(dev)
    g = torch.randn(src2d.shape, generator=gen).to(dev)
    pad = graph["dd_valid"].reshape(src2d.shape) == 0
    rep = {"d": d, "fwd_shared": sddmm2.shared_table_fits(gs.n_drug, False),
           "bwd_shared": sddmm2.shared_table_fits(gs.n_drug, True),
           "pad_slots": int(pad.sum())}
    worst = 0.0
    for bf16 in (False, True):
        zr = bf16_round(z) if bf16 else z  # the wrapper's compute_round
        args = (zr, w, src2d, dst2d, ct)
        lp = sddmm2.distmult_logits_plain(*args)
        dzp, dwp = sddmm2.distmult_bwd_plain(*args, g, bf16)
        for table in (None, "global"):
            tag = ("bf16_" if bf16 else "") + (table or "auto")
            lk = sddmm2.distmult_logits_cuda(*args, table=table)
            dzk, dwk = sddmm2.distmult_bwd_cuda(*args, g, bf16, table=table)
            el, ml = max_err(lk, lp)
            ez, mz = max_err(dzk, dzp)
            ew, mw = max_err(dwk, dwp)
            check(el <= 1e-5 * ml, f"B8 {tag} logits err {el} of max {ml}")
            check(ez <= 1e-4 * mz and ew <= 1e-4 * mw,
                  f"B8 {tag} grads err {ez} of {mz}, {ew} of {mw}")
            check(bool((lk[pad] == 0).all()), f"B8 {tag} pad logits are not 0")
            rep[tag] = {"logit_max_abs_err": el, "dz_max_abs_err": ez,
                        "dw_max_abs_err": ew}
            worst = max(worst, el, ez, ew)
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    args = (z, w, src2d, dst2d, ct)
    rep["ms"] = cuda_ms(lambda: sddmm2.distmult_logits_cuda(*args), reps=20,
                        primed=True)
    rep["bwd_ms"] = cuda_ms(lambda: sddmm2.distmult_bwd_cuda(*args, g),
                            reps=20, primed=True)
    rep["global_ms"] = cuda_ms(lambda: sddmm2.distmult_logits_cuda(
        *args, table="global"), reps=20, primed=True)
    rep["bwd_global_ms"] = cuda_ms(lambda: sddmm2.distmult_bwd_cuda(
        *args, g, table="global"), reps=20, primed=True)
    rep["plain_ms"] = cuda_ms(lambda: sddmm2.distmult_logits_plain(*args),
                              reps=3, warmup=1)
    rep["bwd_plain_ms"] = cuda_ms(lambda: sddmm2.distmult_bwd_plain(*args, g),
                                  reps=3, warmup=1)
    rep["library_ms"] = None  # no single PyTorch call computes it
    slots = src2d.numel()
    fwd = bound(nbytes(src2d, dst2d, ct, z, w) + 4 * slots, 3 * d * slots)
    bwd = bound(nbytes(src2d, dst2d, ct, z, w, g) + nbytes(z, w),
                9 * d * slots)
    rep.update(fwd)
    rep.update(bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
               slots=slots)
    return rep


def check_typed_neg_sampler(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B10 against its plain version under the same seed (exact
    equality of every raw, sign-flagged pair), in the single-draw mode up
    to 4,096 nodes and the two-draw mode past it, then the lane-borrow
    pass: how many sampled negatives are still positives after it (the JAX
    package accepts ~density^5)."""
    import torch

    from tip_tpu_torch.data.packing import bitmap_stride_bits
    from tip_tpu_torch.ops import sampler

    ct, bitmap = graph["dd_chunk_type"], graph["dd_bitmap"]
    n, chunk = gs.n_drug, gs.dd_chunk
    seed = 12345
    rk = sampler.typed_negative_sampling_cuda(seed, ct, bitmap, n, chunk)
    rp = sampler.typed_negative_sampling_plain(seed, ct, bitmap, n, chunk)
    check(torch.equal(rk, rp), "B10 kernel and plain version draw different "
          f"pairs ({int((rk != rp).sum())} slots)")
    pair = torch.where(rk < 0, -rk - 1, rk)
    check(int(pair.min()) >= 0 and int(pair.max()) < n * n, "B10 pair range")
    resolved = sampler.resolve_borrow(rk)
    stride = bitmap_stride_bits(n) // 8
    bytes_ = bitmap.view(torch.uint8)
    key = ct.long()[:, None] * stride + (resolved.long() >> 3)
    still = ((bytes_[key].int() >> (resolved & 7)) & 1) != 0
    valid = graph["dd_valid"].reshape(rk.shape) > 0
    rep = {"max_abs_err": 0.0, "equal": True,
           "draws_per_slot": sampler.draws_per_slot(n),
           "flagged": int((rk < 0).sum()), "slots": rk.numel(),
           "residual_positives": int(still.sum()),
           "residual_positives_valid_slots": int((still & valid).sum())}
    if not timed:
        return rep
    rep["ms"] = cuda_ms(lambda: sampler.typed_negative_sampling_cuda(
        seed, ct, bitmap, n, chunk), reps=50, primed=True)
    rep["resolve_ms"] = cuda_ms(lambda: sampler.resolve_borrow(rk), reps=20,
                                primed=True)
    rep["plain_ms"] = cuda_ms(lambda: sampler.typed_negative_sampling_plain(
        seed, ct, bitmap, n, chunk), reps=3, warmup=1)
    rep["library_ms"] = None  # no single PyTorch call computes it
    touched = torch.unique(ct.long()[:, None] * stride + (pair.long() >> 3))
    rep.update(bound(nbytes(ct, rk) + touched.numel(),
                     rk.numel() * sampler.draws_per_slot(n)))
    rep["bitmap_bytes_touched"] = touched.numel()
    return rep


def dense_bce_nn_oracle(args, da, mode: str, chunk: int = 64):
    """float64 oracle of the NN decoder's estimator in its two deterministic
    threshold modes: q = 0 (no negatives) and q = 2^24 (count 3 on every
    non-positive cell).  args: (w1, w2, h1, h2); da: uint8 numpy [R, n, n].
    Returns (value, [dw1, dw2, dh1, dh2])."""
    import torch

    w1, w2, h1, h2 = (a.double() for a in args)
    dev = h1.device
    val = torch.zeros((), dtype=torch.float64, device=dev)
    rows = torch.zeros((da.shape[0], da.shape[1]), dtype=torch.float64,
                       device=dev)
    cols = torch.zeros_like(rows)
    s1, s2 = h1 @ w1.T, h2 @ w2.T  # [n, R]
    for c0 in range(0, da.shape[0], chunk):
        dac = torch.from_numpy(da[c0:c0 + chunk]).to(dev).double()
        L = s2[:, c0:c0 + chunk].T[:, :, None] + s1[:, c0:c0 + chunk].T[:, None, :]
        sp = torch.nn.functional.softplus(-L, threshold=1e9)
        cnt = (torch.zeros_like(L) if mode == "positives_only"
               else 3.0 * (dac == 0))
        val += (sp * dac + (sp + L) * cnt).sum()
        g = cnt - (dac + cnt) * torch.sigmoid(-L)
        rows[c0:c0 + chunk], cols[c0:c0 + chunk] = g.sum(2), g.sum(1)
    return val, [cols @ h1, rows @ h2, cols.T @ w1, rows.T @ w2]


def _frac_errs(got, want) -> list:
    """max |got - want| / max |want| of each pair."""
    return [float((a.double() - b.double()).abs().max() / b.double().abs().max())
            for a, b in zip(got, want)]


def check_dense_bce_nn_shapes(dev) -> list:
    """B3 against its plain version on small random pages whose row tiles
    and column strips are ragged (n = 100: one partial tile; n = 1,000: two
    column strips of the kernel), with the main check's tolerances."""
    import numpy as np
    import torch

    from tip_tpu_torch.ops import dense_bce_nn as bce

    rng = np.random.default_rng(12)
    out = []
    for n, r in ((100, 5), (1000, 3)):
        pages = torch.from_numpy(
            (rng.random((r, n, n)) < 0.05).astype(np.uint8)).to(dev)
        q = torch.from_numpy(
            rng.integers(0, 1 << 22, (r, 3)).astype(np.int32)).to(dev)
        args = [torch.from_numpy(a).float().to(dev) for a in (
            0.4 * rng.standard_normal((r, 16)), 0.4 * rng.standard_normal((r, 16)),
            np.maximum(rng.standard_normal((n, 16)), 0),
            np.maximum(rng.standard_normal((n, 16)), 0))]
        lk, *gk = bce.dense_bce_nn_cuda(*args, pages, q, 5, True)
        lp, *gp = bce.dense_bce_nn_plain(*args, pages, q, 5, True)
        vk = bce.dense_bce_nn_cuda(*args, pages, q, 5, False)
        rel = abs(float(lk) - float(lp)) / abs(float(lp))
        errs = _frac_errs(gk, gp)
        check(rel < 1e-5, f"B3 n={n} R={r} loss rel err {rel}")
        check(max(errs) <= 1e-3, f"B3 n={n} R={r} grads {errs}")
        check(float(vk) == float(lk), f"B3 n={n} R={r} value-only != fused")
        out.append({"shape": f"n={n} R={r}", "loss_rel_err": rel,
                    "grad_err_frac": errs})
    return out


def check_dense_bce_nn(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B3 against its plain version and the float64 oracle on DR-NN's
    dense graph (the uint8 pages and thresholds make_dd_graph_arrays ships
    beside the strips for the NN decoder; R = 1097, n = 645, l1 = 16), then
    on the bf16 and float32 pages of the same counts (DR-NN's pages
    layout), where it must give the uint8 pages' result bit for bit (a cell
    is read as float) and agree with the plain version."""
    import torch

    from tip_tpu_torch.data.packing import (
        cast_dense_adj, dense_relation_adj, poisson_neg_thresholds,
    )
    from tip_tpu_torch.ops import dense_bce_nn as bce
    from tip_tpu_torch.train.model import pages_tensor

    n = data.n_drug
    da = cast_dense_adj(dense_relation_adj(data.dd_train, n), "uint8")
    pages = torch.from_numpy(da).to(dev)
    q = torch.from_numpy(poisson_neg_thresholds(data.dd_train, n)).to(dev)
    n_et, d = data.n_et, bce.D
    gen = torch.Generator().manual_seed(8)
    args = [(0.4 * torch.randn(n_et, d, generator=gen)).to(dev),
            (0.4 * torch.randn(n_et, d, generator=gen)).to(dev),
            torch.relu(torch.randn(n, d, generator=gen)).to(dev),
            torch.relu(torch.randn(n, d, generator=gen)).to(dev)]
    seed = 12345
    rep = {}

    # hashed field: kernel against the plain version, same field.  Per-
    # block partial sums vs torch reductions: f32 order only
    loss_k, *grads_k = bce.dense_bce_nn_cuda(*args, pages, q, seed, True)
    loss_p, *grads_p = bce.dense_bce_nn_plain(*args, pages, q, seed, True)
    torch.cuda.synchronize()
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = _frac_errs(grads_k, grads_p)
    check(rel < 1e-5, f"B3 loss vs plain: rel err {rel}")
    check(max(errs) <= 1e-3, f"B3 grads vs plain (dw1, dw2, dh1, dh2): {errs}")
    rep.update(loss=float(loss_k), loss_rel_err=rel, grad_err_frac=errs,
               max_abs_err=max(max_err(a, b)[0]
                               for a, b in zip(grads_k, grads_p)))
    val_only = bce.dense_bce_nn_cuda(*args, pages, q, seed, False)
    check(float(val_only) == float(loss_k),
          f"B3 value-only {float(val_only)!r} != fused {float(loss_k)!r}")
    check(torch.equal(bce.dense_bce_nn_cuda(*args, pages, q, seed, True)[1],
                      grads_k[0]), "B3 is not deterministic")
    rep["other_shapes"] = check_dense_bce_nn_shapes(dev)

    # deterministic modes against the float64 oracle
    for mode, qv in (("positives_only", 0), ("saturated", 1 << 24)):
        lk, *gk = bce.dense_bce_nn_cuda(*args, pages, torch.full_like(q, qv),
                                        seed, True)
        ov, og = dense_bce_nn_oracle(args, da, mode)
        vrel = abs(float(lk) - float(ov)) / abs(float(ov))
        e = _frac_errs(gk, og)
        check(vrel < 1e-4, f"B3 {mode} value rel err {vrel}")
        check(max(e) < 1e-3, f"B3 {mode} grads {e}")
        rep[mode] = {"value_rel_err": vrel, "grad_err_frac": e}

    # first-order descent: the fused gradients predict the value-only drop
    g2 = sum(float((g.double() ** 2).sum()) for g in grads_k)
    lr = 1e-4 * abs(float(loss_k)) / g2  # a predicted drop of 1e-4 of the loss
    after = bce.dense_bce_nn_cuda(*[a - lr * g for a, g in zip(args, grads_k)],
                                  pages, q, seed, False)
    drop = float(loss_k) - float(after)
    check(abs(drop - lr * g2) < 0.2 * lr * g2, f"B3 descent {drop} vs {lr * g2}")
    rep["descent"] = {"drop": drop, "predicted": lr * g2}

    # the bf16 and float32 pages of DR-NN's pages layout
    float_pages = []
    for dtype in ("bfloat16", "float32"):
        pg = pages_tensor(da, dtype, dev)
        lk, *gk = bce.dense_bce_nn_cuda(*args, pg, q, seed, True)
        check(float(lk) == float(loss_k) and all(
            torch.equal(a, b) for a, b in zip(gk, grads_k)),
            f"B3 on {dtype} pages differs from the uint8 pages")
        lp, *gp = bce.dense_bce_nn_plain(*args, pg, q, seed, True)
        prel = abs(float(lk) - float(lp)) / abs(float(lp))
        perrs = _frac_errs(gk, gp)
        check(prel < 1e-5 and max(perrs) <= 1e-3,
              f"B3 {dtype} pages vs plain: {prel}, {perrs}")
        rep[dtype] = {"equals_uint8": True, "loss_rel_err": prel,
                      "grad_err_frac": perrs}
        float_pages.append((dtype, pg))
    if not timed:
        return rep

    # bound: each input read once, each output written once; ~25 float
    # operations a cell (outer sum, softplus, sigmoid, counts, G, the two
    # running sums) plus the O(R n l1) score and gradient contractions
    cells = n_et * n * n
    flops = 25 * cells + 2 * 4 * n_et * n * d
    out_bytes = 4 * (1 + sum(a.numel() for a in args))
    rep["cells"] = cells
    for dtype, pg in (("uint8", pages), *float_pages):
        r = rep if dtype == "uint8" else rep[dtype]
        r["ms"] = cuda_ms(lambda: bce.dense_bce_nn_cuda(
            *args, pg, q, seed, True), reps=20, primed=True)
        r["value_only_ms"] = cuda_ms(lambda: bce.dense_bce_nn_cuda(
            *args, pg, q, seed, False), reps=20, primed=True)
        r["plain_ms"] = cuda_ms(lambda: bce.dense_bce_nn_plain(
            *args, pg, q, seed, True), reps=3, warmup=1)
        r.update(bound(nbytes(pg, q, *args) + out_bytes, flops))
    rep["library_ms"] = None  # no single PyTorch call computes it
    return rep


def check_nn_sddmm(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B9 forward (logits) and backward (dh1, dh2, dw1, dw2) against
    the plain version at l1 = 16, the backward's per-relation vectors where
    the wrapper puts them for this graph (shared memory up to 29,055 nodes)
    and forced to global memory, in float32 and with bf16 rounding.  Logits are
    compared on valid slots (a pad slot scores its pad src); with h1 = 0 the
    pad slots' logits (their dst terms) must be exactly 0.  Float32 order
    only: 1e-5 of the largest logit, 1e-4 of the largest gradient."""
    import torch

    from tip_tpu_torch.ops import sddmm2
    from tip_tpu_torch.ops.matmul import bf16_round

    src2d, dst2d, ct = graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"]
    d, n, n_et = sddmm2.D, gs.n_drug, gs.n_et
    gen = torch.Generator().manual_seed(24)
    h1, h2 = (torch.relu(torch.randn(n, d, generator=gen)).to(dev)
              for _ in range(2))
    w1, w2 = ((0.3 * torch.randn(n_et, d, generator=gen)).to(dev)
              for _ in range(2))
    g = torch.randn(src2d.shape, generator=gen).to(dev)
    valid = graph["dd_valid"].reshape(src2d.shape) > 0
    pad = ~valid
    bufs = (src2d, dst2d, ct)
    rep = {"d": d, "shared": sddmm2.nn_shared_fits(n),
           "pad_slots": int(pad.sum())}
    worst = 0.0
    for bf16 in (False, True):
        hr = [bf16_round(h) if bf16 else h for h in (h1, h2)]  # compute_round
        args = (*hr, w1, w2, *bufs)
        lp = sddmm2.nn_logits_plain(*args)
        gp = sddmm2.nn_bwd_plain(*args, g, bf16)
        for table in (None, "global"):
            tag = ("bf16_" if bf16 else "") + (table or "auto")
            lk = sddmm2.nn_logits_cuda(*args)
            gk = sddmm2.nn_bwd_cuda(*args, g, bf16, table=table)
            el, ml = max_err(lk[valid], lp[valid])
            check(el <= 1e-5 * ml, f"B9 {tag} logits err {el} of max {ml}")
            errs = _frac_errs(gk, gp)
            check(max(errs) <= 1e-4, f"B9 {tag} grads (dh1, dh2, dw1, dw2) "
                  f"err {errs} of their max")
            l0 = sddmm2.nn_logits_cuda(torch.zeros_like(hr[0]), *args[1:])
            check(bool((l0[pad] == 0).all()), f"B9 {tag} pad dst terms not 0")
            rep[tag] = {"logit_max_abs_err": el, "grad_err_frac": errs}
            worst = max(worst, el, *(max_err(a, b)[0] for a, b in zip(gk, gp)))
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    args = (h1, h2, w1, w2, *bufs)
    rep["ms"] = cuda_ms(lambda: sddmm2.nn_logits_cuda(*args), reps=20,
                        primed=True)
    rep["bwd_ms"] = cuda_ms(lambda: sddmm2.nn_bwd_cuda(*args, g), reps=20,
                            primed=True)
    rep["bwd_global_ms"] = cuda_ms(lambda: sddmm2.nn_bwd_cuda(
        *args, g, table="global"), reps=20, primed=True)
    rep["bwd_bf16_ms"] = cuda_ms(lambda: sddmm2.nn_bwd_cuda(
        *args, g, True), reps=5, primed=True)
    rep["plain_ms"] = cuda_ms(lambda: sddmm2.nn_logits_plain(*args), reps=3,
                              warmup=1)
    rep["bwd_plain_ms"] = cuda_ms(lambda: sddmm2.nn_bwd_plain(*args, g),
                                  reps=3, warmup=1)
    rep["library_ms"] = None  # no single PyTorch call computes it
    slots = src2d.numel()
    fwd = bound(nbytes(*bufs, h1, h2, w1, w2) + 4 * slots, 4 * d * slots)
    bwd = bound(nbytes(*bufs, g, h1, h2, w1, w2) + nbytes(h1, h2, w1, w2),
                4 * d * slots)
    rep.update(fwd)
    rep.update(bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
               slots=slots)
    return rep


def check_distmult_sddmm_v1(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B6 forward (logits) and backward (dz, dw) against the plain
    version at d = 16, with its tables where the wrapper puts them for this
    graph (shared memory up to 3,417 nodes forward and 3,402 backward,
    global memory past that) and forced to global memory, in float32 and
    with the bf16 rounding of z and of each scattered contribution; pad
    logits must be exactly 0.  Float32 order only: 1e-5 of the largest
    logit, 1e-4 of the largest dz and dw.  Then B6 against B8 in float32:
    the same logits on valid slots, bit for bit (B6 launches B8's forward,
    csrc/distmult_fwd.cuh), and the same grads under a masked cotangent
    within 1e-4 (products taken in another order)."""
    import torch

    from tip_tpu_torch.ops import sddmm2
    from tip_tpu_torch.ops import typed_segment as ts
    from tip_tpu_torch.ops.matmul import bf16_round

    bufs = (graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"])
    d, n = ts.D, gs.n_drug
    gen = torch.Generator().manual_seed(25)
    z = (0.5 * torch.randn(n, d, generator=gen)).to(dev)
    w = (0.3 * torch.randn(gs.n_et, d, generator=gen)).to(dev)
    g = torch.randn(bufs[0].shape, generator=gen).to(dev)
    valid = graph["dd_valid"].reshape(bufs[0].shape) > 0
    rep = {"d": d, "fwd_shared": ts.v1_shared_fits(n, 1, False),
           "bwd_shared": ts.v1_shared_fits(n, 1, True),
           "pad_slots": int((~valid).sum())}
    worst = 0.0
    for bf16 in (False, True):
        zr = bf16_round(z) if bf16 else z  # the wrapper's compute_round
        args = (zr, w, *bufs)
        lp = ts.distmult_v1_fwd_plain(*args)
        dzp, dwp = ts.distmult_v1_bwd_plain(*args, g, bf16)
        for table in (None, "global"):
            tag = ("bf16_" if bf16 else "") + (table or "auto")
            lk = ts.distmult_v1_fwd_cuda(*args, table=table)
            dzk, dwk = ts.distmult_v1_bwd_cuda(*args, g, bf16, table=table)
            el, ml = max_err(lk, lp)
            ez, mz = max_err(dzk, dzp)
            ew, mw = max_err(dwk, dwp)
            check(el <= 1e-5 * ml, f"B6 {tag} logits err {el} of max {ml}")
            check(ez <= 1e-4 * mz and ew <= 1e-4 * mw,
                  f"B6 {tag} grads err {ez} of {mz}, {ew} of {mw}")
            check(bool((lk[~valid] == 0).all()), f"B6 {tag} pad logits not 0")
            rep[tag] = {"logit_max_abs_err": el, "dz_max_abs_err": ez,
                        "dw_max_abs_err": ew}
            worst = max(worst, el, ez, ew)
    # v1 against v2 (B8) in float32
    args = (z, w, *bufs)
    gm = g * valid
    l1, l2 = ts.distmult_v1_fwd_cuda(*args), sddmm2.distmult_logits_cuda(*args)
    check(torch.equal(l1[valid], l2[valid]), "B6 and B8 logits differ")
    errs = _frac_errs(ts.distmult_v1_bwd_cuda(*args, gm),
                      sddmm2.distmult_bwd_cuda(*args, gm))
    check(max(errs) <= 1e-4, f"B6 vs B8 grads (dz, dw) {errs} of their max")
    rep["vs_v2"] = {"logits_equal": True, "grad_err_frac": errs}
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    rep["ms"] = cuda_ms(lambda: ts.distmult_v1_fwd_cuda(*args), reps=20,
                        primed=True)
    rep["bwd_ms"] = cuda_ms(lambda: ts.distmult_v1_bwd_cuda(*args, g),
                            reps=20, primed=True)
    rep["global_ms"] = cuda_ms(lambda: ts.distmult_v1_fwd_cuda(
        *args, table="global"), reps=20, primed=True)
    rep["bwd_global_ms"] = cuda_ms(lambda: ts.distmult_v1_bwd_cuda(
        *args, g, table="global"), reps=20, primed=True)
    rep["plain_ms"] = cuda_ms(lambda: ts.distmult_v1_fwd_plain(*args),
                              reps=3, warmup=1)
    rep["bwd_plain_ms"] = cuda_ms(lambda: ts.distmult_v1_bwd_plain(*args, g),
                                  reps=3, warmup=1)
    rep["library_ms"] = None  # no single PyTorch call computes it
    slots = bufs[0].numel()
    fwd = bound(nbytes(*bufs, z, w) + 4 * slots, 3 * d * slots)
    bwd = bound(nbytes(*bufs, z, w, g) + nbytes(z, w), 9 * d * slots)
    rep.update(fwd)
    rep.update(bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
               slots=slots)
    return rep


def check_nn_sddmm_v1(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B7 forward (logits) and backward (dh1, dh2, dw1, dw2) against
    the plain version at l1 = 16, with its tables where the wrapper puts
    them for this graph (shared memory up to 1,708 nodes forward and 1,693
    backward) and forced to global memory, in float32 and with bf16
    rounding.  Logits are compared on every slot (a pad slot scores its pad
    src alike in both); with h1 = 0 the pad slots' logits (their dst terms)
    must be exactly 0.  Float32 order only: 1e-5 of the largest logit, 1e-4
    of the largest gradient.  Then B7 against B9 in float32 on valid slots
    (the same sums in another order: 1e-5 and 1e-4 of their max)."""
    import torch

    from tip_tpu_torch.ops import sddmm2
    from tip_tpu_torch.ops import typed_segment as ts
    from tip_tpu_torch.ops.matmul import bf16_round

    bufs = (graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"])
    d, n, n_et = ts.D, gs.n_drug, gs.n_et
    gen = torch.Generator().manual_seed(26)
    h1, h2 = (torch.relu(torch.randn(n, d, generator=gen)).to(dev)
              for _ in range(2))
    w1, w2 = ((0.3 * torch.randn(n_et, d, generator=gen)).to(dev)
              for _ in range(2))
    g = torch.randn(bufs[0].shape, generator=gen).to(dev)
    valid = graph["dd_valid"].reshape(bufs[0].shape) > 0
    rep = {"d": d, "fwd_shared": ts.v1_shared_fits(n, 2, False),
           "bwd_shared": ts.v1_shared_fits(n, 2, True),
           "pad_slots": int((~valid).sum())}
    worst = 0.0
    for bf16 in (False, True):
        hr = [bf16_round(h) if bf16 else h for h in (h1, h2)]
        args = (*hr, w1, w2, *bufs)
        lp = ts.nn_v1_fwd_plain(*args)
        gp = ts.nn_v1_bwd_plain(*args, g, bf16)
        for table in (None, "global"):
            tag = ("bf16_" if bf16 else "") + (table or "auto")
            lk = ts.nn_v1_fwd_cuda(*args, table=table)
            gk = ts.nn_v1_bwd_cuda(*args, g, bf16, table=table)
            el, ml = max_err(lk, lp)
            check(el <= 1e-5 * ml, f"B7 {tag} logits err {el} of max {ml}")
            errs = _frac_errs(gk, gp)
            check(max(errs) <= 1e-4, f"B7 {tag} grads (dh1, dh2, dw1, dw2) "
                  f"err {errs} of their max")
            l0 = ts.nn_v1_fwd_cuda(torch.zeros_like(hr[0]), *args[1:],
                                   table=table)
            check(bool((l0[~valid] == 0).all()), f"B7 {tag} pad dst terms not 0")
            rep[tag] = {"logit_max_abs_err": el, "grad_err_frac": errs}
            worst = max(worst, el, *(max_err(a, b)[0] for a, b in zip(gk, gp)))
    # v1 against v2 (B9) in float32
    args = (h1, h2, w1, w2, *bufs)
    gm = g * valid
    el, ml = max_err(ts.nn_v1_fwd_cuda(*args)[valid],
                     sddmm2.nn_logits_cuda(*args)[valid])
    check(el <= 1e-5 * ml, f"B7 vs B9 logits err {el} of max {ml}")
    errs = _frac_errs(ts.nn_v1_bwd_cuda(*args, gm), sddmm2.nn_bwd_cuda(*args, gm))
    check(max(errs) <= 1e-4, f"B7 vs B9 grads {errs} of their max")
    rep["vs_v2"] = {"logit_max_abs_err": el, "grad_err_frac": errs}
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    rep["ms"] = cuda_ms(lambda: ts.nn_v1_fwd_cuda(*args), reps=20, primed=True)
    rep["bwd_ms"] = cuda_ms(lambda: ts.nn_v1_bwd_cuda(*args, g), reps=20,
                            primed=True)
    rep["global_ms"] = cuda_ms(lambda: ts.nn_v1_fwd_cuda(
        *args, table="global"), reps=20, primed=True)
    rep["bwd_global_ms"] = cuda_ms(lambda: ts.nn_v1_bwd_cuda(
        *args, g, table="global"), reps=20, primed=True)
    rep["bwd_bf16_ms"] = cuda_ms(lambda: ts.nn_v1_bwd_cuda(*args, g, True),
                                 reps=20, primed=True)
    rep["plain_ms"] = cuda_ms(lambda: ts.nn_v1_fwd_plain(*args), reps=3,
                              warmup=1)
    rep["bwd_plain_ms"] = cuda_ms(lambda: ts.nn_v1_bwd_plain(*args, g),
                                  reps=3, warmup=1)
    rep["library_ms"] = None  # no single PyTorch call computes it
    slots = bufs[0].numel()
    fwd = bound(nbytes(*bufs, h1, h2, w1, w2) + 4 * slots, 4 * d * slots)
    bwd = bound(nbytes(*bufs, g, h1, h2, w1, w2) + nbytes(h1, h2, w1, w2),
                6 * d * slots)
    rep.update(fwd)
    rep.update(bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
               slots=slots)
    return rep


# name -> (the layout whose kernel checks run it, its check)
KERNEL_CHECKS = {
    "dense_bce_sym": ("dense", check_dense_bce_sym),
    "dense_bce": ("dense", check_dense_bce),
    "typed_neighbor_sum": ("chunked", check_typed_neighbor_sum),
    "gcn_spmm": ("chunked", check_gcn_spmm),
    "distmult_sddmm": ("chunked", check_distmult_sddmm),
    "typed_neg_sampler": ("chunked", check_typed_neg_sampler),
    "dense_bce_nn": ("dense", check_dense_bce_nn),
    "nn_sddmm": ("chunked", check_nn_sddmm),
    "distmult_sddmm_v1": ("chunked", check_distmult_sddmm_v1),
    "nn_sddmm_v1": ("chunked", check_nn_sddmm_v1),
}


def run_checks(layout: str, tag: str, graph, gs, data, dev, timed: bool = True
               ) -> dict:
    """Run the checks of the kernels of one layout on one packed graph and
    print each report; returns {name: report}."""
    out = {}
    for name, (lay, fn) in KERNEL_CHECKS.items():
        if lay == layout:
            out[name] = fn(graph, gs, data, dev, timed)
            print(f"kernel {name} [{tag}]:", json.dumps(out[name]))
    return out


def check_small_slice_cpu_vs_gpu(dev, dense_dtype, model_kind: str = "tip",
                                 negatives: str = "auto",
                                 pp_dense=None) -> dict:
    """The training loss and its gradients on a small graph, on the GPU
    (kernels) and on the CPU (plain versions) with the same parameters and
    seed: TIP-cat (``model_kind="tip"``), TIP-cat with the NN decoder
    (``"tip-nn"``), DR-NN (``"dr-nn"``) or DR-DF (``"dr-df"``), with
    ``negatives``.  The hashed fields (B1's, B2's and
    B3's cells, B10's draws) are the same on both, so only f32 order and,
    on the strips, bf16 re-rounding of activations differ: loss rtol 1e-3
    and grads 2e-2 of their max on the strips, loss rtol 1e-5 and grads
    1e-4 of their max on the float32 pages and the chunked layout (f32
    throughout).  TIP's dense P-P GCN rounds its operands to bf16 on any
    D-D layout, as the JAX package's does, so TIP on the float32 pages is
    f32 throughout only with the windowed P-P side (``pp_dense=False``,
    kernel B5); ``pp_dense`` goes to make_graph_arrays."""
    import dataclasses

    import torch

    from tip_tpu_torch import convert
    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
    from tip_tpu_torch.models.dd import DDConfig, DDModel, make_dd_graph_arrays
    from tip_tpu_torch.train.model import TIP, make_graph_arrays

    data = build_trigraph(synthetic_trigraph(
        n_drug=200, n_prot=300, n_et=7, pairs_per_et=200, seed=5), 0.9, 5)
    sampled = negatives == "sampled"
    out = {}
    params_np = None
    for name in ("cpu", "cuda"):
        if model_kind in ("tip", "tip-nn"):
            decoder = "nn" if model_kind == "tip-nn" else "distmult"
            graph, gs = make_graph_arrays(data, device=name,
                                          dense_dtype=dense_dtype,
                                          sampled=sampled, pp_dense=pp_dense,
                                          decoder=decoder)
            cfg = dataclasses.replace(ModelConfig.tip_cat(), negatives=negatives,
                                      decoder=decoder)
            model = TIP.for_data(cfg, data, gs, device=name)
        else:
            decoder = "nn" if model_kind == "dr-nn" else "distmult"
            graph, gs = make_dd_graph_arrays(data, name, dense_dtype=dense_dtype,
                                             decoder=decoder, sampled=sampled)
            model = DDModel.for_data(DDConfig(decoder=decoder,
                                              negatives=negatives), gs, name)
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
    f32 = gs.dd_layout == "chunked" or dense_dtype == "float32"
    loss_tol, grad_tol = (1e-5, 1e-4) if f32 else (1e-3, 2e-2)
    what = f"{model_kind} {gs.dd_layout} {negatives}"
    check(abs(lg - lc) <= loss_tol * abs(lc), f"{what} slice loss gpu {lg} cpu {lc}")
    worst = 0.0
    for a, b in zip(gg, gc):
        frac = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, frac)
    check(worst < grad_tol, f"{what} slice grads gpu vs cpu: {worst} of max")
    return {"model": model_kind, "layout": gs.dd_layout, "negatives": negatives,
            "pp_layout": gs.pp_layout, "loss_gpu": lg, "loss_cpu": lc,
            "grad_err_frac": worst}


def profile_steps(model, graph, steps: int = 3, warmup: int = 2) -> dict:
    """Device time by kernel over a few training steps of ``model`` (the
    loops' step: loss, backward, Adam), from torch.profiler; wall time from
    the host clock around the synchronised window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tip_tpu_torch import convert
    from tip_tpu_torch.train.loop import step_seed

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


def graph_summary(data, build_sec: float) -> dict:
    return {"n_drug": data.n_drug, "n_prot": data.n_prot, "n_et": data.n_et,
            "dd_train_edges": data.dd_train.n_edges,
            "dd_test_edges": data.dd_test.n_edges,
            "pp_train_edges": int(data.pp_train.shape[1]),
            "dp_edges": int(data.dp_edge_index.shape[1]),
            "build_sec": build_sec}


def expected_launches(path: str, steps: int) -> dict:
    """Launches of each kernel in ``steps`` training steps plus the final
    eval, per path.  TIP dense: B1 once a step.  TIP pages: B2 once a step.
    TIP strips sampled: B10 once and B8 twice (the negatives' forward and
    backward; the positives are scored over the full pages in PyTorch).
    TIP chunked: B10 once, B8 twice forward (positives, negatives) and
    twice backward, B4 and B5 once forward and once backward in each of two
    layers; the eval's encode adds a forward of each layer of B4 and B5.
    TIP-NN (TIP-cat with the NN decoder, the sampled route on every
    layout) dense: B10 once and B9 four times a step (the positives' and
    the negatives' forward and backward; the encoder's strips and the
    eval's flat scoring launch nothing); TIP-NN chunked: as TIP chunked
    with B9 for B8.  DR-NN dense: B3 once a step (its fused pass); DR-NN
    pages: the same on the float32 pages.  DR-NN chunked: as TIP chunked
    with B9 for B8 and no P-P side (no B5).  DR-DF dense: B1 once a step;
    DR-DF pages: B2 once a step.  PR-HMP-NN and PP-GAE run no kernel."""
    return {
        "tip dense": {"dense_bce_sym": steps},
        "tip pages": {"dense_bce": steps},
        "tip strips sampled": {"typed_neg_sampler": steps,
                               "distmult_sddmm": 2 * steps},
        "tip chunked": {"typed_neg_sampler": steps, "distmult_sddmm": 4 * steps,
                        "typed_neighbor_sum": 4 * steps + 2,
                        "gcn_spmm": 4 * steps + 2},
        "tip-nn dense": {"typed_neg_sampler": steps, "nn_sddmm": 4 * steps},
        "tip-nn chunked": {"typed_neg_sampler": steps, "nn_sddmm": 4 * steps,
                           "typed_neighbor_sum": 4 * steps + 2,
                           "gcn_spmm": 4 * steps + 2},
        "dr-nn dense": {"dense_bce_nn": steps},
        "dr-nn pages": {"dense_bce_nn": steps},
        "dr-nn chunked": {"typed_neg_sampler": steps, "nn_sddmm": 4 * steps,
                          "typed_neighbor_sum": 4 * steps + 2},
        "dr-df dense": {"dense_bce_sym": steps},
        "dr-df pages": {"dense_bce": steps},
        "pr-hmp-nn flat": {},
        "pp-gae dense": {},
    }[path]


def check_result(path: str, steps: int, n_rel: int, result, launches) -> None:
    """Finite losses, metrics in [0, 1] per relation, and exactly the
    expected kernel launches."""
    import numpy as np

    from tip_tpu_torch import kernels

    losses = [h["loss"] for h in result["history"]]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{path} train losses {losses}")
    for k in ("auprc", "auroc", "ap"):
        v = result["final"][k]
        check(0.0 <= v <= 1.0, f"{path} metric {k} = {v}")
        per = result["per_relation"][k]
        check(per.shape == (n_rel,) and np.all((per >= 0) & (per <= 1)),
              f"{path} per-relation {k}")
    want = expected_launches(path, steps)
    for name in kernels.KERNELS:
        check(launches[name] == want.get(name, 0),
              f"{path} path launched {name} {launches[name]} times, "
              f"expected {want.get(name, 0)}")


def train_line(fields: dict, result, launches, peak: int) -> str:
    step_sec = sorted(h["sec"] for h in result["history"][1:])
    return "train: " + json.dumps({
        **fields, "losses": [h["loss"] for h in result["history"]],
        "final": result["final"], "launches": launches,
        "step_ms_median": 1e3 * step_sec[len(step_sec) // 2],
        "step_ms_all": [1e3 * h["sec"] for h in result["history"]],
        "peak_mem_bytes": peak,
    })


DD_DENSE_KEYS = ("dd_adj_sym", "dd_adj_t", "dd_adj_u8")


def run_path(path: str, data, dev, steps: int, dense_dtype,
             negatives: str = "auto", matmul_precision: str = "default",
             profiled: bool = True, decoder: str = "distmult") -> dict:
    """Train TIP-cat with ``decoder`` through train(), which picks the D-D
    layout for the graph and ``matmul_precision`` (``dense_dtype`` is the
    pick expected),
    with every launch counter at 0 just before and read just after; check
    losses, metrics and launches; print the train line (with the bytes of
    the graph's dense D-D tensors) and, with ``profiled``, the profile
    line.  Returns the launch counts."""
    import dataclasses

    import torch

    from tip_tpu_torch import kernels
    from tip_tpu_torch.config import ModelConfig, TrainConfig
    from tip_tpu_torch.train.loop import train
    from tip_tpu_torch.train.model import (
        TIP, make_graph_arrays, preferred_dense_dtype,
    )

    cfg = dataclasses.replace(ModelConfig.tip_cat(), negatives=negatives,
                              decoder=decoder)
    check(preferred_dense_dtype(data, cfg.kernel_dtype, matmul_precision)
          == dense_dtype, f"train() would not pick {dense_dtype} for {path}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _, result = train(cfg, TrainConfig(epochs=steps), data, log=print,
                      device=dev, matmul_precision=matmul_precision)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_result(path, steps, data.n_et, result, launches)
    graph, gs = make_graph_arrays(data, dev, dense_dtype=dense_dtype,
                                  sampled=negatives == "sampled",
                                  decoder=decoder)
    variant = "tip-cat" if decoder == "distmult" else "tip-cat-nn"
    fields = {"variant": variant, "path": path.split(" ", 1)[1],
              "dd_layout": gs.dd_layout,
              "dd_keys": sorted(k for k in graph if k.startswith("dd_")),
              "dd_dense_bytes": nbytes(*(graph[k] for k in DD_DENSE_KEYS
                                         if k in graph))}
    print(train_line(fields, result, launches, peak))
    if profiled:
        model = TIP.for_data(cfg, data, gs, dev)
        print("profile:", json.dumps({"variant": variant,
                                      "path": fields["path"],
                                      **profile_steps(model, graph)}))
    del graph
    torch.cuda.empty_cache()
    return launches


def run_variant(variant: str, data, dev, steps: int,
                profiled: bool = False,
                matmul_precision: str = "default") -> dict:
    """Train one model variant at full width (the default configs) through
    the models runner (build_variant, train_variant, with
    ``matmul_precision``) on ``dev``, with every launch counter at 0 just
    before train_variant and read just after; check losses, metrics and
    launches; print the train line and, with ``profiled``, a profile line.
    Returns the launch counts."""
    import torch

    from tip_tpu_torch import kernels
    from tip_tpu_torch.models.runner import build_variant, train_variant
    from tip_tpu_torch.train.model import preferred_dense_dtype

    t0 = time.time()
    model, graph, test = build_variant(variant, data, dev,
                                       matmul_precision=matmul_precision)
    build_sec = time.time() - t0
    if variant.startswith("dr-"):
        want = {None: "chunked", "bfloat16": "strips", "float32": "pages"}[
            preferred_dense_dtype(data, "float32", matmul_precision)]
        # DR-NN's strips layout is 'strips_pages'
        check(model.gs.dd_layout.startswith(want),
              f"{variant}: the runner did not pick the preferred layout")
        layout = "dense" if want == "strips" else want
        if layout == "pages":  # B2 and B3 read the encoder's pages
            check(graph["dd_adj_t"].dtype == torch.float32
                  and "dd_adj_u8" not in graph,
                  f"{variant} pages: not the float32 pages alone")
        n_rel = data.n_et
    else:
        layout = "flat" if variant == "pr-hmp-nn" else model.layout
        n_rel = data.n_et if variant == "pr-hmp-nn" else 1
    path = f"{variant} {layout}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _, result = train_variant(model, graph, test, epochs=steps, seed=1111,
                              log=print)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_result(path, steps, n_rel, result, launches)
    print(train_line({"variant": variant, "path": layout,
                      "dd_layout": model.gs.dd_layout if variant.startswith(
                          "dr-") else None,
                      "graph_build_sec": build_sec}, result, launches,
                     torch.cuda.max_memory_allocated()))
    if profiled:
        print("profile:", json.dumps({"variant": variant, "path": layout,
                                      **profile_steps(model, graph)}))
    del model, graph, test
    torch.cuda.empty_cache()
    return launches


AB_WARMUP, AB_REPS = 2, 10  # the decoder A/B's calls of each route


def run_decoder_ab(data, dev) -> dict:
    """The decoder A/B entry point (tip_tpu_torch/scripts/decoder_ab.py) at
    Decagon shape in float32, with every launch counter at 0 just before and
    read just after: B6, B7, B8 and B9 launch launches_per_route times
    each, B10 once a sampler call.  In float32 the v2 and gather routes'
    masked softplus sums agree with v1's within 1e-5.  Prints the
    decoder_ab line; returns the launch counts."""
    import torch

    from tip_tpu_torch import kernels
    from tip_tpu_torch.scripts import decoder_ab

    kernels.reset_launch_counts()
    res = decoder_ab.decoder_ab(data, "float32", dev, AB_WARMUP, AB_REPS)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    per_route = decoder_ab.launches_per_route(AB_WARMUP, AB_REPS)
    want = {"distmult_sddmm_v1": per_route, "distmult_sddmm": per_route,
            "nn_sddmm_v1": per_route, "nn_sddmm": per_route,
            "typed_neg_sampler": AB_WARMUP + AB_REPS}
    for name in kernels.KERNELS:
        check(launches[name] == want.get(name, 0),
              f"decoder ab launched {name} {launches[name]} times, expected "
              f"{want.get(name, 0)}")
    for decoder in ("distmult", "nn"):
        for route, row in res[decoder].items():
            check(row["rel_err_vs_v1"] <= 1e-5,
                  f"decoder ab {decoder} {route}: rel err {row['rel_err_vs_v1']}")
    print("decoder_ab:", json.dumps(res))
    return launches


# the path whose launches the kernels line reports for each kernel, and the
# kernel checks (graph and layout) at that path's shapes
KERNEL_PATH = {
    "dense_bce_sym": "tip dense",
    "dense_bce": "tip pages",
    "typed_neighbor_sum": "tip chunked",
    "gcn_spmm": "tip chunked",
    "distmult_sddmm": "tip chunked",
    "typed_neg_sampler": "tip chunked",
    "dense_bce_nn": "dr-nn dense",
    "nn_sddmm": "tip-nn dense",
    "distmult_sddmm_v1": "decoder ab",
    "nn_sddmm_v1": "decoder ab",
}
PATH_CHECKS = {"tip dense": "decagon_dense", "tip pages": "decagon_dense",
               "dr-nn dense": "decagon_dense", "tip chunked": "main",
               "tip-nn dense": "decagon_chunked",
               "decoder ab": "decagon_chunked"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tip_tpu_torch import kernels
    from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
    from tip_tpu_torch.ops.matmul import set_matmul_precision
    from tip_tpu_torch.scripts.decoder_ab import DECAGON_SHAPE
    from tip_tpu_torch.train.model import make_graph_arrays

    faulthandler.enable()  # a fault inside a kernel call still shows where
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

    for kind, dense_dtype, negatives, pp_dense in (
            ("tip", "bfloat16", "auto", None), ("tip", None, "auto", None),
            ("dr-nn", "bfloat16", "auto", None), ("dr-nn", None, "auto", None),
            ("tip", "float32", "auto", False), ("dr-df", "float32", "auto", None),
            ("tip", "bfloat16", "sampled", None),
            ("tip-nn", "bfloat16", "auto", None), ("tip-nn", None, "auto", None),
            ("dr-nn", "float32", "auto", None)):
        print("small slice gpu vs cpu:", json.dumps(check_small_slice_cpu_vs_gpu(
            dev, dense_dtype, kind, negatives, pp_dense)))

    t0 = time.time()
    data = build_trigraph(synthetic_trigraph(**DECAGON_SHAPE), 0.9, 1111)
    print("graph:", json.dumps(graph_summary(data, time.time() - t0)))
    checks = {}
    for layout, kw in (("dense", {"dense_dtype": "bfloat16"}),
                       ("chunked", {"dense_dtype": None, "pp_dense": False})):
        graph, gs = make_graph_arrays(data, dev, **kw)
        checks[f"decagon_{layout}"] = run_checks(layout, "decagon", graph, gs,
                                                 data, dev)
        del graph
        torch.cuda.empty_cache()

    launches = {"tip dense": run_path("tip dense", data, dev, TRAIN_STEPS,
                                      "bfloat16")}
    # float32 matmuls pinned: train() and the runner take the float32 pages
    launches["tip pages"] = run_path("tip pages", data, dev, TRAIN_STEPS,
                                     "float32", matmul_precision="highest")
    launches["tip strips sampled"] = run_path(
        "tip strips sampled", data, dev, OTHER_STEPS, "bfloat16",
        negatives="sampled", profiled=False)
    launches["tip-nn dense"] = run_path("tip-nn dense", data, dev, TRAIN_STEPS,
                                        "bfloat16", decoder="nn")
    launches["dr-nn dense"] = run_variant("dr-nn", data, dev, VARIANT_STEPS,
                                          profiled=True)
    launches["dr-nn pages"] = run_variant("dr-nn", data, dev, OTHER_STEPS,
                                          matmul_precision="highest")
    for variant in ("dr-df", "pr-hmp-nn", "pp-gae"):
        run_variant(variant, data, dev, OTHER_STEPS)
    run_variant("dr-df", data, dev, OTHER_STEPS, matmul_precision="highest")
    launches["decoder ab"] = run_decoder_ab(data, dev)
    del data
    # the chunked kernels at the shapes of the chunked path (main) and, on
    # a graph too wide for any shared-memory table, through their
    # global-memory modes and B10's two-draw mode (wide, untimed)
    built = {}
    for name, kw in (("big", BEYOND_DENSE), ("wide", WIDE)):
        t0 = time.time()
        built[name] = build_trigraph(synthetic_trigraph(**kw), 0.9, 1111)
        print("graph:", json.dumps(graph_summary(built[name], time.time() - t0)))
    big, wide = built.pop("big"), built.pop("wide")
    for tag, g, timed in (("main", big, True), ("wide", wide, False)):
        graph, gs = make_graph_arrays(g, dev, dense_dtype=None)
        checks[tag] = run_checks("chunked", tag, graph, gs, g, dev, timed)
        del graph
        torch.cuda.empty_cache()
    del wide
    launches["tip chunked"] = run_path("tip chunked", big, dev, TRAIN_STEPS,
                                       None)
    launches["tip-nn chunked"] = run_path("tip-nn chunked", big, dev,
                                          TRAIN_STEPS, None, decoder="nn")
    launches["dr-nn chunked"] = run_variant("dr-nn", big, dev, VARIANT_STEPS,
                                            profiled=True)

    entries = []
    for name, spec in kernels.KERNELS.items():
        c = checks[PATH_CHECKS[KERNEL_PATH[name]]][name]
        entries.append({
            "name": name, "route": spec.route, "source": spec.source,
            "replaces": spec.replaces,
            "launches": launches[KERNEL_PATH[name]][name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    print(f"total {time.time() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
