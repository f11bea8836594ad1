#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tip_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each fatal on failure:
  1. print the card (nvidia-smi name and power limit) and torch/CUDA versions;
  2. build every CUDA kernel from tip_tpu_torch/csrc with nvcc, in parallel,
     and the native packing library (tip_tpu_torch/native) with g++;
  3. hold the whole training loss and its gradients on the GPU against the
     same slice on the CPU, on a small graph: TIP-cat and DR-NN on the
     strips and the chunked layout, TIP-cat and DR-DF on the float32 full
     pages, TIP-cat with sampled negatives on the strips, TIP-cat with the
     NN decoder on the strips and chunked, DR-NN on the float32 pages;
  3b. the data and analysis layers (run_data_path): BioSNAP-shaped CSVs at
     Decagon's sizes, written from a seed, through preprocess_decagon, the
     --et-band selection, load_decagon_raw and cached_trigraph (cold, then
     warm: equal graphs), then the training CLI with --et-band and
     --report on the dense strips (B1 once a step), the report's rows
     against the result, and the Dice matrix of 645 x 32,768 folded counts
     on the card, bit-equal to the CPU's; a ``data:`` line;
  4. build a Decagon-shaped synthetic tri-graph (645 drugs, 19,081
     proteins, 1,097 relations) and pack it on the host through the native
     packing library (tip_tpu_torch/native) and through its plain numpy
     versions, bit-equal, a ``native:`` line with the seconds of each
     (run_native_packing); pack it in both layouts, and hold each
     kernel against its plain PyTorch version (KERNEL_CHECKS: B12 on the
     dense P-P (A+I) at both GCN widths, forward and backward; B1 on the
     dense strips, B2 on the full float32 and bf16 pages and B3 on DR-NN's
     uint8, bf16 and float32 pages, the dense paths' shapes, B2 and B3
     also on float32 pages holding counts past 256; B4-B10 on the
     chunked buffers, B6 and B7 also against B8 and B9; on the strips
     at CompGCN's width 200 B16 forward and backward, in units of 2^-24
     sum|terms| with a planted two-term backward above its bound, and B1's
     wide instance (d = 200) against a float64 oracle, value-only equal to
     fused, two runs bit-equal, a NaN in z reaching the loss); then Decagon's
     graph (make_decagon_graph_arrays: the uint8 pages): B14 at d = 64 and
     32 forward (bf16 and exact operand) and backward, each with a planted
     fault above its bound, B13 on the uint8 pages, fused and value-only,
     and on bf16-rounded operands past its tolerance;
  5. the dense TIP paths: train TIP-cat at full width for a few Adam steps
     on the Decagon-shaped graph through tip_tpu_torch.train.loop.train,
     then the final eval, with every kernel launch counter set to 0 just
     before and read just after; then profile a few more steps (device
     time by kernel, idle share).  "tip dense" on the strips (B1), "tip
     pages" with float32 matmuls pinned (train(..., matmul_precision=
     "highest")), which takes the float32 full pages (B2), "tip pages
     bf16" on the same graph with one count past 127 (with_heavy_pair),
     which takes the bf16 pages (B2; unprofiled), "tip strips
     sampled" with sampled negatives on the strips (B10, B8; unprofiled),
     "tip pages sampled" with sampled negatives on the float32 pages
     (float32 matmuls pinned; B10, B8; unprofiled),
     and "tip-nn dense", TIP-cat with the NN decoder: the strips for the
     encoder, the chunk buffers for its sampled loss (B10, B9); after "tip
     dense", the resume phase (RESUME_EPOCHS uninterrupted against half of
     them, a checkpoint and a resumed run, through train(...,
     checkpoint_dir, resume)) and the profiler hook (train(...,
     profile_dir) for PROFILE_EPOCHS epochs: its trace must name B1's
     kernel once for each traced epoch), a ``resume:`` and a ``profile
     hook:`` line, then the backend A/B on the strips (run_backend_ab:
     BACKEND_STEPS steps under backend="pallas", launches exact, and
     "xla", no launch; z and the zeroed-threshold loss of both routes
     agree; each route profiled), a ``backend:`` line;
  6. the model variants through the models runner (build_variant,
     train_variant) on the same graph, each at the default widths, counters
     as in 5: DR-NN on the strips and uint8 pages (B3; profiled), DR-NN
     with float32 matmuls pinned ("dr-nn pages": B3 on the float32 pages),
     then DR-DF (B1), PR-HMP-NN (no kernel) and PP-GAE (B12), DR-DF
     with float32 matmuls pinned ("dr-df pages", B2), Decagon
     ("decagon dense": B14, B13, B12; profiled) and CompGCN ("compgcn
     dense": B16, B1's wide instance, B12 at 200 columns; profiled; one
     more step's peak memory under a float32 copy of the strips);
  7. the decoder A/B entry point (tip_tpu_torch/scripts/decoder_ab.py) on
     the same graph in float32, counters as in 5: v1 (B6, B7) against v2
     (B8, B9) against a plain gather, the sampler (B10), the positives' BCE;
  8. hold B4-B10 against their plain versions again on the graph beyond
     the dense budget (BEYOND_DENSE: the chunked paths' own shapes, timed)
     and on a graph too wide for any shared-memory table (WIDE: the
     kernels' global-memory and two-draw modes); then B9 on a D-D graph
     skewed as the real one is (skewed_dd_raw: one relation holds a
     quarter of the chunks) and B5 on a P-P graph with a hub row
     (with_hub: ~4,500 edges, a run across 9 chunks), both timed;
  9. the chunked paths on BEYOND_DENSE: TIP-cat and TIP-cat with the NN
     decoder as in 5 (B10, B8 or B9, B4, B5; profiled; after TIP-cat the
     backend A/B as in 5, z and the positives' scores agreeing), DR-NN as
     in 6 (B10, B9, B4; profiled) and DR-DF (B10, B8, B4; unprofiled); then
     one TIP-cat step with and without remat (the same loss and gradients,
     B4's forward and B5 launched again in the backward, the peak memory
     both ways), a ``remat:`` line;
 10. sharded, on the Decagon-shaped graph with SHARDED_RANKS processes
     sharing this card (tip_tpu_torch/scripts/sharded.py's workers; the
     kernels are built before the ranks spawn): hold B11 against its plain
     version across the ranks (d = 32, 16, forward and backward) and time
     one ring step here; then train TIP-cat sharded (SHARDED_PATHS: the COO
     ring on the 1-D mesh, "tip sharded ring"; the dense P-P rows; the COO
     ring on the 2 x 2 mesh; the COO ring on the 1-D mesh with remat, the
     backward running the encoder's collectives and B11's ring steps
     again, its per-rank peak bytes beside the plain run's), and
     relation-partitioned in the same spawn
     (EP_PATHS: the strips on the 1-D mesh with the dense P-P rows, B1 on
     each rank's relation block; the strips on the 2 x 2 mesh with the COO
     ring, B1 and B11; the float32 pages with the COO ring, B2 and B11;
     the chunked layout with the NN decoder, B10 on global ids, B4 with
     R = r_max, B9 on local rows; the chunked layout with DistMult and the
     COO ring, B10, B4, B8 and B11), each rank probing z, the loss and the
     gradients against the single-process ones first, counters at 0 just
     before the steps, each rank's launches exact, rank 0's unsharded eval
     (EP: on the rows gathered from every rank); a ``sharded:`` line each;
 11. print the kernels line (each kernel timed at the shapes of the path
     whose launches it reports, KERNEL_PATH), the card line and, last, the
     result line {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet) used for the roofline bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12  # dense, on the tensor cores
PEAK_BF16_FLOP_PER_S = 989e12  # dense, on the tensor cores

# The Decagon shape (645 drugs, 19,081 proteins, 1,097 relations) is the
# decoder A/B's DECAGON_SHAPE (tip_tpu_torch/scripts/decoder_ab.py).
# Beyond the dense budget: bf16 pages would take 800 x 1536^2 x 2 B =
# 3.77 GB > 2.5 GB, so train() picks the chunked layout.  The D-D side is
# bench.py's beyond-dense lane (1536 drugs); the per-relation pair count and
# the protein side are Decagon's.
BEYOND_DENSE = dict(n_drug=1536, n_prot=19081, n_et=800, pairs_per_et=4600,
                    n_pp_pairs=715612, n_dp=18596, seed=0)
# Wider than B8's shared-memory table (> 3,417 drugs), whose forward takes
# its global-memory mode, and B10 (> 4,096) draws src
# and dst separately; B4's forward keeps eight-feature slices of x in shared
# memory (up to 7,128 drugs), and its check forces the global mode too
WIDE = dict(n_drug=7000, n_prot=300, n_et=3, pairs_per_et=40000,
            n_pp_pairs=600, n_dp=400, seed=0)
TRAIN_STEPS = 5  # TIP-cat paths
VARIANT_STEPS = 5  # the DR-NN paths (kernels B3, B9)
OTHER_STEPS = 2  # DR-DF, PR-HMP-NN, PP-GAE
# The sharded paths: SHARDED_RANKS processes on this one card (CUDA IPC
# between them), the Decagon-shaped graph; path -> (ranks on the ring axis,
# the ring's P-P form, steps, remat); a remat path's plain twin is its name
# without " remat"
SHARDED_RANKS = 4
SHARDED_PATHS = {"tip sharded ring": (4, "coo", 5, False),
                 "tip sharded dense-pp": (4, "dense", 2, False),
                 "tip sharded 2x2": (2, "coo", 2, False),
                 "tip sharded ring remat": (4, "coo", 2, True)}
# The relation-partitioned runs (tip_tpu_torch/parallel/ep.py) in the same
# spawn: path -> (ranks on the ring axis, the ring's P-P form, steps, the
# D-D layout, the decoder)
EP_PATHS = {"tip ep strips": (4, "dense", 2, "strips", "distmult"),
            "tip ep 2x2": (2, "coo", 2, "strips", "distmult"),
            "tip ep pages": (4, "coo", 2, "pages", "distmult"),
            "tip-nn ep chunked": (4, "dense", 2, "chunked", "nn"),
            "tip ep chunked": (4, "coo", 2, "chunked", "distmult")}
SHARDED_TIMEOUT_S = 600  # a spawn of the ranks, and each of their collectives
BACKEND_STEPS = 3  # the backend A/B's training steps a route


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


def tensor_core_bound(nbytes: float, cells: int, d: int) -> dict:
    """The bound of a DistMult dense loss kernel (B1, B2) that runs the
    three d-long dots of a cell (6 d flops) on the tensor cores as 3xTF32
    (three TF32 products each) and ~20 elementwise float operations a cell
    on the SIMT units, which overlap: the least time is the largest of the
    tensor-core, SIMT and bytes times.  ``bound_simt_ms`` is the bound with
    every operation on the SIMT units (6 d + 20 a cell), which a kernel on
    the tensor cores can beat."""
    dot_flops, elem_flops = cells * 6 * d, cells * 20
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_tensor = 3 * dot_flops / PEAK_TF32_FLOP_PER_S
    t_simt = elem_flops / PEAK_F32_FLOP_PER_S
    t_ops = max(t_tensor, t_simt)
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_tensor_ms=1e3 * t_tensor,
                bound_elementwise_ms=1e3 * t_simt,
                bound_bytes_ms=1e3 * t_bytes,
                bound_simt_ms=1e3 * max(t_bytes, (dot_flops + elem_flops)
                                        / PEAK_F32_FLOP_PER_S),
                cells=cells, bytes=int(nbytes), flops=dot_flops + elem_flops,
                library_ms=None)


def check_nan_reaches_loss(call, x, what: str) -> None:
    """A NaN in one element of the input x (the middle one, on a real row)
    makes the loss NaN, fused and value-only, as it does in the plain
    versions: the training loop stops on a non-finite loss.  ``call(x,
    grads)`` launches the kernel."""
    import math

    xn = x.clone()
    xn.view(-1)[x.numel() // 2] = float("nan")
    for grads in (True, False):
        out = call(xn, grads)
        loss = float(out[0] if grads else out)
        check(math.isnan(loss), f"{what}: a NaN input element gave the loss "
              f"{loss!r} (grads {grads})")


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
    check_nan_reaches_loss(lambda zz, gr: bce.dense_bce_sym_cuda(
        w, zz, pages, q8, seed, gr), z, "B1 z")
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

    # bound: each input read once, each output written once; operations
    # over the cells this graph needs (those inside n x n)
    nb = -(-n // 128)
    cells = sum(min(128, n - i * 128) * (n - i * 128) for i in range(nb)) * n_et
    rep.update(tensor_core_bound(
        pages.numel() + 4 * (w.numel() + z.numel() + q8.numel())
        + 4 * (1 + w.numel() + z.numel()), cells, d))
    return rep


def check_dense_bce_shapes(dev) -> list:
    """B2 against its plain version on small random pages in both page
    dtypes, at its other feature widths and with ragged tiles (n = 100: one
    partial tile; n = 1,000: eight tiles a side, the last partial), and on
    float32 pages holding counts past 256 (n = 645, Decagon's ragged
    edge), with the main check's tolerances."""
    import numpy as np
    import torch

    from tip_tpu_torch.ops import dense_bce as bce
    from tip_tpu_torch.train.model import pages_tensor

    rng = np.random.default_rng(13)
    out = []
    for d, n, r, past_256 in ((8, 100, 5, False), (16, 1000, 3, False),
                              (32, 300, 3, False), (16, 645, 3, True)):
        da = rng.poisson(0.05, (r, n, n)).astype(np.uint16)
        if past_256:  # counts only the float32 pages hold exactly
            hot = rng.random(da.shape) < 0.01
            da[hot] = rng.integers(257, 2000, int(hot.sum()))
        q = torch.from_numpy(
            rng.integers(0, 1 << 22, (r, 3)).astype(np.int32)).to(dev)
        w = torch.from_numpy(0.3 * rng.standard_normal((r, d))).float().to(dev)
        z = torch.from_numpy(0.5 * rng.standard_normal((n, d))).float().to(dev)
        for dtype in ("float32",) if past_256 else ("float32", "bfloat16"):
            pages = pages_tensor(da, dtype, dev)
            lk, dwk, dzk = bce.dense_bce_cuda(w, z, pages, q, 5, True)
            lp, dwp, dzp = bce.dense_bce_plain(w, z, pages, q, 5, True)
            vk = bce.dense_bce_cuda(w, z, pages, q, 5, False)
            rel = abs(float(lk) - float(lp)) / abs(float(lp))
            errs = _frac_errs((dwk, dzk), (dwp, dzp))
            shape = f"d={d} n={n} R={r} {dtype}" + (" past 256" if past_256
                                                     else "")
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
        check_nan_reaches_loss(lambda zz, gr: bce.dense_bce_cuda(
            w, zz, pages, q, seed, gr), z, f"B2 {dtype} z")
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
            # bound: each input read once, each output written once; the
            # three dots of every cell of the pages on the tensor cores
            r.update(tensor_core_bound(
                nbytes(pages, w, z, q) + 4 * (1 + w.numel() + z.numel()),
                n_et * n * n, d))
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


def kernel_breakdown(fn, reps: int = 10) -> dict:
    """Device ms of one call of ``fn``, by CUDA kernel and memset name
    (torch.profiler over ``reps`` calls after one warm-up); names that
    agree in their first 60 characters are added together."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            key = e.key[:60]
            out[key] = out.get(key, 0.0) + us / 1e3 / reps
    return out


def pp_csr(data, n_prot: int, dev):
    """A_hat as one CSR matrix (gcn_normalize sorts it by dst): the
    yardstick of kernel B5."""
    import torch

    dst = torch.from_numpy(data.pp_norm_index[1].astype("int64")).to(dev)
    crow = torch.zeros(n_prot + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(dst, minlength=n_prot), 0)
    return torch.sparse_csr_tensor(
        crow, torch.from_numpy(data.pp_norm_index[0].astype("int64")).to(dev),
        torch.from_numpy(data.pp_norm_weight).to(dev), (n_prot, n_prot))


def skewed_dd_raw(seed: int = 7):
    """A Decagon-wide D-D graph (645 drugs, 1,097 relations) skewed as the
    real one is: relations of 200-600 pairs, and relation 0 holding every
    one of the 207,690 drug pairs, about a quarter of the chunk slots.  A
    small P-P side."""
    import dataclasses

    import numpy as np

    from tip_tpu_torch.data import synthetic_trigraph

    raw = synthetic_trigraph(n_drug=645, n_prot=300, n_et=1097,
                             pairs_per_et=400, n_pp_pairs=600, n_dp=400,
                             seed=seed)
    lo, hi = np.triu_indices(raw.n_drug, 1)
    heavy = np.stack([lo, hi]).astype(np.int32)
    return dataclasses.replace(raw, dd_pair_list=[heavy,
                                                  *raw.dd_pair_list[1:]])


def pp_only_raw(seed: int = 0):
    """The Decagon-shape P-P graph (19,081 proteins) with a small D-D side."""
    from tip_tpu_torch.data import synthetic_trigraph

    return synthetic_trigraph(n_drug=64, n_prot=19081, n_et=3,
                              pairs_per_et=40, n_pp_pairs=715612, n_dp=400,
                              seed=seed)


def with_hub(raw, degree: int = 5000, seed: int = 9):
    """The raw graph with protein 0 joined to ``degree`` more proteins (both
    directions): a hub row of ~5,000 P-P edges, whose run in the windowed
    buffers crosses 9 chunks of 512 slots."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(seed)
    others = rng.choice(np.arange(1, raw.n_prot), size=degree, replace=False)
    hub = np.stack([np.zeros(degree, np.int64), others])
    edges = np.concatenate([raw.pp_edge_index.astype(np.int64), hub,
                            hub[::-1]], 1)
    edges = np.unique(edges, axis=1).astype(np.int32)
    return dataclasses.replace(raw, pp_edge_index=edges)


def check_typed_neighbor_sum(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B4 forward and backward against the plain version at both
    R-GCN widths (d = 64, layer 1; d = 32, layer 2); the forward in the
    mode the wrapper picks for this graph (x in shared memory: whole at n =
    645, two 32-feature slices at n = 1,536 and d = 64, eight-feature
    slices on the 7,000-drug graph) and forced to its global mode, on the
    whole buffers and on each of SHARDED_RANKS ranks' blocks of them (most
    relations own no chunk there, and their rows must come out zero).  The
    forward sums each (relation, dst) run in slot order, the backward adds
    with atomics, the plain version with index_add_: float32 order only,
    hence 1e-5 (forward) and 1e-4 (backward) of the largest magnitude; the
    forward is deterministic.  Timed: both directions at both widths,
    beside the plain versions and torch.sparse.mm over the typed CSR
    (forward) and its transpose (backward)."""
    import torch

    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.ops import typed_segment as ts
    from tip_tpu_torch.scripts.tns_bench import rank_blocks

    src2d, dst2d, ct = graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"]
    n, n_et = gs.n_drug, gs.n_et
    cfg = ModelConfig.tip_cat()
    args = (src2d, dst2d, ct)
    gen = torch.Generator().manual_seed(21)
    rep, worst, inputs = {}, 0.0, {}
    for d in (cfg.rgcn_in_dim, cfg.n_hid1):
        x = torch.randn(n, d, generator=gen).to(dev)
        dpt = torch.randn(n_et, d, n, generator=gen).to(dev)
        inputs[d] = (x, dpt)
        pp = ts.typed_neighbor_sum_fwd_plain(x, *args, n_et)
        dxp = ts.typed_neighbor_sum_bwd_plain(dpt, *args)
        r = {"kslice": ts.tns_fwd_kslice(n, d)}
        for mode in ("auto", "global"):
            pk = ts.typed_neighbor_sum_fwd_cuda(x, *args, n_et,
                                                force_global=mode == "global")
            ef, mf = max_err(pk, pp)
            check(ef <= 1e-5 * mf,
                  f"B4 d={d} forward ({mode}) err {ef} of max {mf}")
            check(torch.equal(pk, ts.typed_neighbor_sum_fwd_cuda(
                x, *args, n_et, force_global=mode == "global")),
                  f"B4 d={d} forward ({mode}) is not deterministic")
            r[f"fwd_{mode}_max_abs_err"] = ef
            worst = max(worst, ef)
        r["fwd_max"] = mf
        eb, mb = max_err(ts.typed_neighbor_sum_bwd_cuda(dpt, *args), dxp)
        check(eb <= 1e-4 * mb, f"B4 d={d} backward err {eb} of max {mb}")
        r.update(bwd_max_abs_err=eb, bwd_max=mb)
        worst = max(worst, eb)
        shard_worst = 0.0
        for rank, blk in enumerate(rank_blocks(graph, gs, SHARDED_RANKS)):
            want = ts.typed_neighbor_sum_fwd_plain(x, *blk, n_et)
            for mode in ("auto", "global"):
                ef, mf = max_err(ts.typed_neighbor_sum_fwd_cuda(
                    x, *blk, n_et, force_global=mode == "global"), want)
                check(ef <= 1e-5 * mf, f"B4 d={d} rank {rank} forward "
                      f"({mode}) err {ef} of max {mf}")
                shard_worst = max(shard_worst, ef / mf)
            eb, mb = max_err(ts.typed_neighbor_sum_bwd_cuda(dpt, *blk),
                             ts.typed_neighbor_sum_bwd_plain(dpt, *blk))
            check(eb <= 1e-4 * mb,
                  f"B4 d={d} rank {rank} backward err {eb} of max {mb}")
            shard_worst = max(shard_worst, eb / mb)
        r["ranks_err_frac"] = shard_worst
        rep[f"d{d}"] = r
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    # times at both widths; the kernels line reports layer 1's (the wider,
    # slower call)
    adj = ts.typed_csr(*args, n, n_et)
    adj_t = ts.typed_csr(*args, n, n_et, transpose=True)
    e_valid = int((dst2d < n).sum())
    for d, (x, dpt) in inputs.items():
        r = rep[f"d{d}"]
        r["ms"] = cuda_ms(lambda: ts.typed_neighbor_sum_fwd_cuda(
            x, *args, n_et), reps=20, primed=True)
        r["fwd_global_ms"] = cuda_ms(lambda: ts.typed_neighbor_sum_fwd_cuda(
            x, *args, n_et, force_global=True), reps=20, primed=True)
        r["bwd_ms"] = cuda_ms(lambda: ts.typed_neighbor_sum_bwd_cuda(
            dpt, *args), reps=20, primed=True)
        # yardsticks: the typed adjacency as one CSR [n_et * n, n] times x,
        # and its transpose [n, n_et * n] times dP [n_et * n, d]
        r["library_ms"] = library_call(
            lambda: torch.sparse.mm(adj, x),
            ts.typed_neighbor_sum_fwd_plain(x, *args, n_et).transpose(
                1, 2).reshape(n_et * n, d), 1e-5, "B4 forward")
        dp = dpt.transpose(1, 2).reshape(n_et * n, d)
        r["bwd_library_ms"] = library_call(
            lambda: torch.sparse.mm(adj_t, dp),
            ts.typed_neighbor_sum_bwd_plain(dpt, *args), 1e-4, "B4 backward")
        fwd = bound(nbytes(src2d, dst2d, ct, x) + n_et * d * n * 4, e_valid * d)
        bwd = bound(nbytes(src2d, dst2d, ct, dpt) + n * d * 4, e_valid * d)
        r.update(fwd)
        r.update(bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"])
    del adj, adj_t
    d = cfg.rgcn_in_dim
    x, dpt = inputs[d]
    rep["d"] = d
    rep.update({k: rep[f"d{d}"][k] for k in (
        "ms", "bwd_ms", "library_ms", "bwd_library_ms",
        "bound_ms", "bound_by", "bytes", "flops", "bwd_bound_ms",
        "bwd_bound_by")})
    rep["plain_ms"] = cuda_ms(
        lambda: ts.typed_neighbor_sum_fwd_plain(x, *args, n_et), reps=3, warmup=1)
    rep["bwd_plain_ms"] = cuda_ms(
        lambda: ts.typed_neighbor_sum_bwd_plain(dpt, *args), reps=3, warmup=1)
    rep.update(slots=src2d.numel(), valid_edges=e_valid)
    return rep


def check_gcn_spmm(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B5 against the plain version at both GCN widths (d = 32 and
    16) on the windowed P-P buffers, in float32 and with the bf16 message
    rounding, plus the adjoint identity <c, A x> = <A c, x> that its
    backward relies on, and the same bits from two runs.  Runs summed in
    slot order vs index_add_: float32 order only, 1e-5 of the largest
    magnitude."""
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
        ax = ts.gcn_spmm_cuda(x, *bufs)
        check(torch.equal(ax, ts.gcn_spmm_cuda(x, *bufs)),
              f"B5 d={d} differs between two runs")
        lhs = float((cot.double() * ax.double()).sum())
        rhs = float((ts.gcn_spmm_cuda(cot, *bufs).double() * x.double()).sum())
        check(abs(lhs - rhs) <= 1e-5 * abs(lhs), f"B5 d={d} adjoint {lhs} vs {rhs}")
        rep[f"d{d}_adjoint"] = {"lhs": lhs, "rhs": rhs}
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    d = cfg.pp_hid1
    x = torch.randn(gs.n_prot, d, generator=gen).to(dev)
    x16 = torch.randn(gs.n_prot, cfg.pp_hid2, generator=gen).to(dev)
    rep["d"] = d
    rep["ms"] = cuda_ms(lambda: ts.gcn_spmm_cuda(x, *bufs), reps=50,
                        primed=True)
    rep[f"d{cfg.pp_hid2}_ms"] = cuda_ms(lambda: ts.gcn_spmm_cuda(x16, *bufs),
                                        reps=50, primed=True)
    rep["plain_ms"] = cuda_ms(lambda: ts.gcn_spmm_plain(x, *bufs), reps=5,
                              warmup=1)
    adj = pp_csr(data, gs.n_prot, dev)
    rep["library_ms"] = library_call(lambda: torch.sparse.mm(adj, x),
                                     ts.gcn_spmm_plain(x, *bufs), 1e-5, "B5")
    e_valid = int(data.pp_norm_index.shape[1])
    rep.update(bound(nbytes(*bufs[:4], x) + gs.n_prot * d * 4,
                     2 * e_valid * d))
    rep.update(slots=bufs[0].numel(), valid_edges=e_valid)
    return rep


def check_pp_aggregate(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B12 against its plain version on the Decagon-shaped P-P (A+I)
    (``graph["pp_a1"]``) at both GCN widths (d = 32 and 16): the forward
    on a bf16 x, and the backward's product on a float32 gradient of
    spread exponents (three bf16 terms), float32 out and bf16 out (the
    latter the bf16 rounding of the former, bit for bit).  Bound: |kernel
    - plain| <= 4 sqrt(r) 2^-24 sum_k |a_ik x_kc| for every element, r the
    most nonzeros of a row (40.2 at r = 101): the kernel sums r (forward) or
    3 r (backward) exact products in float32, the plain version's float32
    GEMM r rounded ones, and their roundings add up as a random walk
    (readings 0.72 forward, 10.98 backward).  A backward that dropped the
    split's lo term (a 16-bit gradient) errs by up to 2^-16 of a term,
    some 256 units on a row of few terms: the check runs the kernel on
    hi + mid of the gradient, which is what such a kernel computes, and
    wants that above the bound.  One NaN in x gives the plain version's NaNs (its column, through 0 * NaN); two runs are
    bit-equal.  Timed: both widths each way; the plain version and the
    library route it replaced (the int8 -> float32 upcast, then torch.mm),
    and torch.mm alone on a resident float32 copy."""
    import torch

    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.ops import pp_aggregate as ppa

    a1 = graph["pp_a1"]
    n = a1.shape[0]
    r = int(a1.sum(1, dtype=torch.int64).max())
    cfg = ModelConfig.tip_cat()
    gen = torch.Generator().manual_seed(23)
    bound = 4 * math.sqrt(r)
    rep, worst, worst_ulps = {"n": n, "row_nnz_max": r}, 0.0, 0.0
    ins = {}
    for d in (cfg.pp_hid1, cfg.pp_hid2):
        x = torch.randn(n, d, generator=gen).to(torch.bfloat16).to(dev)
        g = (torch.randn(n, d, generator=gen) * torch.exp2(torch.randint(
            -8, 9, (n, d), generator=gen).float())).to(dev)
        ins[d] = (x, g)
        for what, inp in (("fwd", x), ("bwd", g)):
            k = ppa.pp_aggregate_cuda(a1, inp)
            p = ppa.pp_aggregate_plain(a1, inp)
            scale = ppa.pp_aggregate_plain(a1, inp.float().abs()).double()

            def ulps_of(got):  # units of 2^-24 sum|terms|
                return float(((got.double() - p.double()).abs()
                              / (scale * 2.0**-24)).max())

            ulps = ulps_of(k)
            check(ulps <= bound, f"B12 d={d} {what}: {ulps} units of 2^-24 "
                  f"sum|terms|, bound {bound}")
            if what == "bwd":
                hi, mid, _ = ppa.split3_plain(inp)
                two = ulps_of(ppa.pp_aggregate_cuda(a1, hi + mid))
                check(two > bound, f"B12 d={d}: a two-term split reads "
                      f"{two} units, within the bound {bound}")
                rep[f"d{d}_bwd_two_term_ulps"] = two
            e, m = max_err(k, p)
            rep[f"d{d}_{what}_max_abs_err"] = e
            rep[f"d{d}_{what}_ulps_of_sum"] = ulps
            worst, worst_ulps = max(worst, e), max(worst_ulps, ulps)
            check(torch.equal(k, ppa.pp_aggregate_cuda(a1, inp)),
                  f"B12 d={d} {what} differs between two runs")
            if what == "bwd":
                kb = ppa.pp_aggregate_cuda(a1, inp, out_dtype=torch.bfloat16)
                check(torch.equal(kb, k.to(torch.bfloat16)),
                      f"B12 d={d}: the bf16 output is not the float32 "
                      "output's rounding")
        xn = x.clone()
        xn[n // 2, 3] = float("nan")
        kn = torch.isnan(ppa.pp_aggregate_cuda(a1, xn))
        check(bool(kn[:, 3].any()) and torch.equal(
            kn, torch.isnan(ppa.pp_aggregate_plain(a1, xn))),
            f"B12 d={d}: a NaN in x did not reach out as in the plain version")
    rep.update(max_abs_err=worst, ulps_of_sum=worst_ulps, ulps_bound=bound)
    if not timed:
        return rep

    d, d2 = cfg.pp_hid1, cfg.pp_hid2
    (x, g), (x2, g2) = ins[d], ins[d2]
    rep["d"] = d
    rep["ks"] = ppa.k_splits(n, d, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    rep["ms"] = cuda_ms(lambda: ppa.pp_aggregate_cuda(a1, x), reps=50,
                        primed=True)
    rep[f"d{d2}_ms"] = cuda_ms(lambda: ppa.pp_aggregate_cuda(a1, x2),
                               reps=50, primed=True)
    for dd, gg in ((d, g), (d2, g2)):
        rep[f"bwd_d{dd}_ms"] = cuda_ms(lambda: ppa.pp_aggregate_cuda(
            a1, gg, out_dtype=torch.bfloat16), reps=50, primed=True)
    rep["step_ms"] = (rep["ms"] + rep[f"d{d2}_ms"] + rep[f"bwd_d{d}_ms"]
                      + rep[f"bwd_d{d2}_ms"])  # the four products a step
    rep["plain_ms"] = cuda_ms(lambda: ppa.pp_aggregate_plain(a1, x), reps=5,
                              warmup=1)
    want = ppa.pp_aggregate_plain(a1, x)
    rep["library_ms"] = library_call(lambda: a1.float() @ x.float(), want,
                                     1e-5, "B12")
    a1f = a1.float()
    xf = x.float()
    rep["library_mm_ms"] = library_call(lambda: a1f @ xf, want, 1e-5,
                                        "B12 mm alone")
    del a1f, want
    for tag, dd, terms in (("", d, 1), ("bwd_", d, 3)):
        # A, x (bf16 / float32), out (float32 / the backward's bf16)
        nb = n * n + n * dd * (2 if terms == 1 else 4) + n * dd * (
            4 if terms == 1 else 2)
        t_bytes = nb / PEAK_BYTES_PER_S
        t_ops = terms * 2.0 * n * n * dd / PEAK_BF16_FLOP_PER_S
        rep[f"{tag}bound_ms"] = 1e3 * max(t_bytes, t_ops)
        rep[f"{tag}bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rep["roofline_pct"] = 100 * rep["bound_ms"] / rep["ms"]
    rep["bwd_roofline_pct"] = 100 * rep["bwd_bound_ms"] / rep[f"bwd_d{d}_ms"]
    return rep


# B15's error bound, in units of 2^-24 sum |terms| of an element: 4 sqrt(n),
# n the most nonzero terms an element sums (the plain version's float32
# GEMM rounds each of its additions; the kernel's sums are exact where
# float32 holds them)
def rgcn_contract_bounds(strips) -> tuple:
    """(forward, backward) bounds and their n: the most nonzero relations
    of a strip column, three times the most nonzero columns of a
    relation."""
    import torch

    nz = strips.reshape(strips.shape[0], -1) != 0
    n_fwd = int(nz.sum(0, dtype=torch.int64).max())
    n_bwd = 3 * int(nz.sum(1, dtype=torch.int64).max())
    return (4 * math.sqrt(max(n_fwd, 1)), 4 * math.sqrt(max(n_bwd, 1)),
            n_fwd, n_bwd)


def check_rgcn_contract(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B15 against its plain version on the Decagon-shaped strips
    (``graph["dd_adj_sym"]``, 1,097 relations) at both cells' basis widths
    (64: TIP-cat's two layers of 32, 32: DR-NN's of 16): the forward M =
    bf16(att)^T S on a bf16 att, and the backward dA = S dM^T on a float32
    gradient of spread exponents (three bf16 terms), each within
    :func:`rgcn_contract_bounds` units of 2^-24 sum|terms|; two runs of each
    bit-equal; the elements of bf16(M) that differ from the bf16 rounding
    of the upcast product, counted (the R-GCN rounds M to bf16 before it
    multiplies h).  One NaN in att reaches M's column as in the plain
    version.  Timed: both widths each way; the plain version, and the
    route it replaced as the library yardstick: the int8 -> float32
    upcast, then torch.mm (forward), and torch.mm of the backward on that
    copy."""
    import torch

    from tip_tpu_torch.ops import rgcn_contract as rc

    strips = graph["dd_adj_sym"]
    r, c = strips.shape[0], strips[0].numel()
    b_fwd, b_bwd, n_fwd, n_bwd = rgcn_contract_bounds(strips)
    rep = {"r": r, "c": c, "n_fwd": n_fwd, "n_bwd": n_bwd,
           "ulps_bound_fwd": b_fwd, "ulps_bound_bwd": b_bwd}
    sf = strips.reshape(r, -1).float()
    gen = torch.Generator().manual_seed(25)
    ins, worst = {}, 0.0
    for bt in (64, 32):
        att = torch.randn(r, bt, generator=gen).to(torch.bfloat16).to(dev)
        gm = (torch.randn(bt, c, generator=gen) * torch.exp2(torch.randint(
            -8, 9, (bt, c), generator=gen).float())).to(dev)
        ins[bt] = (att, gm)
        k = rc.rgcn_contract_cuda(att, strips)
        p = rc.rgcn_contract_plain(att, strips)
        scale = att.float().abs().T @ sf.abs()
        ulps = float(((k.double() - p.double()).abs()
                      / (scale.double() * 2.0**-24).clamp_min(1e-300)).max())
        check(ulps <= b_fwd, f"B15 bt={bt} fwd: {ulps} units of 2^-24 "
              f"sum|terms|, bound {b_fwd}")
        check(torch.equal(k, rc.rgcn_contract_cuda(att, strips)),
              f"B15 bt={bt} fwd differs between two runs")
        rep[f"bt{bt}_fwd_ulps_of_sum"] = ulps
        rep[f"bt{bt}_fwd_max_abs_err"] = max_err(k, p)[0]
        rep[f"bt{bt}_fwd_bf16_differ"] = int(
            (k.to(torch.bfloat16) != p.to(torch.bfloat16)).sum())
        rep[f"bt{bt}_fwd_f32_differ"] = int((k != p).sum())
        worst = max(worst, rep[f"bt{bt}_fwd_max_abs_err"])
        del k, p, scale
        k = rc.rgcn_contract_grad_cuda(strips, gm)
        p = rc.rgcn_contract_grad_plain(strips, gm)
        scale = sf.abs() @ gm.abs().t()
        ulps = float(((k.double() - p.double()).abs()
                      / (scale.double() * 2.0**-24).clamp_min(1e-300)).max())
        check(ulps <= b_bwd, f"B15 bt={bt} bwd: {ulps} units of 2^-24 "
              f"sum|terms|, bound {b_bwd}")
        check(torch.equal(k, rc.rgcn_contract_grad_cuda(strips, gm)),
              f"B15 bt={bt} bwd differs between two runs")
        rep[f"bt{bt}_bwd_ulps_of_sum"] = ulps
        rep[f"bt{bt}_bwd_max_abs_err"] = max_err(k, p)[0]
        rep[f"bt{bt}_bwd_bf16_differ"] = int(
            (k.to(torch.bfloat16) != p.to(torch.bfloat16)).sum())
        worst = max(worst, rep[f"bt{bt}_bwd_max_abs_err"])
        del k, p, scale
    att = ins[64][0].clone()
    att[r // 2, 5] = float("nan")
    kn = torch.isnan(rc.rgcn_contract_cuda(att, strips))
    check(bool(kn[5].any()) and torch.equal(
        kn, torch.isnan(rc.rgcn_contract_plain(att, strips))),
        "B15: a NaN in att did not reach M as in the plain version")
    del att, kn
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    for bt in (64, 32):
        att, gm = ins[bt]
        tag = "" if bt == 64 else f"bt{bt}_"
        rep[f"{tag}ms" if bt == 64 else f"{tag}fwd_ms"] = cuda_ms(
            lambda: rc.rgcn_contract_cuda(att, strips), reps=20, primed=True)
        rep[f"{tag}bwd_ms"] = cuda_ms(
            lambda: rc.rgcn_contract_grad_cuda(strips, gm), reps=20,
            primed=True)
        # the work of one call: S read, att / dM read, M / dA written
        for what, terms, nb in (
                ("", 1, r * c + 2 * r * bt + 4 * bt * c),
                ("bwd_", 3, r * c + 4 * bt * c + 4 * r * bt)):
            t_bytes = nb / PEAK_BYTES_PER_S
            t_ops = terms * 2.0 * r * c * bt / PEAK_BF16_FLOP_PER_S
            rep[f"{tag}{what}bound_ms"] = 1e3 * max(t_bytes, t_ops)
            rep[f"{tag}{what}bound_by"] = ("bytes" if t_bytes >= t_ops
                                           else "operations")
    rep["step_ms"] = rep["ms"] + rep["bwd_ms"]  # a TIP-cat step's two calls
    rep["bt32_step_ms"] = rep["bt32_fwd_ms"] + rep["bt32_bwd_ms"]
    rep["roofline_pct"] = 100 * rep["bound_ms"] / rep["ms"]
    rep["bwd_roofline_pct"] = 100 * rep["bwd_bound_ms"] / rep["bwd_ms"]
    att, gm = ins[64]
    rep["plain_ms"] = cuda_ms(lambda: rc.rgcn_contract_plain(att, strips),
                              reps=5, warmup=1)
    want = rc.rgcn_contract_plain(att, strips)
    rep["library_ms"] = library_call(
        lambda: att.float().T @ strips.reshape(r, -1).float(), want, 1e-5,
        "B15")
    del want
    want = rc.rgcn_contract_grad_plain(strips, gm)
    rep["library_bwd_ms"] = library_call(lambda: sf @ gm.t(), want, 1e-5,
                                         "B15 bwd")
    rep["library_step_ms"] = rep["library_ms"] + rep["library_bwd_ms"]
    return rep


# B14's forward bound, in units of 2^-24 sum |terms| of an element (both
# forwards: bf16 operand and exact), between the kernel's readings (0.47
# to 0.48 on an NVIDIA H100 80GB HBM3) and the least planted fault's (13.6,
# the exact forward on a two-term operand)
B14_FWD_UNITS = 2.5


def check_rel_aggregate(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B14 against its plain version on the Decagon-shaped uint8
    pages (R = 1097, n = 645) at both of Decagon's widths (d = 64, 32): the
    forward on a random operand Y [R, n, d], rounded to bf16 on both sides
    and exact (float32, the pinned-float32 route); the backward on a
    float32 gradient of spread exponents (three exact bf16 terms).  Error
    in units of 2^-24 sum |terms| of each element, bounds set from the
    readings: the forward sums R (n + 1) exact products in float32 in
    another order than the plain version, and its errors largely cancel
    over R relations (readings 0.47 to 0.48 both ways: bound
    B14_FWD_UNITS = 2.5); the backward sums n + 1 products an element, each
    relation alone, bound 4 sqrt(n + 1) = 101.7 (readings 32.9 to 33.8, as
    the roundings of a random walk).  Planted, each must read above its
    bound: the exact forward against the bf16 plain version (a kernel that
    skipped the stated rounding; 2,398 to 2,810); the exact forward and the
    backward on hi + mid of the operand's three-term split (what a kernel
    that dropped the lo term computes, a 16-bit operand against the stated
    float32 one; 13.6 to 16.4 and 499 to 506).  Two runs are
    bit-equal.  Timed: both widths each way (the four passes of a step),
    the exact forward, the plain version, and the library route: the
    pages upcast to float32, then torch.bmm."""
    import torch

    from tip_tpu_torch.ops import pp_aggregate as ppa
    from tip_tpu_torch.ops import rel_aggregate as b14

    pages, s = graph["dd_adj_u8"], graph["dd_rel_s"]
    r, n, _ = pages.shape
    bwd_units = 4 * math.sqrt(n + 1)
    gen = torch.Generator().manual_seed(29)
    rep = {"n": n, "n_et": r, "fwd_units_bound": B14_FWD_UNITS,
           "bwd_units_bound": bwd_units}
    worst, ins = 0.0, {}

    def units(got, want, scale):
        return float(((got.double() - want.double()).abs()
                      / (scale.double() * 2.0**-24).clamp_min(1e-300)).max())

    def two_terms(x):  # hi + mid of the exact three-term split
        hi, mid, _ = ppa.split3_plain(x)
        return hi + mid

    for d in (64, 32):
        y = torch.randn(r, n, d, generator=gen).to(dev)
        g = (torch.randn(n, d, generator=gen) * torch.exp2(torch.randint(
            -8, 9, (n, d), generator=gen).float())).to(dev)
        ins[d] = (y, g)
        for what, exact in (("fwd", False), ("exact", True)):
            k = b14.rel_aggregate_cuda(pages, s, y=y, exact=exact)
            p = b14.rel_aggregate_plain(pages, s, y, rounded=not exact)
            scale = b14.rel_aggregate_plain(pages, s, y.abs(),
                                            rounded=not exact)
            u = units(k, p, scale)
            check(u <= B14_FWD_UNITS,
                  f"B14 d={d} {what}: {u} units, bound {B14_FWD_UNITS}")
            rep[f"d{d}_{what}_units"] = u
            check(torch.equal(k, b14.rel_aggregate_cuda(pages, s, y=y,
                                                        exact=exact)),
                  f"B14 d={d} {what} differs between two runs")
            worst = max(worst, max_err(k, p)[0])
            if exact:
                pr = b14.rel_aggregate_plain(pages, s, y)
                unrounded = units(k, pr, b14.rel_aggregate_plain(
                    pages, s, y.abs()))
                check(unrounded > B14_FWD_UNITS,
                      f"B14 d={d}: the exact forward reads {unrounded} units "
                      f"of the bf16 version, within {B14_FWD_UNITS}")
                rep[f"d{d}_exact_vs_bf16_units"] = unrounded
                two = units(b14.rel_aggregate_cuda(
                    pages, s, y=two_terms(y), exact=True), p, scale)
                check(two > B14_FWD_UNITS, f"B14 d={d}: a two-term exact "
                      f"forward reads {two} units, within {B14_FWD_UNITS}")
                rep[f"d{d}_exact_two_term_units"] = two
            del k, p, scale
        kb = b14.rel_aggregate_cuda(pages, s, g=g)
        pb = b14.rel_aggregate_t_plain(pages, s, g)
        scale = b14.rel_aggregate_t_plain(pages, s, g.abs())
        u = units(kb, pb, scale)
        check(u <= bwd_units, f"B14 d={d} bwd: {u} units, bound "
              f"{bwd_units}")
        rep[f"d{d}_bwd_units"] = u
        worst = max(worst, max_err(kb, pb)[0])
        two = units(b14.rel_aggregate_cuda(pages, s, g=two_terms(g)), pb,
                    scale)
        check(two > bwd_units, f"B14 d={d}: a two-term backward reads "
              f"{two} units, within the bound {bwd_units}")
        rep[f"d{d}_bwd_two_term_units"] = two
        del kb, pb, scale
    rep["max_abs_err"] = worst
    if not timed:
        return rep
    (y, g), (y2, g2) = ins[64], ins[32]
    rep["rc"] = b14.relation_chunk(n, r, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    rep["ms"] = cuda_ms(lambda: b14.rel_aggregate_cuda(pages, s, y=y),
                        reps=20, primed=True)
    rep["d32_ms"] = cuda_ms(lambda: b14.rel_aggregate_cuda(pages, s, y=y2),
                            reps=20, primed=True)
    rep["bwd_d64_ms"] = cuda_ms(lambda: b14.rel_aggregate_cuda(pages, s, g=g),
                                reps=20, primed=True)
    rep["bwd_d32_ms"] = cuda_ms(lambda: b14.rel_aggregate_cuda(
        pages, s, g=g2), reps=20, primed=True)
    rep["step_ms"] = (rep["ms"] + rep["d32_ms"] + rep["bwd_d64_ms"]
                      + rep["bwd_d32_ms"])
    rep["exact_d64_ms"] = cuda_ms(lambda: b14.rel_aggregate_cuda(
        pages, s, y=y, exact=True), reps=20, primed=True)
    rep["breakdown"] = kernel_breakdown(
        lambda: b14.rel_aggregate_cuda(pages, s, y=y), reps=5)
    rep["plain_ms"] = cuda_ms(lambda: b14.rel_aggregate_plain(pages, s, y),
                              reps=3, warmup=1)
    want = b14.rel_aggregate_plain(pages, s, y, rounded=False)

    def library():
        sy = s[:, :, None] * y
        return (s[:, :, None] * (torch.bmm(pages.float(), sy) + sy)).sum(0)

    rep["library_ms"] = library_call(library, want, 1e-5, "B14")
    for tag, d, terms in (("", 64, 1), ("bwd_", 64, 3), ("exact_", 64, 3)):
        big, small = 4 * r * n * d, 4 * n * d
        t_bytes = (r * n * n + 4 * r * n + big + small) / PEAK_BYTES_PER_S
        t_ops = terms * 2.0 * r * n * n * d / PEAK_BF16_FLOP_PER_S
        rep[f"{tag}bound_ms"] = 1e3 * max(t_bytes, t_ops)
        rep[f"{tag}bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rep["roofline_pct"] = 100 * rep["bound_ms"] / rep["ms"]
    rep["bwd_roofline_pct"] = 100 * rep["bwd_bound_ms"] / rep["bwd_d64_ms"]
    rep["exact_roofline_pct"] = (100 * rep["exact_bound_ms"]
                                 / rep["exact_d64_ms"])
    return rep


def check_dense_bce_dedicom(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B13 against its plain version on the Decagon-shaped uint8
    pages (d = 32, the thresholds of the train graph): the loss and dz, dd,
    dR within 1e-5 of the plain version (float32 sums in other orders;
    relative, of each gradient's largest element).  The kernel on bf16-rounded operands reads past that tolerance (its dots
    are float32-exact, and the check can tell).  One NaN in z gives a NaN
    loss; two runs are bit-equal.  Timed: fused and value-only, the plain
    version; beside the launch-by-launch breakdown the tile kernel's
    launch (grid, threads, dynamic shared memory)."""
    import torch

    from tip_tpu_torch.ops import dense_bce_dedicom as b13

    pages, q = graph["dd_adj_u8"], graph["dd_neg_q"]
    r, n, _ = pages.shape
    d = 32
    gen = torch.Generator().manual_seed(31)
    z = (torch.randn(n, d, generator=gen) * 0.5).to(dev)
    dvec = torch.randn(r, d, generator=gen).to(dev)
    rmat = (torch.randn(d, d, generator=gen) / math.sqrt(d)).to(dev)
    seed, tol = 0x1234ABCD, 1e-5

    def gaps(got, want):
        return [abs(float(got[0]) - float(want[0])) / abs(float(want[0]))] + [
            float((a.double() - b.double()).abs().max()
                  / b.double().abs().max()) for a, b in zip(got[1:], want[1:])]

    rep = {"n": n, "n_et": r, "d": d, "tol": tol}
    want = b13.dense_bce_dedicom_plain(dvec, rmat, z, pages, q, seed, True)
    got = b13.dense_bce_dedicom_cuda(dvec, rmat, z, pages, q, seed, True)
    gp = gaps(got, want)
    check(max(gp) <= tol, f"B13 uint8: gaps {gp}, tolerance {tol}")
    rep["uint8_gaps"] = gp
    worst = max(max_err(a, b)[0] for a, b in zip(got, want))
    again = b13.dense_bce_dedicom_cuda(dvec, rmat, z, pages, q, seed, True)
    got = b13.dense_bce_dedicom_cuda(dvec, rmat, z, pages, q, seed, True)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "B13 differs between two runs")
    rnd = [t.to(torch.bfloat16).float() for t in (dvec, rmat, z)]
    planted = gaps(b13.dense_bce_dedicom_cuda(*rnd, pages, q, seed, True),
                   want)
    check(max(planted) > tol, f"B13 on bf16 operands reads {planted}, "
          f"within {tol}")
    rep["bf16_operands_gaps"] = planted
    zn = z.clone()
    zn[n // 2, 3] = float("nan")
    check(math.isnan(float(b13.dense_bce_dedicom_cuda(dvec, rmat, zn, pages,
                                                       q, seed))),
          "B13: a NaN in z did not reach the loss")
    rep["max_abs_err"] = worst
    if not timed:
        return rep
    rep["ms"] = cuda_ms(lambda: b13.dense_bce_dedicom_cuda(
        dvec, rmat, z, pages, q, seed, True), reps=10, primed=True)
    rep["value_ms"] = cuda_ms(lambda: b13.dense_bce_dedicom_cuda(
        dvec, rmat, z, pages, q, seed), reps=10, primed=True)
    rep["launch"] = b13.launch_config(n, r, d)
    rep["breakdown"] = kernel_breakdown(lambda: b13.dense_bce_dedicom_cuda(
        dvec, rmat, z, pages, q, seed, True), reps=3)
    rep["plain_ms"] = cuda_ms(lambda: b13.dense_bce_dedicom_plain(
        dvec, rmat, z, pages, q, seed, True), reps=3, warmup=1)
    cells = r * n * n
    args = n * d + r * d + d * d
    nb = cells + 4 * r * 3 + 4 * args + 4 * (1 + args)
    t_bytes = nb / PEAK_BYTES_PER_S
    t_tensor = 3 * (6.0 * d * cells + 8.0 * r * n * d * d) / PEAK_TF32_FLOP_PER_S
    t_simt = 20.0 * cells / PEAK_F32_FLOP_PER_S
    t = max(t_bytes, t_tensor, t_simt)
    rep["bound_ms"] = 1e3 * t
    rep["bound_by"] = ("bytes" if t == t_bytes else "tensor cores (3xTF32)"
                       if t == t_tensor else "SIMT elementwise")
    rep["roofline_pct"] = 100 * rep["bound_ms"] / rep["ms"]
    rep["library_ms"] = None  # no single PyTorch call computes it
    return rep


def check_distmult_sddmm(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B8 forward (logits) and backward (dz, dw) against the plain
    version at d = 16: the forward with its z table where the wrapper puts
    it for this graph (shared memory up to 3,417 nodes, read through L1
    past that) and forced to global memory, the backward (z through L1 at
    any size) in float32 and with the bf16 rounding of each scattered
    contribution; pad logits must be exactly 0.  Float32 order only: 1e-5
    of the largest logit, 1e-4 of the largest dz and dw."""
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
    rep = {"d": d, "fwd_shared": sddmm2.shared_table_fits(gs.n_drug),
           "pad_slots": int(pad.sum())}
    worst = 0.0
    for bf16 in (False, True):
        zr = bf16_round(z) if bf16 else z  # the wrapper's compute_round
        args = (zr, w, src2d, dst2d, ct)
        lp = sddmm2.distmult_logits_plain(*args)
        dzp, dwp = sddmm2.distmult_bwd_plain(*args, g, bf16)
        dzk, dwk = sddmm2.distmult_bwd_cuda(*args, g, bf16)
        ez, mz = max_err(dzk, dzp)
        ew, mw = max_err(dwk, dwp)
        check(ez <= 1e-4 * mz and ew <= 1e-4 * mw,
              f"B8 {'bf16 ' * bf16}grads err {ez} of {mz}, {ew} of {mw}")
        rep["bf16_bwd" if bf16 else "bwd"] = {"dz_max_abs_err": ez,
                                              "dw_max_abs_err": ew}
        worst = max(worst, ez, ew)
        for table in (None, "global"):
            tag = ("bf16_" if bf16 else "") + (table or "auto")
            lk = sddmm2.distmult_logits_cuda(*args, table=table)
            el, ml = max_err(lk, lp)
            check(el <= 1e-5 * ml, f"B8 {tag} logits err {el} of max {ml}")
            check(bool((lk[pad] == 0).all()), f"B8 {tag} pad logits are not 0")
            rep[tag] = {"logit_max_abs_err": el}
            worst = max(worst, el)
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
    """Kernel B10 against its plain route under the same seed and under the
    same explicit draws, in the single-draw mode up to 4,096 nodes and the
    two-draw mode past it, each exactly (torch.equal): the raw sign-flagged
    pairs (``output="raw"``) against the plain sampler's; the resolved
    pairs (``"pair"``) against the plain sampler's after resolve_borrow;
    the split (``"split"``, what a training step takes, one launch)
    against those pairs' % and //.  Then how many sampled negatives are
    still positives after the borrow pass (the JAX package accepts
    ~density^5).  Timed: the split call (the step's), the raw call, and
    the plain route (plain sampler, resolve_borrow, % and //); the bound
    counts the chunk types, the bitmap bytes this run's draws touch, and
    8 output bytes a slot (src and dst)."""
    import torch

    from tip_tpu_torch.data.packing import bitmap_stride_bits
    from tip_tpu_torch.ops import sampler
    from tip_tpu_torch.sampling import typed_negative_sampling_chunked

    ct, bitmap = graph["dd_chunk_type"], graph["dd_bitmap"]
    n, chunk = gs.n_drug, gs.dd_chunk
    seed = 12345
    u24 = torch.randint(0, 1 << 24, (ct.shape[0], 1,
                                     sampler.draws_per_slot(n) * chunk),
                        generator=torch.Generator().manual_seed(13),
                        dtype=torch.int32).to(dev)

    def plain_route(draws):
        raw = sampler.typed_negative_sampling_plain(seed, ct, bitmap, n, chunk,
                                                    draws)
        pair = sampler.resolve_borrow(raw)
        return raw, pair, pair % n, pair // n

    for name, draws in (("hashed", None), ("explicit", u24)):
        raw, pair, src, dst = plain_route(draws)
        got = {out: sampler.typed_negative_sampling_cuda(
            seed, ct, bitmap, n, chunk, draws, output=out)
            for out in sampler.OUTPUTS}
        for what, a, b in (("raw pairs", got["raw"], raw),
                           ("resolved pairs", got["pair"], pair),
                           ("src", got["split"][0], src),
                           ("dst", got["split"][1], dst)):
            check(torch.equal(a, b), f"B10 {name} draws: kernel and plain "
                  f"route give different {what} ({int((a != b).sum())} "
                  "slots)")
        if draws is None:
            rk, resolved = got["raw"], pair
            entry = typed_negative_sampling_chunked(seed, ct, bitmap, n,
                                                    gs.n_et, chunk)
            check(torch.equal(entry[0], src) and torch.equal(entry[1], dst),
                  "B10: typed_negative_sampling_chunked differs from the "
                  "plain route")
    pair = torch.where(rk < 0, -rk - 1, rk)
    check(int(pair.min()) >= 0 and int(pair.max()) < n * n, "B10 pair range")
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
        seed, ct, bitmap, n, chunk, output="split"), reps=50, primed=True)
    rep["raw_ms"] = cuda_ms(lambda: sampler.typed_negative_sampling_cuda(
        seed, ct, bitmap, n, chunk), reps=50, primed=True)
    rep["plain_ms"] = cuda_ms(lambda: plain_route(None), reps=3, warmup=1)
    rep["library_ms"] = None  # no single PyTorch call computes it
    touched = torch.unique(ct.long()[:, None] * stride + (pair.long() >> 3))
    rep.update(bound(nbytes(ct) + touched.numel() + 8 * rk.numel(),
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
    column strips of the kernel), and on float32 pages holding counts past
    256 (n = 645, Decagon's ragged edge), with the main check's
    tolerances."""
    import numpy as np
    import torch

    from tip_tpu_torch.ops import dense_bce_nn as bce
    from tip_tpu_torch.train.model import pages_tensor

    rng = np.random.default_rng(12)
    out = []
    for n, r, dtype in ((100, 5, "uint8"), (1000, 3, "uint8"),
                        (645, 3, "float32")):
        da = (rng.random((r, n, n)) < 0.05).astype(np.uint16)
        if dtype == "float32":  # counts only the float32 pages hold exactly
            hot = rng.random(da.shape) < 0.01
            da[hot] = rng.integers(257, 2000, int(hot.sum()))
            pages = pages_tensor(da, dtype, dev)
        else:
            pages = torch.from_numpy(da.astype(np.uint8)).to(dev)
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
        shape = f"n={n} R={r} {dtype}"
        check(rel < 1e-5, f"B3 {shape} loss rel err {rel}")
        check(max(errs) <= 1e-3, f"B3 {shape} grads {errs}")
        check(float(vk) == float(lk), f"B3 {shape} value-only != fused")
        out.append({"shape": shape, "loss_rel_err": rel,
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
    check_nan_reaches_loss(lambda h1, gr: bce.dense_bce_nn_cuda(
        args[0], args[1], h1, args[3], pages, q, seed, gr), args[2], "B3 h1")
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
    the plain version at l1 = 16, an item's score rows and gradient sums
    where the wrapper puts them for this graph (shared memory up to 29,055
    nodes) and forced to global memory, in float32 and with bf16 rounding.
    Logits are compared on valid slots (a pad slot scores its pad src);
    with h1 = 0 the pad slots' logits (their dst terms) must be exactly 0.
    Float32 order only: 1e-5 of the largest logit, 1e-4 of the largest
    gradient.  Both modes give the same logits bit for bit (the global
    mode's score table is the first version's forward), and two float32
    backwards give the same bits in either mode."""
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
        logits = {}
        for table in (None, "global"):
            tag = ("bf16_" if bf16 else "") + (table or "auto")
            lk = logits[table] = sddmm2.nn_logits_cuda(*args, table=table)
            gk = sddmm2.nn_bwd_cuda(*args, g, bf16, table=table)
            el, ml = max_err(lk[valid], lp[valid])
            check(el <= 1e-5 * ml, f"B9 {tag} logits err {el} of max {ml}")
            errs = _frac_errs(gk, gp)
            check(max(errs) <= 1e-4, f"B9 {tag} grads (dh1, dh2, dw1, dw2) "
                  f"err {errs} of their max")
            l0 = sddmm2.nn_logits_cuda(torch.zeros_like(hr[0]), *args[1:],
                                       table=table)
            check(bool((l0[pad] == 0).all()), f"B9 {tag} pad dst terms not 0")
            if not bf16:
                again = sddmm2.nn_bwd_cuda(*args, g, table=table)
                check(all(torch.equal(a, b) for a, b in zip(gk, again)),
                      f"B9 {tag} backward differs between two runs")
            rep[tag] = {"logit_max_abs_err": el, "grad_err_frac": errs}
            worst = max(worst, el, *(max_err(a, b)[0] for a, b in zip(gk, gp)))
        check(torch.equal(logits[None], logits["global"]),
              f"B9 bf16={bf16}: the two modes' logits differ")
    rep["max_abs_err"] = worst
    if not timed:
        return rep

    args = (h1, h2, w1, w2, *bufs)
    rep["ms"] = cuda_ms(lambda: sddmm2.nn_logits_cuda(*args), reps=20,
                        primed=True)
    rep["global_ms"] = cuda_ms(lambda: sddmm2.nn_logits_cuda(
        *args, table="global"), reps=20, primed=True)
    rep["bwd_ms"] = cuda_ms(lambda: sddmm2.nn_bwd_cuda(*args, g), reps=20,
                            primed=True)
    rep["bwd_global_ms"] = cuda_ms(lambda: sddmm2.nn_bwd_cuda(
        *args, g, table="global"), reps=20, primed=True)
    rep["bwd_bf16_ms"] = cuda_ms(lambda: sddmm2.nn_bwd_cuda(
        *args, g, True), reps=20, primed=True)
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
    version at d = 16, the forward's z table where the wrapper puts it for
    this graph (shared memory up to 3,417 nodes, global memory past that)
    and forced to global memory (the backward has one mode, run both
    ways), in float32 and with the bf16 rounding of z and of each
    scattered contribution; pad logits must be exactly 0.  Float32 order
    only: 1e-5 of the largest logit, 1e-4 of the largest dz and dw.  Then
    B6 against B8 in float32:
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
    the plain version at l1 = 16, in the mode the wrapper picks for this
    graph (the forward's score rows in shared memory up to 29,055 nodes;
    the backward adds into device memory at any n) and with the forward
    forced to its global score table, in float32 and with bf16 rounding.
    Logits are compared on every slot (a pad slot scores its pad src alike
    in both); with h1 = 0 the pad slots' logits (their dst terms) must be
    exactly 0.  Float32 order only: 1e-5 of the largest logit, 1e-4 of the
    largest gradient.  Then B7 against B9 in float32: the same logits on
    every slot, bit for bit (B7 launches B9's forward, csrc/nn_fwd.cuh; the
    digests of both are reported), and the same grads under a masked
    cotangent within 1e-4 of their max (B9 rounds at other points)."""
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
    l1, l2 = ts.nn_v1_fwd_cuda(*args), sddmm2.nn_logits_cuda(*args)
    digests = [hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]
               for x in (l1, l2)]
    check(torch.equal(l1, l2), f"B7 and B9 logits differ (digests {digests})")
    errs = _frac_errs(ts.nn_v1_bwd_cuda(*args, gm), sddmm2.nn_bwd_cuda(*args, gm))
    check(max(errs) <= 1e-4, f"B7 vs B9 grads {errs} of their max")
    rep["vs_v2"] = {"logits_equal": True, "logits_digest": digests[0],
                    "v2_logits_digest": digests[1], "grad_err_frac": errs}
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



# B16's bounds, in units of 2^-24 sum |terms| of an element: about five
# times the kernel's readings on an NVIDIA H100 80GB HBM3 (forward 0.49;
# backward dU 1.07, dz 1.79), the backward's seven times under the planted
# two-term backward's (58.0)
B16_FWD_UNITS = 2.5
B16_BWD_UNITS = 8.0
B16_WIDTH = 200  # CompGCN's two directions of init_dim 100


def b16_units(k, p, scale) -> float:
    return float(((k.double() - p.double()).abs()
                  / (scale.double() * 2.0**-24).clamp_min(1e-300)).max())


def check_rel_scaled(graph, gs, data, dev, timed: bool = True) -> dict:
    """Kernel B16 against its plain version on the Decagon-shaped strips
    (``graph["dd_adj_sym"]``, R = 1,097, n = 645) at CompGCN's width 200:
    the forward on a bf16 operand, the backward (dU, dz) on a float32
    gradient of spread exponents (its three exact bf16 terms), each within
    B16_FWD_UNITS / B16_BWD_UNITS units of 2^-24 sum|terms| of the plain
    version; two runs of each bit-equal; a planted backward on two terms
    (the third left out) reads above the backward bound.  Timed: forward
    and backward, their bounds (bytes and bf16 operations), the plain
    version."""
    import torch

    from tip_tpu_torch.ops import rel_scaled as b16
    from tip_tpu_torch.ops.pp_aggregate import split3_plain

    strips = graph["dd_adj_sym"]
    r, n, d = strips.shape[0], data.n_drug, B16_WIDTH
    gen = torch.Generator().manual_seed(26)
    ub = b16.bf16_value(torch.randn(n, d, generator=gen)).to(dev)
    z = torch.randn(r, d, generator=gen).to(dev)
    g = (torch.randn(n, d, generator=gen) * torch.exp2(torch.randint(
        -8, 9, (n, d), generator=gen).float())).to(dev)
    rep = {"r": r, "n": n, "d": d, "units_bound_fwd": B16_FWD_UNITS,
           "units_bound_bwd": B16_BWD_UNITS}
    k = b16.rel_scaled_cuda(strips, ub, z)
    p = b16.rel_scaled_plain(strips, ub, z)
    scale = b16.rel_scaled_plain(strips, ub.abs(), z.abs())
    units = b16_units(k, p, scale)
    check(units <= B16_FWD_UNITS, f"B16 fwd: {units} units of 2^-24 "
          f"sum|terms|, bound {B16_FWD_UNITS}")
    check(torch.equal(k, b16.rel_scaled_cuda(strips, ub, z)),
          "B16 fwd differs between two runs")
    rep.update(fwd_units=units, fwd_max_abs_err=max_err(k, p)[0])
    du, dz = b16.rel_scaled_grad_cuda(strips, ub, z, g)
    du_p, dz_p = b16.rel_scaled_grad_plain(strips, ub, z, g)
    du_s, dz_s = b16.rel_scaled_grad_plain(strips, ub.abs(), z.abs(), g.abs())
    u_du, u_dz = b16_units(du, du_p, du_s), b16_units(dz, dz_p, dz_s)
    check(max(u_du, u_dz) <= B16_BWD_UNITS, f"B16 bwd: dU {u_du}, dz {u_dz} "
          f"units of 2^-24 sum|terms|, bound {B16_BWD_UNITS}")
    again = b16.rel_scaled_grad_cuda(strips, ub, z, g)
    check(torch.equal(du, again[0]) and torch.equal(dz, again[1]),
          "B16 bwd differs between two runs")
    # the planted fault: G on two bf16 terms, the third dropped
    nb = strips.shape[2] // 128
    nb = int(round(((8 * nb + 1) ** 0.5 - 1) / 2))
    dw = b16.padded_width(d)
    hi, mid, _ = split3_plain(g)
    xt = torch.stack([b16._pad(t, nb * 128, dw, torch.bfloat16)
                      for t in (hi, mid, torch.zeros_like(g))])
    zz = b16._pad(z, r, dw, torch.float32)
    ubp = b16._pad(ub, nb * 128, dw, torch.bfloat16)
    du2, dz2 = b16._launch(strips, xt, 3, zz, ubp, n, d, True)
    planted = max(b16_units(du2, du_p, du_s), b16_units(dz2, dz_p, dz_s))
    check(planted > B16_BWD_UNITS, f"B16: the two-term backward reads "
          f"{planted} units, within the bound {B16_BWD_UNITS}")
    rep.update(bwd_du_units=u_du, bwd_dz_units=u_dz, planted_two_term=planted,
               bwd_max_abs_err=max(max_err(du, du_p)[0],
                                   max_err(dz, dz_p)[0]))
    rep["max_abs_err"] = max(rep["fwd_max_abs_err"], rep["bwd_max_abs_err"])
    del k, p, scale, du_p, dz_p, du_s, dz_s, du2, dz2
    if not timed:
        return rep
    rep["ms"] = cuda_ms(lambda: b16.rel_scaled_cuda(strips, ub, z), reps=20,
                        primed=True)
    rep["bwd_ms"] = cuda_ms(lambda: b16.rel_scaled_grad_cuda(
        strips, ub, z, g), reps=20, primed=True)
    for what, terms, nbytes_ in (
            ("", 1, strips.numel() + 2 * n * d + 4 * r * d + 4 * n * d),
            ("bwd_", 3, strips.numel() + 4 * n * d + 4 * r * d + 2 * n * d
             + 4 * n * d + 4 * r * d)):
        t_bytes = nbytes_ / PEAK_BYTES_PER_S
        t_ops = terms * 2.0 * r * n * n * d / PEAK_BF16_FLOP_PER_S
        rep[f"{what}bound_ms"] = 1e3 * max(t_bytes, t_ops)
        rep[f"{what}bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rep["roofline_pct"] = 100 * rep["bound_ms"] / rep["ms"]
    rep["bwd_roofline_pct"] = 100 * rep["bwd_bound_ms"] / rep["bwd_ms"]
    rep["plain_ms"] = cuda_ms(lambda: b16.rel_scaled_plain(strips, ub, z),
                              reps=3, warmup=1)
    rep["library_ms"] = None  # no one PyTorch call: the plain version's bmm
    return rep


B1_WIDE_D = 200  # CompGCN's gcn_dim
# the wide instance's floor, in units of 2^-24 sum|terms| of the float64
# oracle: a logit is a float32 dot of d = 200 products in an order of its
# own, a few units at most (readings on an NVIDIA H100 80GB HBM3: loss
# 0.33, dw 0.59, dz 0.42; the plain version's 1.07, 0.25, 0.32)
B1W_FLOOR_UNITS = 4.0


def b1_wide_oracle(w, z, pages, q8, seed: int, chunk: int = 64):
    """float64 loss, dw, dz of the symmetric estimator with the hashed
    field (the plain version's cells and counts, ops/dense_bce_sym.py), and
    each one's sum of |terms|: the loss terms are >= 0; dw's and dz's are
    |G| |z_I| |z_J| (|w|)."""
    import torch

    from tip_tpu_torch.data.packing import nb_from_cols
    from tip_tpu_torch.ops import dense_bce_sym as bce

    r, _, totcols = pages.shape
    n, d = z.shape
    nb = nb_from_cols(totcols)
    npad = nb * 128
    dev = z.device
    zb = torch.nn.functional.pad(z.double(), (0, 0, 0, npad - n))
    wd = w.double()
    idx = torch.arange(npad, device=dev)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    dw, dw_a = torch.zeros_like(wd), torch.zeros_like(wd)
    dz, dz_a = torch.zeros_like(zb), torch.zeros_like(zb)
    for c0 in range(0, r, chunk):
        c1 = min(c0 + chunk, r)
        rel = torch.arange(c0, c1, device=dev)
        wc, qc = wd[c0:c1], q8[c0:c1].long()
        for i in range(nb):
            s = (nb - i) * 128
            off = bce._strip_off(nb, i)
            da = pages[c0:c1, :, off:off + s].double()
            zi, zt = zb[i * 128:(i + 1) * 128], zb[i * 128:]
            lg = (zi[None] * wc[:, None, :]) @ zt.T
            rows, cols = idx[i * 128:(i + 1) * 128], idx[i * 128:]
            u = bce.u24_field(seed, rel, rows, cols, npad)
            diag = (cols < (i + 1) * 128)[None, None, :]
            cnt = sum((u < torch.where(diag, qc[:, k, None, None],
                                       qc[:, 4 + k, None, None])).double()
                      for k in range(4))
            bad = (da > 0) | (rows >= n)[None, :, None] | \
                (cols >= n)[None, None, :]
            cnt = torch.where(bad, 0.0, cnt)
            daw = torch.where(diag, da, 2.0 * da)
            sp = torch.nn.functional.softplus(-lg, threshold=1e9)
            loss += (sp * daw + (sp + lg) * cnt).sum()
            gg = cnt - torch.sigmoid(-lg) * (daw + cnt)
            ga = gg.abs()
            dw[c0:c1] += (zi[None] * (gg @ zt)).sum(1)
            dw_a[c0:c1] += (zi.abs()[None] * (ga @ zt.abs())).sum(1)
            dz[i * 128:(i + 1) * 128] += (wc[:, None] * (gg @ zt)).sum(0)
            dz[i * 128:] += (wc[:, None] * (gg.transpose(1, 2) @ zi)).sum(0)
            dz_a[i * 128:(i + 1) * 128] += (wc.abs()[:, None]
                                            * (ga @ zt.abs())).sum(0)
            dz_a[i * 128:] += (wc.abs()[:, None] * (ga.transpose(1, 2)
                                                    @ zi.abs())).sum(0)
    return loss, dw, dz[:n], dw_a, dz_a[:n]


def check_dense_bce_sym_wide(graph, gs, data, dev, timed: bool = True
                             ) -> dict:
    """B1's wide instance (csrc/dense_bce_sym.cu ``b1w``) at CompGCN's d =
    200 on the Decagon-shaped strips and thresholds, against the float64
    oracle of the same cells and draws (:func:`b1_wide_oracle`), with the
    plain version's float32 errors beside it: loss, dw and dz in units of
    2^-24 sum|terms|, each within 4 x the plain version's reading (and at
    least B1W_FLOOR_UNITS: the logit's float32 dot of 200 products, in
    another order); value-only equals fused and two runs are bit-equal; a
    NaN in z reaches the loss.  Timed: fused, value-only, the plain
    version, the bound of counts/compgcn_kernels.py's reckoning."""
    import torch

    from tip_tpu_torch.ops import dense_bce_sym as bce

    pages, q8 = graph["dd_adj_sym"], graph["dd_neg_q8"]
    r, n, d = pages.shape[0], data.n_drug, B1_WIDE_D
    gen = torch.Generator().manual_seed(27)
    w = (torch.randn(r, d, generator=gen) / d**0.5).to(dev)
    z = (torch.rand(n, d, generator=gen) * 2 - 1).to(dev)  # tanh's range
    seed = 2**31 + 26
    lk, dwk, dzk = bce.dense_bce_sym_cuda(w, z, pages, q8, seed, True)
    lp, dwp, dzp = bce.dense_bce_sym_plain(w, z, pages, q8, seed, True)
    lo, dwo, dzo, dw_a, dz_a = b1_wide_oracle(w, z, pages, q8, seed)

    def units(x, want, scale):
        return float(((x.double() - want).abs()
                      / (scale * 2.0**-24).clamp_min(1e-300)).max())

    rep = {"r": r, "n": n, "d": d}
    for name, k, p_, o, sc in (("loss", lk, lp, lo, lo.abs()),
                               ("dw", dwk, dwp, dwo, dw_a),
                               ("dz", dzk, dzp, dzo, dz_a)):
        uk, up = units(k, o, sc), units(p_, o, sc)
        bound = max(4 * up, B1W_FLOOR_UNITS)
        check(uk <= bound, f"B1 wide {name}: {uk} units of 2^-24 "
              f"sum|terms| (the plain version {up}), bound {bound}")
        rep[f"{name}_units"], rep[f"{name}_plain_units"] = uk, up
        rep[f"{name}_bound_units"] = bound
    rep["loss"] = float(lk)
    rep["max_abs_err"] = max(max_err(dwk, dwp)[0], max_err(dzk, dzp)[0])
    check(float(bce.dense_bce_sym_cuda(w, z, pages, q8, seed, False))
          == float(lk), "B1 wide: value-only != fused")
    again = bce.dense_bce_sym_cuda(w, z, pages, q8, seed, True)
    check(torch.equal(again[1], dwk) and torch.equal(again[2], dzk)
          and float(again[0]) == float(lk), "B1 wide: two runs differ")
    check_nan_reaches_loss(lambda zz, gr: bce.dense_bce_sym_cuda(
        w, zz, pages, q8, seed, gr), z, "B1 wide z")
    del lo, dwo, dzo, dw_a, dz_a
    if not timed:
        return rep
    rep["ms"] = cuda_ms(lambda: bce.dense_bce_sym_cuda(
        w, z, pages, q8, seed, True), reps=10, primed=True)
    rep["value_only_ms"] = cuda_ms(lambda: bce.dense_bce_sym_cuda(
        w, z, pages, q8, seed, False), reps=10, primed=True)
    rep["plain_ms"] = cuda_ms(lambda: bce.dense_bce_sym_plain(
        w, z, pages, q8, seed, True), reps=2, warmup=1)
    # the bound: counts/compgcn_kernels.py:b1_wide_bound_s's reckoning
    nb = -(-n // 128)
    cells = r * sum(min(128, n - i * 128) * (n - i * 128) for i in range(nb))
    active = 1.5 * data.dd_train.n_edges
    nbytes_ = pages.numel() + 4 * (2 * r * d + 2 * n * d + 8 * r + 1)
    flops = 20.0 * cells + 8.0 * d * active + 4.0 * d * r * n
    t_bytes, t_ops = nbytes_ / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    rep["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    rep["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rep["roofline_pct"] = 100 * rep["bound_ms"] / rep["ms"]
    # the dense 3xTF32 pass the tile kernel would run at this width
    rep["dense_tf32_bound_ms"] = 1e3 * 3 * cells * 6 * d / PEAK_TF32_FLOP_PER_S
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
    "pp_aggregate": ("dense", check_pp_aggregate),
    "rel_aggregate": ("decagon", check_rel_aggregate),
    "dense_bce_dedicom": ("decagon", check_dense_bce_dedicom),
    "rgcn_contract": ("dense", check_rgcn_contract),
    "rel_scaled": ("dense", check_rel_scaled),
    # B1's wide instance (d = 200), a second check of dense_bce_sym
    "dense_bce_sym_wide": ("dense", check_dense_bce_sym_wide),
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


def expected_launches(path: str, steps: int, eval_rank: bool = True,
                      remat: bool = False) -> dict:
    """Launches of each kernel in ``steps`` training steps plus the final
    eval, per path (a sharded path's: one rank's; ``eval_rank`` False
    leaves the eval out, which on a sharded path rank 0 alone runs).  With
    ``remat`` (TIP chunked, TIP-NN chunked) the backward runs the encoder
    again: B4's forward and B5 once more in each of two layers a step.
    TIP dense: B1 once a step.  TIP pages, on the float32 or the bf16 pages: B2 once a step.
    TIP strips sampled, and TIP pages sampled on the float32 pages: B10
    once and B8 twice (the negatives' forward and backward; the positives
    are scored over the full pages in PyTorch).
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
    DR-DF pages: B2 once a step; DR-DF chunked: as TIP chunked without the
    P-P side (no B5).  PR-HMP-NN runs no kernel.
    TIP sharded (each rank, on its quarter of the chunks): B10 once, B8 and
    B4 four times a step, as TIP chunked, and no B5; with the COO ring B11
    once a ring step in each of four ring SpMMs a step (two layers, forward
    and the backward's), n_ring launches each: 16 a step on the 1-D mesh
    of 4 ("tip sharded ring"), 8 on the 2 x 2 mesh's rings of 2; none over
    the dense P-P rows ("tip sharded dense-pp").  With remat ("tip sharded
    ring remat") the backward runs the whole encoder again, B4's forward in
    each layer and the two layers' ring SpMMs: B4 6 and B11 24 a step on
    the 1-D mesh of 4.  Rank 0's unsharded eval (windowed P-P) adds B4 2
    and B5 2.  The EP runs (EP_PATHS, each rank on its relations' block):
    on the strips B1 once a step, on the pages B2 once a step; chunked B10
    once, B8 (DistMult) or B9 (the NN decoder) four times and B4 four times
    (R = r_max) a step; with the COO ring B11 as above; rank 0's eval B4 2
    on the chunked layout and B5 2 where its P-P side is windowed (the COO
    ring's), B12 2 where it is dense (the dense rows' runs).
    B12 wherever the P-P side is the dense (A+I) of one process (every TIP
    path on the strips or the pages, and PP-GAE): 2 launches forward and 2
    backward a step, the eval's encode 2 (Decagon's d = 64 layer is two
    column blocks of 32: the same counts).  Decagon on the strips' uint8
    pages: B14 once a layer forward and backward (4 a step, the eval's 2),
    B13 once a step.  B15 wherever the R-GCN pair runs over the strips
    (TIP dense, strips sampled, TIP-NN dense, DR-NN dense, DR-DF dense, the
    EP strips runs on each rank's block): its forward and its backward
    once a step each (both layers' M in one contraction), the eval's
    encode once.  CompGCN on the strips: B16 forward and backward a step
    (the eval's encode once), B1's wide instance once a step, B12 on its
    200-column P-P operand in seven blocks of 32, forward and backward (7
    x 2 a step, the eval's 7)."""
    ev, rm = 2 * eval_rank, 2 * steps * remat
    pp = {"pp_aggregate": 4 * steps + ev}
    b15 = {"rgcn_contract": 2 * steps + eval_rank}
    sharded = {"typed_neg_sampler": steps, "distmult_sddmm": 4 * steps,
               "typed_neighbor_sum": 4 * steps + ev, "gcn_spmm": ev}
    if path in EP_PATHS:
        n_ring, pp, _, layout, decoder = EP_PATHS[path]
        want = {"strips": {"dense_bce_sym": steps, **b15},
                "pages": {"dense_bce": steps}}.get(layout, {
                    "typed_neg_sampler": steps,
                    ("nn_sddmm" if decoder == "nn" else "distmult_sddmm"):
                        4 * steps,
                    "typed_neighbor_sum": 4 * steps + ev})
        if pp == "coo":
            want.update(ring_spmm=4 * n_ring * steps, gcn_spmm=ev)
        elif ev:
            want["pp_aggregate"] = ev
        return want
    if path in SHARDED_PATHS:
        n_ring, pp, _, remat = SHARDED_PATHS[path]
        rm = 2 * steps * remat
        return {**sharded, "typed_neighbor_sum": 4 * steps + ev + rm,
                **({"ring_spmm": n_ring * (4 * steps + rm)}
                   if pp == "coo" else {})}
    return {
        "tip dense": {"dense_bce_sym": steps, **pp, **b15},
        "tip pages": {"dense_bce": steps, **pp},
        "tip pages bf16": {"dense_bce": steps, **pp},
        "tip strips sampled": {"typed_neg_sampler": steps,
                               "distmult_sddmm": 2 * steps, **pp, **b15},
        "tip pages sampled": {"typed_neg_sampler": steps,
                              "distmult_sddmm": 2 * steps, **pp},
        "tip chunked": {"typed_neg_sampler": steps, "distmult_sddmm": 4 * steps,
                        "typed_neighbor_sum": 4 * steps + ev + rm,
                        "gcn_spmm": 4 * steps + ev + rm},
        "tip-nn dense": {"typed_neg_sampler": steps, "nn_sddmm": 4 * steps,
                         **pp, **b15},
        "tip-nn chunked": {"typed_neg_sampler": steps, "nn_sddmm": 4 * steps,
                           "typed_neighbor_sum": 4 * steps + ev + rm,
                           "gcn_spmm": 4 * steps + ev + rm},
        "dr-nn dense": {"dense_bce_nn": steps, **b15},
        "dr-nn pages": {"dense_bce_nn": steps},
        "dr-nn chunked": {"typed_neg_sampler": steps, "nn_sddmm": 4 * steps,
                          "typed_neighbor_sum": 4 * steps + ev},
        "dr-df dense": {"dense_bce_sym": steps, **b15},
        "dr-df pages": {"dense_bce": steps},
        "dr-df chunked": {"typed_neg_sampler": steps,
                          "distmult_sddmm": 4 * steps,
                          "typed_neighbor_sum": 4 * steps + ev},
        "pr-hmp-nn flat": {},
        "pp-gae dense": pp,
        "decagon dense": {"rel_aggregate": 4 * steps + ev,
                          "dense_bce_dedicom": steps, **pp},
        "compgcn dense": {"rel_scaled": 2 * steps + eval_rank,
                          "dense_bce_sym": steps,
                          "pp_aggregate": 7 * (2 * steps + eval_rank)},
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


def with_heavy_pair(raw, copies: int = 200):
    """The raw graph with ``copies`` more copies of relation 0's first pair.
    ~180 of them land in the train split: a D-D count past int8's 127,
    within bf16's exact 256, so train() cannot build the strips and takes
    the bf16 pages (kernel B2's bf16 instantiation), as it does for any
    graph whose counts pass 127."""
    import dataclasses

    import numpy as np

    pairs = raw.dd_pair_list[0]
    heavy = np.concatenate([pairs, np.repeat(pairs[:, :1], copies, 1)], 1)
    return dataclasses.replace(raw, dd_pair_list=[heavy,
                                                  *raw.dd_pair_list[1:]])


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
    elif variant == "decagon":
        check(model.gs.dd_layout == "strips_pages" and "dd_adj_u8" in graph
              and "dd_adj_sym" not in graph,
              "decagon: not the uint8 pages alone")
        layout, n_rel = "dense", data.n_et
    elif variant == "compgcn":
        check(model.gs.dd_layout == "strips" and "dd_adj_sym" in graph
              and "dd_adj_t" not in graph and "dd_adj_u8" not in graph
              and graph["pp_a"].dtype == torch.int8,
              "compgcn: not the int8 strips and P-P A alone")
        layout, n_rel = "dense", data.n_et
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
    if variant == "compgcn":  # a step makes no float copy of the strips
        params = model.init(torch.Generator().manual_seed(1))
        for _, x in leaf_paths(params):
            x.requires_grad_(True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.loss(params, graph, 5).backward()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        check(extra < 4 * graph["dd_adj_sym"].numel(),
              f"compgcn: a step took {extra} bytes, as many as a float32 "
              "copy of the strips")
        del params
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


RESUME_EPOCHS = 4  # the resume phase: half, a checkpoint, the other half
PROFILE_EPOCHS = 5  # the profiler hook's run (it traces epochs 2-4)
# B1's kernel as torch.profiler names it (csrc/dense_bce_sym.cu; B2's is
# also a tile_kernel, over other pages)
B1_TRACE_NAME = ("tile_kernel<16, true>", "signed char const*")


def run_resume(data, dev) -> dict:
    """The resume phase, TIP-cat on the Decagon-shaped graph's strips (B1)
    through train(): RESUME_EPOCHS epochs uninterrupted, twice; half of
    them with ``checkpoint_every`` set, then a run resumed from that
    directory to the end; counters at 0 before each run, launches exact.
    The resumed run's per-epoch losses must equal the uninterrupted run's
    within rtol 1e-5 and its final metrics within 1e-4.  Not bit-equal by
    design: the encoder's drug-protein hierarchy sums with index_add_,
    whose atomics add in no fixed order on the card (B1's own sums are
    fixed-order); the two uninterrupted runs' agreement shows that spread.
    Returns the report."""
    import tempfile

    from tip_tpu_torch import kernels
    from tip_tpu_torch.config import ModelConfig, TrainConfig
    from tip_tpu_torch.train.loop import train

    cfg, half = ModelConfig.tip_cat(), RESUME_EPOCHS // 2
    runs, logs = {}, []
    with tempfile.TemporaryDirectory() as ck:
        for tag, epochs, kw in (
                ("full", RESUME_EPOCHS, {}), ("again", RESUME_EPOCHS, {}),
                ("half", half, {"checkpoint_dir": ck,
                                "checkpoint_every": half}),
                ("resumed", RESUME_EPOCHS, {"resume": ck})):
            resume = kw.pop("resume", None)
            kernels.reset_launch_counts()
            _, runs[tag] = train(cfg, TrainConfig(epochs=epochs, **kw), data,
                                 log=logs.append, device=dev, resume=resume)
            launches = dict(kernels.LAUNCHES)
            check_result("tip dense", len(runs[tag]["history"]), data.n_et,
                         runs[tag], launches)
        saved = sorted(os.listdir(ck))
    check(saved == [f"ep{half - 1}.npz", "final.npz"],
          f"resume: checkpoints {saved}")
    resumed_from = [json.loads(x) for x in logs if "resumed_from" in x]
    check(len(resumed_from) == 1 and resumed_from[0]["epoch"] == half,
          f"resume: {resumed_from}")
    full, again, resumed = runs["full"], runs["again"], runs["resumed"]
    check([h["epoch"] for h in resumed["history"]]
          == list(range(half, RESUME_EPOCHS)), "resume: resumed epochs")

    def diffs(a, b):
        la = {h["epoch"]: h["loss"] for h in a["history"]}
        loss = max(abs(h["loss"] - la[h["epoch"]]) / abs(la[h["epoch"]])
                   for h in b["history"])
        metric = max(abs(a["final"][k] - b["final"][k])
                     for k in ("auprc", "auroc", "ap"))
        return loss, metric

    loss_err, metric_err = diffs(full, resumed)
    check(loss_err <= 1e-5 and metric_err <= 1e-4,
          f"resume: losses {loss_err} (rtol 1e-5), metrics {metric_err} "
          "(1e-4) off the uninterrupted run")
    again_loss, again_metric = diffs(full, again)
    return {"epochs": RESUME_EPOCHS, "resumed_at": half,
            "losses_full": [h["loss"] for h in full["history"]],
            "losses_resumed": [h["loss"] for h in resumed["history"]],
            "loss_rel_err": loss_err, "metric_abs_err": metric_err,
            "bit_equal": bool(loss_err == 0.0 and metric_err == 0.0),
            "uninterrupted_twice": {"loss_rel_err": again_loss,
                                    "metric_abs_err": again_metric},
            "final_full": full["final"], "final_resumed": resumed["final"]}


def run_profile_hook(data, dev) -> dict:
    """The profiler hook: TIP-cat on the Decagon-shaped graph's strips
    through train(..., profile_dir=) for PROFILE_EPOCHS epochs (counters at
    0 before, launches exact); the Chrome trace it writes must hold B1's
    kernel as CUDA events, once for each traced epoch (2-4).  Returns the
    report."""
    import tempfile

    from tip_tpu_torch import kernels
    from tip_tpu_torch.config import ModelConfig, TrainConfig
    from tip_tpu_torch.train.loop import PROFILE_EPOCHS as TRACED, TRACE_FILE
    from tip_tpu_torch.train.loop import train

    with tempfile.TemporaryDirectory() as d:
        kernels.reset_launch_counts()
        _, result = train(ModelConfig.tip_cat(),
                          TrainConfig(epochs=PROFILE_EPOCHS), data,
                          log=lambda s: None, device=dev, profile_dir=d)
        launches = dict(kernels.LAUNCHES)
        check_result("tip dense", PROFILE_EPOCHS, data.n_et, result, launches)
        path = os.path.join(d, TRACE_FILE)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    b1 = [e for e in kern
          if all(p in e.get("name", "") for p in B1_TRACE_NAME)]
    traced = TRACED[1] - TRACED[0] + 1
    check(len(b1) == traced, f"profile hook: {len(b1)} B1 kernel events in "
          f"the trace, want {traced} (of {len(kern)} kernel events)")
    return {"epochs": PROFILE_EPOCHS, "traced_epochs": list(TRACED),
            "trace_bytes": size, "kernel_events": len(kern),
            "b1_events": len(b1), "b1_name": b1[0]["name"][:120],
            "b1_us": [e.get("dur") for e in b1], "launches": launches}


def run_remat(data, dev) -> dict:
    """remat on the graph beyond the dense budget (the chunked layout, where
    the encoder's intermediates are largest): one step's loss and
    gradients (TIP-cat, TIP.loss then backward) with and without remat,
    counters at 0 before each; launches exact (remat runs B4's forward and
    B5 once more in each layer); the loss within 1e-5 and each gradient
    within 1e-4 of its largest, relative (B4's and B8's backwards add in no
    fixed order); max_memory_allocated both ways.  Returns the report."""
    import torch

    from tip_tpu_torch import convert, kernels
    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.train.loop import step_seed
    from tip_tpu_torch.train.model import TIP, make_graph_arrays

    graph, gs = make_graph_arrays(data, dev, dense_dtype=None)
    model = TIP.for_data(ModelConfig.tip_cat(), data, gs, dev)
    out, rep = {}, {"dd_layout": gs.dd_layout, "pp_layout": gs.pp_layout}
    for remat in (False, True):
        params = model.init(torch.Generator().manual_seed(0))
        for p in convert.leaves(params):
            p.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        loss = model.loss(params, graph, step_seed(0, 0), remat=remat)
        loss.backward()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want = expected_launches("tip chunked", 1, eval_rank=False,
                                 remat=remat)
        for name in kernels.KERNELS:
            check(launches[name] == want.get(name, 0),
                  f"remat={remat}: {name} launched {launches[name]} times, "
                  f"expected {want.get(name, 0)}")
        peak = torch.cuda.max_memory_allocated()
        out[remat] = (loss.item(), [p.grad for p in convert.leaves(params)])
        rep["remat" if remat else "plain"] = {
            "loss": loss.item(), "launches": launches,
            "max_memory_allocated": peak, "allocated_before": before,
            "step_peak_bytes": peak - before}
        del loss
    (l0, g0), (l1, g1) = out[False], out[True]
    loss_err = abs(l1 - l0) / abs(l0)
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(g1, g0))
    check(loss_err <= 1e-5 and grad_err <= 1e-4,
          f"remat: loss {loss_err} (1e-5), grads {grad_err} (1e-4) of max")
    rep.update(loss_rel_err=loss_err, grad_err_frac=grad_err)
    del graph, out
    torch.cuda.empty_cache()
    return rep


def run_backend_ab(path: str, data, dev, dense_dtype, card: str) -> dict:
    """The ``backend`` switch on one TIP-cat path ("tip dense": the strips;
    "tip chunked": the chunked layout beyond the dense budget), on one
    packed graph: under backend="pallas" and under "xla", BACKEND_STEPS
    Adam steps from the same init (train/loop.py's step: the epoch's
    step_seed, a sync on each loss) and the eval, every kernel counter 0
    just before; "pallas" must launch exactly the path's expected_launches,
    "xla" nothing (the JAX package's XLA branches launch no kernel).  Then,
    from the same parameters, z of both routes within 1e-4 of its max, and
    on the strips the loss with the thresholds zeroed (B1 against the plain
    estimator: 1e-5 relative), on the chunked layout the positives' scores
    (B8 against the gathers: 1e-5 of their max over the real slots); then
    each route's steps profiled (device busy ms, idle share; the xla
    route's counters still 0).  Prints a ``backend:`` line (each route's
    step median, busy ms and idle share) and the card; returns the line."""
    import numpy as np
    import torch

    from tip_tpu_torch import convert, kernels
    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.scripts.sharded import zero_thresholds
    from tip_tpu_torch.train.loop import step_seed
    from tip_tpu_torch.train.model import (
        TIP, make_graph_arrays, make_test_arrays,
    )

    cfg = ModelConfig.tip_cat()
    graph, gs = make_graph_arrays(data, dev, dense_dtype=dense_dtype)
    test = make_test_arrays(data, dev)
    models = {r: TIP.for_data(cfg, data, gs, dev, backend=r)
              for r in ("pallas", "xla")}
    rep = {"path": path, "dd_layout": gs.dd_layout, "steps": BACKEND_STEPS,
           "card": card}
    for route, model in models.items():
        gen = torch.Generator().manual_seed(0)
        params = model.init(gen)
        for p in convert.leaves(params):
            p.requires_grad_(True)
        test_neg = model.sample_test_negatives(gen, test)
        opt = torch.optim.Adam(convert.leaves(params), lr=0.01)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        losses, step_ms = [], []
        for k in range(BACKEND_STEPS):
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = model.loss(params, graph, step_seed(0, k))
            loss.backward()
            opt.step()
            losses.append(float(loss))  # waits for the device
            step_ms.append(1e3 * (time.perf_counter() - t0))
        _, avg = model.evaluate(params, graph, test, test_neg)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want = (expected_launches(path, BACKEND_STEPS) if route == "pallas"
                else {})
        for name in kernels.KERNELS:
            check(launches[name] == want.get(name, 0),
                  f"backend {route} on {path} launched {name} "
                  f"{launches[name]} times, expected {want.get(name, 0)}")
        check(all(np.isfinite(losses)), f"backend {route} losses {losses}")
        for k, v in avg.items():
            check(0.0 <= float(v) <= 1.0, f"backend {route} metric {k} {v}")
        rep[route] = {"losses": losses, "step_ms_all": step_ms,
                      "step_ms_median": sorted(step_ms)[len(step_ms) // 2],
                      "final": {k: float(v) for k, v in avg.items()},
                      "launches": {k: v for k, v in launches.items() if v}}
        del params, opt
    params = models["pallas"].init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        z = {r: m.encode(params, graph) for r, m in models.items()}
        ez, mz = max_err(z["xla"], z["pallas"])
        check(ez <= 1e-4 * mz, f"backend z on {path}: err {ez} of max {mz}")
        rep["z_err_frac"] = ez / mz
        if gs.dd_layout == "strips":
            det = zero_thresholds(graph)
            loss = {r: m.loss(params, det, seed=0).item()
                    for r, m in models.items()}
            err = abs(loss["xla"] - loss["pallas"])
            check(err <= 1e-5 * abs(loss["pallas"]),
                  f"backend loss on {path}: {loss}")
            rep["loss_zeroed_thresholds"] = loss
        else:
            real = graph["dd_valid"] > 0
            sc = {r: m.score_padded(params, z["pallas"], graph["dd_src2d"],
                                    graph["dd_dst2d"], graph["dd_chunk_type"],
                                    sigmoid=False)[real]
                  for r, m in models.items()}
            es, ms = max_err(sc["xla"], sc["pallas"])
            check(es <= 1e-5 * ms, f"backend scores on {path}: err {es} of "
                  f"max {ms}")
            rep["score_err_frac"] = es / ms
    del params, z
    for route, model in models.items():
        kernels.reset_launch_counts()
        prof = profile_steps(model, graph)
        torch.cuda.synchronize()
        if route == "xla":
            check(not any(kernels.LAUNCHES.values()),
                  f"backend xla on {path} launched {dict(kernels.LAUNCHES)} "
                  "while profiled")
        rep[route].update({k: prof[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share")}, top=prof["top"][:5])
    del graph, models
    torch.cuda.empty_cache()
    print("backend:", json.dumps(rep))
    print(card)
    return rep


def check_ring_spmm(data, dev) -> dict:
    """Kernel B11 against its plain version at Decagon shape with
    SHARDED_RANKS ranks, one process each on this card (spawned; CUDA IPC
    between them), at both GCN widths (d = 32, 16), forward and backward
    (the gradient of sum(out * cot) through each), and the ring's output
    against the replicated A_hat @ h.  f32 both ways, summed in another
    order: 1e-5 of the largest magnitude.  Then one ring step timed in this
    process on a loopback ring (a second local buffer stands in for the
    left neighbour, the barrier passes on its own flag), its plain step,
    and ``torch.sparse.mm`` over the block as CSR [n_local, n_local]."""
    import numpy as np
    import torch

    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.ops import ring as ops_ring
    from tip_tpu_torch.ops.segment import segment_sum_sorted, weighted_gather_sum
    from tip_tpu_torch.parallel.ring import build_ring_pp
    from tip_tpu_torch.scripts import sharded

    k, n = SHARDED_RANKS, data.n_prot
    cfg = ModelConfig.tip_cat()
    ring = build_ring_pp(data.pp_norm_index, data.pp_norm_weight,
                         data.dp_edge_index, n, k)
    n_local = ring.n_local
    rng = np.random.default_rng(31)
    widths = (cfg.pp_hid1, cfg.pp_hid2)
    inputs = []
    for d in widths:
        h = np.zeros((k * n_local, d), np.float32)
        h[:n] = rng.standard_normal((n, d))
        inputs.append((h, rng.standard_normal((k * n_local, d)).astype(np.float32)))
    ranks = sharded.spawn_ranks(
        sharded.ring_spmm_rank, k,
        sharded.RingJob(ring.src_local, ring.dst_local, ring.weight,
                        tuple(inputs)), timeout_s=SHARDED_TIMEOUT_S)
    src, dst = (torch.from_numpy(data.pp_norm_index[i].astype("int64")).to(dev)
                for i in (0, 1))
    wn = torch.from_numpy(data.pp_norm_weight).to(dev)
    rep = {"ranks": k, "n_local": n_local, "e_pad": ring.src_local.shape[2],
           "real_edges_per_block": [int(c) for c in
                                    (ring.weight != 0).sum(-1).reshape(-1)]}
    worst = 0.0
    for j, d in enumerate(widths):
        got = {route: [torch.from_numpy(np.concatenate(
            [r[route][j][i] for r in ranks])) for i in (0, 1)]
            for route in ("op", "plain")}
        ef, mf = max_err(got["op"][0], got["plain"][0])
        eb, mb = max_err(got["op"][1], got["plain"][1])
        check(ef <= 1e-5 * mf, f"B11 d={d} forward err {ef} of max {mf}")
        check(eb <= 1e-5 * mb, f"B11 d={d} backward err {eb} of max {mb}")
        h, cot = (torch.from_numpy(a).to(dev) for a in inputs[j])
        ed, md = max_err(got["op"][0][:n].to(dev),
                         weighted_gather_sum(h[:n], src, dst, wn, n))
        check(ed <= 1e-5 * md, f"B11 d={d} against A_hat @ h: err {ed} of {md}")
        rep[f"d{d}"] = {"fwd_max_abs_err": ef, "fwd_max": mf,
                        "bwd_max_abs_err": eb, "bwd_max": mb,
                        "vs_replicated_max_abs_err": ed}
        worst = max(worst, ef, eb)
    # each rank: the op's forward and its backward at each width, k launches
    want = 2 * len(widths) * k
    for r in ranks:
        check(r["launches"]["ring_spmm"] == want,
              f"B11 check launched {r['launches']['ring_spmm']}, expected {want}")
    rep["max_abs_err"] = worst

    # one ring step (rank 0's block s = 1) at layer 1's width, timed here
    d, s = cfg.pp_hid1, 1
    blk = [torch.from_numpy(np.ascontiguousarray(a[0, s])).to(dev)
           for a in (ring.src_local, ring.dst_local, ring.weight)]
    h = torch.randn(n_local, d, generator=torch.Generator().manual_seed(32)).to(dev)
    plain = segment_sum_sorted(h[blk[0].long()] * blk[2][:, None], blk[1], n_local)
    comm = ops_ring.RingComm.loopback(n_local, d, dev)
    try:
        out = torch.zeros(n_local, d, device=dev)
        ops_ring.ring_step_cuda(h, out, *blk, comm, 0, copy=True)
        e1, m1 = max_err(out, plain)
        check(e1 <= 1e-5 * m1, f"B11 loopback step err {e1} of max {m1}")
        rep["ms"] = cuda_ms(lambda: ops_ring.ring_step_cuda(
            h, out, *blk, comm, 0, copy=True), reps=50, primed=True)
        rep["no_copy_ms"] = cuda_ms(lambda: ops_ring.ring_step_cuda(
            h, out, *blk, comm, 0, copy=False), reps=50, primed=True)
    finally:
        comm.close()
    rep["plain_ms"] = cuda_ms(lambda: segment_sum_sorted(
        h[blk[0].long()] * blk[2][:, None], blk[1], n_local), reps=10)
    real = blk[2] != 0
    crow = torch.zeros(n_local + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(blk[1].long()[real],
                                           minlength=n_local), 0)
    adj = torch.sparse_csr_tensor(crow, blk[0].long()[real], blk[2][real],
                                  (n_local, n_local))
    rep["library_ms"] = library_call(lambda: torch.sparse.mm(adj, h), plain,
                                     1e-5, "B11")
    e_real = int(real.sum())
    # the block's real edges read once (src, dst, w), the shard read once,
    # out read and written, the neighbour's slot written
    rep.update(bound(12 * e_real + 4 * n_local * d * 4, 2 * e_real * d))
    rep.update(d=d, step=s, block_edges=e_real)
    return rep


def leaf_paths(tree, prefix: str = "") -> list:
    """[(dotted path, leaf)] of a nested dict, in convert.leaves order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [x for k in sorted(tree)
            for x in leaf_paths(tree[k], f"{prefix}.{k}" if prefix else k)]


def sharded_references(data, dev, job) -> dict:
    """Single-process TIP on this process's GPU for the sharded probes:
    {key: (z, loss, grads)}, key the P-P form of a chunked run ('coo': the
    windowed P-P side, B5, the COO ring's reference; 'dense': the dense
    one) and the name of an EP run (its layout, decoder and P-P side),
    parameters from the job's seed.  The loss is taken under the probe's
    draws on the sampled routes (their rows re-ordered from an EP run's
    chunk order to the graph's, sharded.reference_draws), with the
    thresholds zeroed on the fused ones (B1, B2: no negatives)."""
    import dataclasses

    import torch

    from tip_tpu_torch import convert
    from tip_tpu_torch.ops.sampler import draws_per_slot
    from tip_tpu_torch.scripts import sharded
    from tip_tpu_torch.train.model import TIP, make_graph_arrays

    refs = {}
    for run in job.runs:
        key = run.name if run.ep else run.pp
        if key in refs:
            continue
        cfg = dataclasses.replace(job.cfg, decoder=run.decoder)
        graph, gs = make_graph_arrays(
            data, dev, dense_dtype=sharded.LAYOUT_DTYPE[run.layout],
            pp_dense=run.pp == "dense", decoder=run.decoder)
        model = TIP.for_data(cfg, data, gs, dev)
        params = model.init(torch.Generator().manual_seed(sharded.SEED))
        for p in convert.leaves(params):
            p.requires_grad_(True)
        u24 = None
        if sharded.sampled_route(cfg, gs):
            width = draws_per_slot(gs.n_drug) * gs.dd_chunk
            if run.ep:
                order = sharded.ep_order(data, SHARDED_RANKS, gs.dd_chunk)
                u24 = sharded.reference_draws(sharded.probe_draws(
                    sharded.DRAWS_SEED, order.shape[0], width), order,
                    gs.dd_n_chunks)
            else:
                n_padded = -(-gs.dd_n_chunks // SHARDED_RANKS) * SHARDED_RANKS
                u24 = sharded.probe_draws(sharded.DRAWS_SEED, n_padded,
                                          width)[: gs.dd_n_chunks]
            u24 = torch.from_numpy(u24)
        else:
            graph = sharded.zero_thresholds(graph)
        with torch.no_grad():
            z = model.encode(params, graph).cpu()
        loss = model.loss(params, graph, seed=0, u24=u24)
        loss.backward()
        refs[key] = (z, loss.item(),
                     [p.grad.cpu() for p in convert.leaves(params)])
        del graph, params, loss
        torch.cuda.empty_cache()
    return refs


def run_sharded(data, dev) -> dict:
    """The sharded entry point's worker (tip_tpu_torch/scripts/sharded.py:
    train_rank) on SHARDED_RANKS processes sharing this card: TIP-cat at
    published widths on the Decagon-shaped graph, for each of the paths of
    SHARDED_PATHS (mesh, P-P ring, remat: the probe and the steps
    recompute the encoder in the backward; the remat path's line prints
    its ranks' peak bytes beside its plain twin's, ranks 1-3 the steps'
    alone) and EP_PATHS (relation-partitioned: the strips on the 1-D and
    the 2 x 2 mesh, the float32 pages, the chunked layout with the NN
    decoder and with DistMult).  Each rank first probes: z, and the loss
    and gradients (EP: gathered and un-EP'd) under fixed draws or, on the
    fused routes, zeroed thresholds, against the single-process ones
    (sharded_references; float32 throughout, the COO ring on the chunked
    layout or the pages: z 1e-4 of max, loss rtol 1e-5, grads 1e-4 of each
    leaf's max; bf16 operands, the dense P-P rows or the strips: z 2^-8,
    loss 1e-3, grads 2e-2), and on the sampled routes each rank's loss
    under the step seed against its loss under the hashed draws of the
    rank-folded seed passed in (B10 hashing against B10 reading the plain
    field: rtol 1e-6); then trains with every launch counter at 0 just
    before the
    steps (each rank's counts exact, expected_launches), and rank 0 runs the
    unsharded eval.  The fixed-draw loss must fall, the losses and the
    parameters must be the same on every rank after every step.  Prints a
    ``sharded:`` line a path; returns rank 0's launches by path."""
    import numpy as np
    import torch

    from tip_tpu_torch import kernels
    from tip_tpu_torch.scripts import sharded
    from tip_tpu_torch.scripts.decoder_ab import DECAGON_SHAPE

    runs = tuple(sharded.ShardedRun(name, n_ring, pp, steps, probe=True,
                                    remat=remat)
                 for name, (n_ring, pp, steps, remat)
                 in SHARDED_PATHS.items()) + tuple(
        sharded.ShardedRun(name, n_ring, pp, steps, probe=True, ep=True,
                           layout=layout, decoder=decoder)
        for name, (n_ring, pp, steps, layout, decoder) in EP_PATHS.items())
    job = sharded.ShardedJob(runs=runs, raw=DECAGON_SHAPE, device="cuda")
    refs = sharded_references(data, dev, job)
    torch.cuda.empty_cache()
    t0 = time.time()
    out = sharded.spawn_ranks(sharded.train_rank, SHARDED_RANKS, job,
                              timeout_s=SHARDED_TIMEOUT_S)
    spawn_sec = time.time() - t0
    launches, peaks = {}, {}
    for i, run in enumerate(runs):
        rs = [r[i] for r in out]
        z_ref, loss_ref, grads_ref = refs[run.name if run.ep else run.pp]
        # float32 throughout (the COO ring, the chunked layout or the float32
        # pages) or bf16 operands (the dense P-P rows; the strips, whose
        # ranks each round their partial M to bf16)
        tight = run.pp == "coo" and run.layout != "strips"
        tol = (1e-4, 1e-5, 1e-4) if tight else (2.0**-8, 1e-3, 2e-2)
        probe = {"z_err_frac": 0.0, "grad_err_frac": 0.0, "fold_err": 0.0}
        for r in rs:
            ez, mz = max_err(torch.from_numpy(r["z"]), z_ref)
            check(ez <= tol[0] * mz, f"{run.name} rank {r['rank']}: z err "
                  f"{ez} of max {mz}")
            check(abs(r["probe_loss"] - loss_ref) <= tol[1] * abs(loss_ref),
                  f"{run.name} rank {r['rank']}: loss {r['probe_loss']} vs "
                  f"{loss_ref}")
            check(run.ep == (r["r_max"] > 0) and r["layout"] == run.layout,
                  f"{run.name} rank {r['rank']}: layout {r['layout']}, "
                  f"r_max {r['r_max']}")
            if "fold_losses" in r:  # the sampled routes
                hashed, passed = r["fold_losses"]
                check(abs(hashed - passed) <= 1e-6 * abs(passed),
                      f"{run.name} rank {r['rank']}: rank-folded seed's loss "
                      f"{hashed} vs its draws passed in {passed}")
                probe["fold_err"] = max(probe["fold_err"],
                                        abs(hashed - passed))
            errs = {path: max_err(torch.from_numpy(g), w) for (path, g), w in
                    zip(leaf_paths(r["probe_grads"]), grads_ref)}
            if r["rank"] == 0:
                probe["grad_err_by_leaf"] = errs
            for path, (eg, mg) in errs.items():
                check(eg <= tol[2] * mg, f"{run.name} rank {r['rank']}: grad "
                      f"of {path} err {eg} of max {mg}; all: {errs}")
                probe["grad_err_frac"] = max(probe["grad_err_frac"], eg / mg)
            probe["z_err_frac"] = max(probe["z_err_frac"], ez / mz)
        r0 = rs[0]
        probe.update(loss=r0["probe_loss"], loss_ref=loss_ref,
                     loss_after=r0["probe_loss_after"])
        losses = r0["losses"]
        check(len(losses) == run.steps and bool(np.isfinite(losses).all()),
              f"{run.name} losses {losses}")
        check(r0["probe_loss_after"] < r0["probe_loss"],
              f"{run.name}: the fixed-draw loss did not fall: "
              f"{r0['probe_loss']} -> {r0['probe_loss_after']}")
        check(all(r["losses"] == losses and r["digests"] == r0["digests"]
                  for r in rs), f"{run.name}: ranks disagree on the loss or "
              "the parameters")
        for k in ("auprc", "auroc", "ap"):
            check(0.0 <= r0["final"][k] <= 1.0, f"{run.name} metric {k}")
            per = r0["per_relation"][k]
            check(per.shape == (data.n_et,) and bool(np.all((per >= 0) & (per <= 1))),
                  f"{run.name} per-relation {k}")
        want0 = expected_launches(run.name, run.steps)
        for r in rs:
            want = want0 if r["rank"] == 0 else expected_launches(
                run.name, run.steps, eval_rank=False)
            for name in kernels.KERNELS:
                check(r["launches"][name] == want.get(name, 0),
                      f"{run.name} rank {r['rank']} launched {name} "
                      f"{r['launches'][name]} times, expected {want.get(name, 0)}")
        launches[run.name] = dict(r0["launches"])
        peaks[run.name] = [r["peak_bytes"] for r in rs]
        twin = {}
        if run.remat:  # rank 0's peak holds the unsharded eval, the others' not
            plain = run.name[:-len(" remat")]
            twin = {"plain_path": plain,
                    "plain_peak_bytes_by_rank": peaks[plain]}
        step_ms = sorted(r0["step_ms"][1:]) or r0["step_ms"]
        print("sharded: " + json.dumps({
            "variant": "tip-cat" if run.decoder == "distmult" else "tip-cat-nn",
            "path": run.name, "ranks": SHARDED_RANKS,
            "mesh": [run.n_ring, SHARDED_RANKS // run.n_ring], "pp": run.pp,
            "ep": run.ep, "layout": run.layout, "r_max": r0["r_max"],
            "remat": run.remat,
            "note": f"{SHARDED_RANKS} ranks time-sliced on one "
                    f"{torch.cuda.get_device_name(0)}, not a multi-GPU figure",
            "losses": losses, "step_ms_median": step_ms[len(step_ms) // 2],
            "step_ms_all": r0["step_ms"], "final": r0["final"],
            "peak_bytes_by_rank": peaks[run.name], **twin,
            "device_by_rank": [r["device"] for r in rs],
            "ring_rank_by_rank": [r["ring_rank"] for r in rs],
            "launches_rank0": r0["launches"],
            "train_launches_by_rank": [r["train_launches"] for r in rs],
            "probe": probe, "dd_n_chunks": r0["dd_n_chunks"],
            "spawn_sec": spawn_sec}))
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


# The data phase's raw CSVs: BioSNAP's Decagon files at their published
# sizes (bio-decagon-combo: 4,649,441 drug-drug-side-effect rows over 645
# drugs and 1,317 side effects; bio-decagon-ppi: 715,612 rows over 19,081
# proteins; bio-decagon-targets: 18,596 targets inside the PPI, here with 94
# more outside it, which preprocessing drops; bio-decagon-mono: 174,977
# rows over 10,184 mono side effects), random from a seed
DECAGON_CSV = dict(n_drug=645, n_prot=19081, n_combo=4649441, n_se=1317,
                   n_ppi=715612, n_targets=18596, n_targets_out=94,
                   n_mono=174977, n_mono_se=10184)
DATA_BAND = (1000, 5000)  # --et-band: the reference's 1k-5k nnz band
DATA_EPOCHS = 5
DICE_BITS = 1 << 15  # fold_fingerprints' default width


def _unique_pairs(rng, n: int, m: int, weights=None):
    """m distinct unordered pairs (i < j) of n nodes, endpoints drawn by
    ``weights`` (uniform without)."""
    import numpy as np

    if m > n * (n - 1) // 2:
        raise ValueError(f"{m} distinct pairs of {n} nodes do not exist")
    keys = np.empty(0, np.int64)
    while keys.size < m:
        a = rng.choice(n, size=2 * (m - keys.size) + 64, p=weights)
        b = rng.choice(n, size=a.size, p=weights)
        a, b = a[a != b], b[a != b]
        new = np.minimum(a, b).astype(np.int64) * n + np.maximum(a, b)
        keys = np.unique(np.concatenate([keys, new]))
    keys = rng.permutation(keys)[:m]
    return keys // n, keys % n


def write_biosnap_csvs(raw_dir: str, seed: int, *, n_drug: int, n_prot: int,
                       n_combo: int, n_se: int, n_ppi: int, n_targets: int,
                       n_targets_out: int, n_mono: int,
                       n_mono_se: int) -> dict:
    """Write bio-decagon-{combo,ppi,targets,mono}.csv (the sizes of
    DECAGON_CSV's keys) with Decagon's columns and codes (CID drugs, UMLS C
    side effects, Entrez gene ids) into raw_dir.  Side effects' pair counts
    are log-normal (sigma 1.2), so a band of nnz keeps part of them; pairs
    are distinct within a side effect and listed in either order; every
    protein appears in the PPI; the targets are drawn from all drugs and
    proteins (drug 0 and protein 0 among them).  The side effects' codes include Decagon's reported best and worst ones
    (analysis/report.py).  Returns {UMLS id: name} of the side effects."""
    import numpy as np

    from tip_tpu_torch.analysis.report import (
        DECAGON_BEST_ORG_ID, DECAGON_WORST_ORG_ID,
    )

    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    drug_code = rng.choice(10 ** 8, n_drug, replace=False) + 1
    gene = rng.choice(10 ** 6, n_prot + n_targets_out, replace=False) + 1
    gene, gene_out = gene[:n_prot], gene[n_prot:]
    reported = np.array(DECAGON_BEST_ORG_ID + DECAGON_WORST_ORG_ID)
    se_code = np.concatenate([reported, rng.choice(
        np.setdiff1d(np.arange(1, 10 ** 7), reported),
        n_se - reported.size, replace=False)])
    names = {int(c): f"side effect {int(c)}" for c in se_code}

    sizes = rng.lognormal(0.0, 1.2, n_se)
    sizes = np.maximum(1, np.floor(sizes / sizes.sum() * n_combo)).astype(int)
    sizes[np.argmax(sizes)] += n_combo - sizes.sum()
    d1, d2, se = [], [], []
    for t, m in enumerate(sizes):
        a, b = _unique_pairs(rng, n_drug, int(m))
        swap = rng.random(m) < 0.5
        d1.append(np.where(swap, b, a))
        d2.append(np.where(swap, a, b))
        se.append(np.full(m, t))
    order = rng.permutation(n_combo)
    d1, d2, se = (np.concatenate(x)[order] for x in (d1, d2, se))
    dc = [f"CID{c:09d}" for c in drug_code]
    sc = [f"C{c:07d},{names[int(c)]}" for c in se_code]
    with open(os.path.join(raw_dir, "bio-decagon-combo.csv"), "w") as f:
        f.write("STITCH 1,STITCH 2,Polypharmacy Side Effect,"
                "Side Effect Name\n")
        f.write("".join(f"{dc[i]},{dc[j]},{sc[t]}\n" for i, j, t in
                        zip(d1.tolist(), d2.tolist(), se.tolist())))

    # a chain through every protein first, then pairs drawn by a skewed
    # degree weight (hub proteins, as in the PPI)
    perm = rng.permutation(n_prot)
    w = 1.0 / (np.arange(n_prot) + 10.0) ** 0.8
    w = w[rng.permutation(n_prot)]
    a, b = _unique_pairs(rng, n_prot, n_ppi, w / w.sum())
    chain = np.minimum(perm[:-1], perm[1:]) * n_prot + np.maximum(
        perm[:-1], perm[1:])
    rest = np.setdiff1d(a.astype(np.int64) * n_prot + b, chain,
                        assume_unique=True)
    rest = rng.permutation(rest)[:n_ppi - chain.size]
    pairs = np.concatenate([chain, rest])
    p1, p2 = pairs // n_prot, pairs % n_prot
    with open(os.path.join(raw_dir, "bio-decagon-ppi.csv"), "w") as f:
        f.write("Gene 1,Gene 2\n")
        f.write("".join(f"{gene[i]},{gene[j]}\n"
                        for i, j in zip(p1.tolist(), p2.tolist())))

    # the combo file's first drug targets the PPI file's first protein:
    # drug 0 and protein 0 once preprocessed
    first = d1[0] * n_prot + p1[0]
    tk = rng.choice(n_drug * n_prot, n_targets + 1, replace=False)
    tk = np.concatenate([[first], tk[tk != first]])[:n_targets]
    rows = [f"{dc[k // n_prot]},{gene[k % n_prot]}\n" for k in tk.tolist()]
    rows += [f"{dc[i]},{g}\n" for i, g in
             zip(rng.integers(0, n_drug, n_targets_out).tolist(),
                 gene_out.tolist())]
    with open(os.path.join(raw_dir, "bio-decagon-targets.csv"), "w") as f:
        f.write("STITCH,Gene\n")
        f.write("".join(rng.permutation(rows)))

    mono_code = rng.choice(10 ** 7, n_mono_se, replace=False) + 1
    mk = rng.choice(n_drug * n_mono_se, n_mono, replace=False)
    with open(os.path.join(raw_dir, "bio-decagon-mono.csv"), "w") as f:
        f.write("STITCH,Individual Side Effect,Side Effect Name\n")
        f.write("".join(
            f"{dc[k // n_mono_se]},C{mono_code[k % n_mono_se]:07d},mono\n"
            for k in mk.tolist()))
    return names


def biosnap_targets(raw_dir: str, data_dir: str) -> set:
    """{(protein id, drug id)} of bio-decagon-targets.csv through the id
    maps preprocess_decagon wrote, targets outside the PPI left out; holds
    (0, 0) (write_biosnap_csvs)."""
    import pickle

    maps = {}
    for name in ("drug-map", "protein-map"):
        with open(os.path.join(data_dir, "index_map", f"{name}.pkl"),
                  "rb") as f:
            maps[name] = pickle.load(f)
    drug, prot = maps["drug-map"], maps["protein-map"]
    with open(os.path.join(raw_dir, "bio-decagon-targets.csv")) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    out = {(prot[int(g)], drug[int(d[3:])]) for d, g in rows
           if int(g) in prot}
    check((0, 0) in out, "no target on drug 0 and protein 0")
    return out


def _graphs_equal(a, b) -> bool:
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if hasattr(x, "edge_index"):
            x = (x.edge_index, x.edge_type, x.range_list)
            y = (y.edge_index, y.edge_type, y.range_list)
        elif not isinstance(x, np.ndarray):
            if x != y:
                return False
            continue
        else:
            x, y = (x,), (y,)
        for u, v in zip(x, y):
            if u.dtype != v.dtype or not np.array_equal(u, v):
                return False
    return True


def run_native_packing(raw, card: str):
    """The Decagon-shaped packing (build_trigraph) on this machine's host
    through the native library (tip_tpu_torch/native, the main path) and
    through its plain numpy versions (native.plain_versions), alternating
    library, plain, plain, library; the graphs must be bit-equal.  Then
    each of the four entry points alone on the packed graph's own inputs,
    both ways (best of 3).  Prints a ``native:`` line; returns the
    library's graph and its first packing's seconds."""
    import numpy as np

    from tip_tpu_torch import native
    from tip_tpu_torch.data import build_trigraph, packing

    graphs, secs = {}, {"library": [], "plain": []}
    for way in ("library", "plain", "plain", "library"):
        t0 = time.perf_counter()
        if way == "plain":
            with native.plain_versions():
                g = build_trigraph(raw, 0.9, 1111)
        else:
            g = build_trigraph(raw, 0.9, 1111)
        secs[way].append(time.perf_counter() - t0)
        if way in graphs:
            check(_graphs_equal(g, graphs[way]), f"native: {way} repacks alike")
        graphs[way] = g
        del g
    check(_graphs_equal(graphs["library"], graphs["plain"]),
          "native: the library's graph is the plain versions' bit for bit")
    data = graphs.pop("library")
    del graphs
    tr = data.dd_train
    src, dst = tr.edge_index
    n = data.n_drug
    stride = packing.bitmap_stride_bits(n)
    keys = tr.edge_type.astype(np.int64) * stride + dst.astype(np.int64) * n + src
    counts = tr.counts()
    padded = np.maximum(1, -(-counts // 512)) * 512
    outs = np.cumsum(padded) - padded
    calls = {
        "sort_edges_order": lambda: native.sort_edges_order(
            tr.edge_type, dst, src, n),
        "build_bitmap": lambda: native.build_bitmap(keys, data.n_et * stride),
        "pad_typed_fill": lambda: native.pad_typed_fill(
            src, dst, tr.range_list, outs, int(padded.sum()), n),
        "bincount_i32": lambda: native.bincount_i32(dst, n),
    }
    alone = {}
    for name, call in calls.items():
        times = {}
        for way in ("library", "plain"):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                if way == "plain":
                    with native.plain_versions():
                        out = call()
                else:
                    out = call()
                best = min(best, time.perf_counter() - t0)
            times[way] = (best, out)
        a, b = times["library"][1], times["plain"][1]
        same = all(np.array_equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a if isinstance(a, tuple) else (a,),
                                   b if isinstance(b, tuple) else (b,)))
        check(same, f"native: {name} equals its plain version")
        alone[name] = {"library_s": times["library"][0],
                       "plain_s": times["plain"][0]}
    rep = {"card": card, "host_cpus": os.cpu_count(),
           "dd_train_edges": tr.n_edges,
           "build_trigraph_library_s": secs["library"],
           "build_trigraph_plain_s": secs["plain"], "bit_equal": True,
           "alone": alone}
    print("native:", json.dumps(rep))
    return data, secs["library"][0]


def dice_counts(n_drug: int, seed: int = 0):
    """Folded counted fingerprints [n_drug, DICE_BITS] of random molecules:
    20-120 environment identifiers each, counts 1-6."""
    import numpy as np

    from tip_tpu_torch.data.drug_structure import fold_fingerprints

    rng = np.random.default_rng(seed)
    fps = []
    for _ in range(n_drug):
        ids = rng.integers(0, 2 ** 63, rng.integers(20, 121), dtype=np.int64)
        fps.append({int(i): int(c) for i, c in
                    zip(ids, rng.integers(1, 7, ids.size))})
    return fold_fingerprints(fps, n_bits=DICE_BITS)


def run_data_path(dev, card: str) -> dict:
    """The port's data and analysis layers end to end on the card: the
    BioSNAP-shaped CSVs (write_biosnap_csvs, Decagon's sizes) through
    preprocess_decagon, the --et-band selection (et_list_by_nnz_band) and
    load_decagon_raw (each drug-protein edge on its own drug and protein,
    biosnap_targets), cached_trigraph cold then warm (equal graphs), then
    the training CLI (tip_tpu_torch.train.__main__.main) with --et-band and
    --report on the default dense strips, every launch counter at 0 just
    before and read just after (B1 once a step, nothing else), the report's
    rows against result["per_relation"]; then dice_similarity_matrix on the
    card at 645 x DICE_BITS folded counts, bit-equal to the CPU's.  Prints
    the data line; returns the launch counts."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from tip_tpu_torch import kernels
    from tip_tpu_torch.analysis.report import DECAGON_BEST_ORG_ID
    from tip_tpu_torch.data.cache import cached_trigraph
    from tip_tpu_torch.data.decagon import (
        et_list_by_nnz_band, load_decagon_raw,
    )
    from tip_tpu_torch.data.drug_structure import dice_similarity_matrix
    from tip_tpu_torch.data.preprocess import preprocess_decagon
    from tip_tpu_torch.train import __main__ as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        raw_dir, data_dir, cache_dir = (os.path.join(tmp, d) for d in
                                        ("raw", "data", "cache"))
        t0 = time.time()
        names = write_biosnap_csvs(raw_dir, 0, **DECAGON_CSV)
        csv_sec = time.time() - t0
        t0 = time.time()
        info = preprocess_decagon(raw_dir, data_dir)
        preprocess_sec = time.time() - t0
        check(info == (DECAGON_CSV["n_drug"], DECAGON_CSV["n_prot"],
                       DECAGON_CSV["n_se"], DECAGON_CSV["n_mono_se"]),
              f"preprocess_decagon counted {info}")
        # the side effects' names, which BioSNAP's combo file carries and
        # the shipped data keeps beside the id maps
        with open(os.path.join(data_dir, "index_map",
                               "combo-name-map.pkl"), "wb") as f:
            pickle.dump(names, f)
        t0 = time.time()
        et_ids = et_list_by_nnz_band(*DATA_BAND, data_dir)
        raw = load_decagon_raw(data_dir, et_list=et_ids)
        load_sec = time.time() - t0
        check(len(et_ids) > 0 and np.array_equal(raw.et_ids, et_ids),
              f"band {DATA_BAND} selected {len(et_ids)} relations")
        check(raw.dp_shift == 0 and set(zip(*raw.dp_edge_index.tolist()))
              == biosnap_targets(raw_dir, data_dir),
              "the loaded drug-protein edges are not the targets' own")
        t0 = time.time()
        cold = cached_trigraph(raw, cache_dir=cache_dir)
        cold_sec = time.time() - t0
        t0 = time.time()
        warm = cached_trigraph(raw, cache_dir=cache_dir)
        warm_sec = time.time() - t0
        check(_graphs_equal(cold, warm), "the warm cache load differs from "
              "the cold build")
        report = os.path.join(tmp, "report.json")
        os.environ["TIP_CACHE_DIR"] = cache_dir  # the CLI loads it warm
        kernels.reset_launch_counts()
        result = train_cli.main([
            "--data-dir", data_dir, "--et-band", ",".join(map(str, DATA_BAND)),
            "--epochs", str(DATA_EPOCHS), "--report", report])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        del os.environ["TIP_CACHE_DIR"]
        check_result("tip dense", DATA_EPOCHS, len(et_ids), result, launches)
        with open(report) as f:
            rep = json.load(f)
        with open(os.path.join(data_dir, "index_map", "combo_map.pkl"),
                  "rb") as f:
            code_of = {v: k for k, v in pickle.load(f).items()}
        per = result["per_relation"]
        want = [{"et": int(t), "name": names[code_of[int(t)]],
                 **{k: round(float(per[k][i]), 4)
                    for k in ("auprc", "auroc", "ap")}}
                for i, t in enumerate(et_ids) if per["valid"][i]]
        check(rep["per_relation"] == want, "the report's rows differ from "
              "result['per_relation']")
        ranked = {code_of[int(t)] for t in et_ids} & set(DECAGON_BEST_ORG_ID)
        check({int(k) for k in rep["summary"]["decagon_best_ranks"]}
              == ranked, "the report ranks other side effects than Decagon's "
              "best in the band")

    counts = dice_counts(DECAGON_CSV["n_drug"])
    dice_ms = []
    for _ in range(3):  # the first call loads cdist's kernel
        t0 = time.time()
        sim = dice_similarity_matrix(counts, device=dev)
        dice_ms.append(1e3 * (time.time() - t0))
    t0 = time.time()
    sim_cpu = dice_similarity_matrix(counts, device="cpu")
    dice_cpu_ms = 1e3 * (time.time() - t0)
    check(sim.dtype == np.float32 and sim.shape == sim_cpu.shape
          and np.array_equal(sim.view(np.uint32), sim_cpu.view(np.uint32)),
          "Dice on the card differs from the CPU's")
    step_sec = sorted(h["sec"] for h in result["history"][1:])
    print("data: " + json.dumps({
        "csv_rows": {k: v for k, v in DECAGON_CSV.items() if k.startswith("n_")},
        "cut": None, "csv_sec": csv_sec, "preprocess_sec": preprocess_sec,
        "band": DATA_BAND, "n_et": len(et_ids), "load_sec": load_sec,
        "dd_train_edges": cold.dd_train.n_edges,
        "cache_cold_sec": cold_sec, "cache_warm_sec": warm_sec,
        "losses": [h["loss"] for h in result["history"]],
        "final": result["final"], "launches": launches,
        "step_ms_median": 1e3 * step_sec[len(step_sec) // 2],
        "step_ms_all": [1e3 * h["sec"] for h in result["history"]],
        "report_rows": len(rep["per_relation"]),
        "dice_shape": list(counts.shape), "dice_ms": dice_ms[-1],
        "dice_ms_all": dice_ms, "dice_cpu_ms": dice_cpu_ms, "card": card}))
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
    "ring_spmm": "tip sharded ring",
    "pp_aggregate": "tip dense",
    "rel_aggregate": "decagon dense",
    "dense_bce_dedicom": "decagon dense",
    "rgcn_contract": "tip dense",
    "rel_scaled": "compgcn dense",
}
PATH_CHECKS = {"tip dense": "decagon_dense", "tip pages": "decagon_dense",
               "compgcn dense": "decagon_dense",
               "decagon dense": "decagon_trigraph",
               "dr-nn dense": "decagon_dense", "tip chunked": "main",
               "tip-nn dense": "decagon_chunked",
               "decoder ab": "decagon_chunked",
               "tip sharded ring": "decagon_ring"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tip_tpu_torch import kernels, native
    from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
    from tip_tpu_torch.models.decagon import make_decagon_graph_arrays
    from tip_tpu_torch.ops.matmul import set_matmul_precision
    from tip_tpu_torch.scripts.decoder_ab import DECAGON_SHAPE
    from tip_tpu_torch.train.model import make_graph_arrays

    faulthandler.enable()  # a fault inside a kernel call still shows where
    t_all = time.time()
    phases, t_mark = {}, [t_all]

    def mark(name: str) -> None:  # host seconds of the phase just ended
        phases[name] = round(time.time() - t_mark[0], 1)
        t_mark[0] = time.time()
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
    t0 = time.time()
    print(f"built the native packing library {native.load()._name} in "
          f"{time.time() - t0:.1f} s")
    mark("build")

    for kind, dense_dtype, negatives, pp_dense in (
            ("tip", "bfloat16", "auto", None), ("tip", None, "auto", None),
            ("dr-nn", "bfloat16", "auto", None), ("dr-nn", None, "auto", None),
            ("tip", "float32", "auto", False), ("dr-df", "float32", "auto", None),
            ("tip", "bfloat16", "sampled", None),
            ("tip-nn", "bfloat16", "auto", None), ("tip-nn", None, "auto", None),
            ("dr-nn", "float32", "auto", None)):
        print("small slice gpu vs cpu:", json.dumps(check_small_slice_cpu_vs_gpu(
            dev, dense_dtype, kind, negatives, pp_dense)))
    mark("small slices")
    run_data_path(dev, card)
    mark("data")

    data, build_sec = run_native_packing(synthetic_trigraph(**DECAGON_SHAPE),
                                         card)
    mark("native packing")
    print("graph:", json.dumps(graph_summary(data, build_sec)))
    checks = {}
    for layout, kw in (("dense", {"dense_dtype": "bfloat16"}),
                       ("chunked", {"dense_dtype": None, "pp_dense": False})):
        graph, gs = make_graph_arrays(data, dev, **kw)
        checks[f"decagon_{layout}"] = run_checks(layout, "decagon", graph, gs,
                                                 data, dev)
        del graph
        torch.cuda.empty_cache()
    # Decagon's uint8 pages: B14 and B13
    graph, gs = make_decagon_graph_arrays(data, dev)
    checks["decagon_trigraph"] = run_checks("decagon", "decagon", graph, gs,
                                            data, dev)
    del graph
    torch.cuda.empty_cache()
    mark("decagon graph, kernel checks")

    launches = {"tip dense": run_path("tip dense", data, dev, TRAIN_STEPS,
                                      "bfloat16")}
    print("resume:", json.dumps(run_resume(data, dev)))
    print("profile hook:", json.dumps(run_profile_hook(data, dev)))
    mark("tip dense, resume, profile hook")
    run_backend_ab("tip dense", data, dev, "bfloat16", card)
    mark("backend dense")
    # float32 matmuls pinned: train() and the runner take the float32 pages
    launches["tip pages"] = run_path("tip pages", data, dev, TRAIN_STEPS,
                                     "float32", matmul_precision="highest")
    # a count past 127: train() takes the bf16 pages
    t0 = time.time()
    heavy = build_trigraph(with_heavy_pair(synthetic_trigraph(**DECAGON_SHAPE)),
                           0.9, 1111)
    print("graph:", json.dumps(graph_summary(heavy, time.time() - t0)))
    launches["tip pages bf16"] = run_path("tip pages bf16", heavy, dev,
                                          OTHER_STEPS, "bfloat16",
                                          profiled=False)
    del heavy
    launches["tip strips sampled"] = run_path(
        "tip strips sampled", data, dev, OTHER_STEPS, "bfloat16",
        negatives="sampled", profiled=False)
    launches["tip pages sampled"] = run_path(
        "tip pages sampled", data, dev, OTHER_STEPS, "float32",
        negatives="sampled", matmul_precision="highest", profiled=False)
    launches["tip-nn dense"] = run_path("tip-nn dense", data, dev, TRAIN_STEPS,
                                        "bfloat16", decoder="nn")
    launches["dr-nn dense"] = run_variant("dr-nn", data, dev, VARIANT_STEPS,
                                          profiled=True)
    launches["dr-nn pages"] = run_variant("dr-nn", data, dev, OTHER_STEPS,
                                          matmul_precision="highest")
    for variant in ("dr-df", "pr-hmp-nn", "pp-gae"):
        run_variant(variant, data, dev, OTHER_STEPS)
    run_variant("dr-df", data, dev, OTHER_STEPS, matmul_precision="highest")
    launches["decagon dense"] = run_variant("decagon", data, dev,
                                            VARIANT_STEPS, profiled=True)
    launches["compgcn dense"] = run_variant("compgcn", data, dev,
                                            VARIANT_STEPS, profiled=True)
    mark("dense paths, variants")
    launches["decoder ab"] = run_decoder_ab(data, dev)
    mark("decoder ab")
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
    # B9 on a D-D graph skewed as the real one is, B5 on a P-P graph with a
    # hub row (checked and timed; no path trains on them)
    for tag, raw, name in (("skewed", skewed_dd_raw(), "nn_sddmm"),
                           ("hub", with_hub(pp_only_raw()), "gcn_spmm")):
        t0 = time.time()
        g = build_trigraph(raw, 0.9, 1111)
        print("graph:", json.dumps(graph_summary(g, time.time() - t0)))
        graph, gs = make_graph_arrays(g, dev, dense_dtype=None, pp_dense=False)
        rep = KERNEL_CHECKS[name][1](graph, gs, g, dev)
        print(f"kernel {name} [{tag}]:", json.dumps(rep))
        del graph, g
        torch.cuda.empty_cache()
    mark("chunked graphs, kernel checks")
    launches["tip chunked"] = run_path("tip chunked", big, dev, TRAIN_STEPS,
                                       None)
    mark("tip chunked")
    run_backend_ab("tip chunked", big, dev, None, card)
    mark("backend chunked")
    launches["tip-nn chunked"] = run_path("tip-nn chunked", big, dev,
                                          TRAIN_STEPS, None, decoder="nn")
    launches["dr-nn chunked"] = run_variant("dr-nn", big, dev, VARIANT_STEPS,
                                            profiled=True)
    launches["dr-df chunked"] = run_variant("dr-df", big, dev, OTHER_STEPS)
    print("remat:", json.dumps(run_remat(big, dev)))
    del big
    torch.cuda.empty_cache()
    mark("chunked paths, remat")

    # sharded: B11 across SHARDED_RANKS processes on this card, then the
    # sharded paths, on the Decagon-shaped graph
    checks["decagon_ring"] = {"ring_spmm": check_ring_spmm(data, dev)}
    print("kernel ring_spmm [decagon]:",
          json.dumps(checks["decagon_ring"]["ring_spmm"]))
    mark("ring check")
    launches.update(run_sharded(data, dev))
    mark("sharded")
    del data

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
    print("phases:", json.dumps(phases))
    print(f"total {time.time() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
