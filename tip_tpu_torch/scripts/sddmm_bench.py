"""Kernels B8 (the DistMult SDDMM, csrc/distmult_sddmm.cu), B9 (the
NN-decoder SDDMM, csrc/nn_sddmm.cu), B5 (the windowed P-P SpMM,
csrc/gcn_spmm.cu), B11 (the ring SpMM step, csrc/ring_spmm.cu), B10 (the
typed negative sampler, csrc/typed_neg_sampler.cu), B7 (the v1
NN-decoder SDDMM, csrc/nn_sddmm_v1.cu) and B6 (the v1 DistMult SDDMM,
csrc/distmult_sddmm_v1.cu), and the TIP-cat and TIP-NN chunked steps
that launch them.

    python3 tip_tpu_torch/scripts/sddmm_bench.py [--root DIR]

B8: chip_smoke.py's check (forward and backward against the plain
versions, with and without the bf16 rounding, the forward's z table
where the wrapper puts it and forced to global memory; pad logits 0)
with its timings, the forward in both table modes, at 1,536 drugs x 800
relations (the chunked path's graph) and at Decagon shape.  B11: one
ring step of rank 0's block 1 at Decagon shape with 4 ranks
(parallel/ring.py:build_ring_pp), on a loopback ring
(ops/ring.py:RingComm.loopback), checked against the plain segment sum
and timed four ways at d = 32 and 16: the SpMM blocks alone (a ring of
one), with the shard's copy, with the neighbour barrier (the fences, the
block counter and the last block's wait, which passes at once on the
loopback ring) and the whole step.  Kernel times are chip_smoke.py's
primed CUDA events (the device's time over 20 calls, B5 and B11 50).
B9: checked against the plain versions (logits, and the gradients in
float32 and with the bf16 rounding) at 1,536 x 800, at Decagon shape and
on chip_smoke.py's skewed D-D graph (one relation holds about a quarter
of the slots); timed forward, float32 backward and bf16 backward, each
also launch by launch (torch.profiler's device time per CUDA kernel and
memset of one call); a digest of the float32 logits (bit-equality across
versions) and whether two float32 backwards are bit-identical.  B5: the
same at d = 32 and 16 on the Decagon-shape P-P buffers and on
chip_smoke.py's hub graph (one protein with 5,000 neighbours), with
torch.sparse.mm on the CSR matrix beside it.  B10 (``b10_<tag>``, 1,536 x
800 and Decagon shape): the call a training step makes
(sampling/negative.py:typed_negative_sampling_chunked, the negatives'
src and dst), checked bit for bit against the plain route (plain
sampler, resolve_borrow, % and //) on the card, timed whole (unprimed
events: the first version's route of a dozen launches does not let a
spin hold the stream while it enqueues) and launch by launch, with a
digest of (src, dst).  B7 (``b7_<tag>``, the same graphs): checked
against the plain versions (float32 and bf16), forward, float32 and bf16
backward timed whole and launch by launch, the forward's and backward's
global modes whole, and the digests of its logits and of B9's.  B6
(``b6_<tag>``, the same graphs): the same, with B8's logits' digest and
its dw's (deterministic); ``b8_<tag>`` also carries digests of B8's
logits and dw (float32 and bf16), bit-equality across versions.  Then
the TIP-cat and TIP-NN chunked steps (1,536 x 800): the median of 5
synchronised steps after 2 warm-up, and chip_smoke.py's profile (device
busy ms a step, idle share).  Prints one JSON line.  ``--root DIR`` times the
``tip_tpu_torch`` package under DIR (another commit unpacked there) in
place of this checkout's (bench_root.py); run the script as a file, as
above.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json

B8_KEYS = ("ms", "bwd_ms", "global_ms", "bound_ms", "bwd_bound_ms",
           "fwd_shared", "max_abs_err")
# (copy the shard, barrier): the four ways a ring step is timed
RING_WAYS = {"spmm_ms": (False, False), "spmm_copy_ms": (True, False),
             "spmm_barrier_ms": (False, True), "step_ms": (True, True)}


def ring_step_times(smoke, data, dev, ranks: int = 4, step: int = 1) -> dict:
    """B11 on rank 0's ring block ``step``: checked, and timed each way of
    RING_WAYS, at both GCN widths."""
    import numpy as np
    import torch

    from tip_tpu_torch.ops import ring as ops_ring
    from tip_tpu_torch.ops.segment import segment_sum_sorted
    from tip_tpu_torch.parallel.ring import build_ring_pp

    ring = build_ring_pp(data.pp_norm_index, data.pp_norm_weight,
                         data.dp_edge_index, data.n_prot, ranks)
    n_local = ring.n_local
    blk = [torch.from_numpy(np.ascontiguousarray(a[0, step])).to(dev)
           for a in (ring.src_local, ring.dst_local, ring.weight)]
    out = {"n_local": n_local, "block_edges": int((blk[2] != 0).sum())}
    gen = torch.Generator().manual_seed(32)
    for d in (32, 16):
        h = torch.randn(n_local, d, generator=gen).to(dev)
        plain = segment_sum_sorted(h[blk[0].long()] * blk[2][:, None], blk[1],
                                   n_local)
        comm = ops_ring.RingComm.loopback(n_local, d, dev)
        rep = {}
        try:
            acc = torch.zeros(n_local, d, device=dev)
            ops_ring.ring_step_cuda(h, acc, *blk, comm, 0, copy=True)
            e, m = smoke.max_err(acc, plain)
            smoke.check(e <= 1e-5 * m, f"B11 d={d} step err {e} of max {m}")
            rep["max_abs_err"] = e
            for key, (copy, barrier) in RING_WAYS.items():
                rep[key] = smoke.cuda_ms(lambda: ops_ring.ring_step_cuda(
                    h, acc, *blk, comm, 0, copy=copy, barrier=barrier),
                    reps=50, primed=True)
        finally:
            comm.close()
        out[f"d{d}"] = rep
    return out


def digest(t) -> str:
    """sha256 of a tensor's bytes (bit-equality across versions)."""
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def nn_sddmm_times(smoke, graph, gs, dev) -> dict:
    """B9 on one packed graph: checked, timed whole and launch by launch."""
    import torch

    from tip_tpu_torch.ops import sddmm2
    from tip_tpu_torch.ops.matmul import bf16_round

    bufs = (graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"])
    d, n, n_et = sddmm2.D, gs.n_drug, gs.n_et
    gen = torch.Generator().manual_seed(24)
    h1, h2 = (torch.relu(torch.randn(n, d, generator=gen)).to(dev)
              for _ in range(2))
    w1, w2 = ((0.3 * torch.randn(n_et, d, generator=gen)).to(dev)
              for _ in range(2))
    g = torch.randn(bufs[0].shape, generator=gen).to(dev)
    valid = graph["dd_valid"].reshape(bufs[0].shape) > 0
    out = {"slots": bufs[0].numel(), "chunks": bufs[0].shape[0]}
    for bf16 in (False, True):
        args = (*(bf16_round(h) if bf16 else h for h in (h1, h2)), w1, w2,
                *bufs)
        lk = sddmm2.nn_logits_cuda(*args)
        el, ml = smoke.max_err(lk[valid], sddmm2.nn_logits_plain(*args)[valid])
        smoke.check(el <= 1e-5 * ml, f"B9 logits err {el} of max {ml}")
        gk = sddmm2.nn_bwd_cuda(*args, g, bf16)
        errs = smoke._frac_errs(gk, sddmm2.nn_bwd_plain(*args, g, bf16))
        smoke.check(max(errs) <= 1e-4, f"B9 bf16={bf16} grads err {errs}")
        out["bf16" if bf16 else "float32"] = {"logit_max_abs_err": el,
                                              "grad_err_frac": errs}
    args = (h1, h2, w1, w2, *bufs)
    out["logits_digest"] = digest(sddmm2.nn_logits_cuda(*args))
    first = sddmm2.nn_bwd_cuda(*args, g)
    out["bwd_deterministic"] = all(
        torch.equal(a, b) for a, b in zip(first, sddmm2.nn_bwd_cuda(*args, g)))
    out["bwd_digest"] = digest(torch.cat([t.reshape(-1) for t in first]))
    calls = {"fwd": lambda: sddmm2.nn_logits_cuda(*args),
             "bwd": lambda: sddmm2.nn_bwd_cuda(*args, g),
             "bwd_bf16": lambda: sddmm2.nn_bwd_cuda(*args, g, True)}
    for key, fn in calls.items():
        out[f"{key}_ms"] = smoke.cuda_ms(fn, reps=20, primed=True)
        out[f"{key}_kernels"] = smoke.kernel_breakdown(fn)
    return out


def sampler_times(smoke, graph, gs, dev) -> dict:
    """B10 as a training step calls it (sampling/negative.py:
    typed_negative_sampling_chunked, the negatives' src and dst): checked
    bit for bit against the plain route (plain sampler, resolve_borrow,
    then % and //) on the card, timed whole and launch by launch, with a
    digest of (src, dst) for bit-equality across versions."""
    import torch

    from tip_tpu_torch.ops import sampler
    from tip_tpu_torch.sampling import typed_negative_sampling_chunked

    ct, bitmap = graph["dd_chunk_type"], graph["dd_bitmap"]
    n, n_et, chunk = gs.n_drug, gs.n_et, gs.dd_chunk
    seed = 12345
    src, dst = typed_negative_sampling_chunked(seed, ct, bitmap, n, n_et, chunk)
    pair = sampler.resolve_borrow(sampler.typed_negative_sampling_plain(
        seed, ct, bitmap, n, chunk))
    smoke.check(torch.equal(src, pair % n) and torch.equal(dst, pair // n),
                "B10 chunked negatives differ from the plain route")
    fn = lambda: typed_negative_sampling_chunked(  # noqa: E731
        seed, ct, bitmap, n, n_et, chunk)
    launches = smoke.kernel_breakdown(fn)
    # unprimed (the first version's route does not let a spin hold the
    # stream while it enqueues): the larger of host and device time
    return {"slots": src.numel(), "digest": digest(torch.stack([src, dst])),
            "ms": smoke.cuda_ms(fn, reps=50), "kernels": launches,
            "device_ms": sum(launches.values())}


def nn_v1_times(smoke, graph, gs, dev) -> dict:
    """B7 on one packed graph: checked against the plain versions (float32
    and bf16), forward, float32 and bf16 backward timed whole and launch by
    launch, both table modes; digests of its float32 logits and of B9's
    (bit-equality across versions, and with B9)."""
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
    out = {"slots": bufs[0].numel()}
    for bf16 in (False, True):
        args = (*(bf16_round(h) if bf16 else h for h in (h1, h2)), w1, w2,
                *bufs)
        el, ml = smoke.max_err(ts.nn_v1_fwd_cuda(*args),
                               ts.nn_v1_fwd_plain(*args))
        smoke.check(el <= 1e-5 * ml, f"B7 logits err {el} of max {ml}")
        errs = smoke._frac_errs(ts.nn_v1_bwd_cuda(*args, g, bf16),
                                ts.nn_v1_bwd_plain(*args, g, bf16))
        smoke.check(max(errs) <= 1e-4, f"B7 bf16={bf16} grads err {errs}")
        out["bf16" if bf16 else "float32"] = {"logit_max_abs_err": el,
                                              "grad_err_frac": errs}
    args = (h1, h2, w1, w2, *bufs)
    lk = ts.nn_v1_fwd_cuda(*args)
    out["logits_digest"] = digest(lk)
    out["b9_logits_digest"] = digest(sddmm2.nn_logits_cuda(*args))
    out["logits_equal_b9"] = torch.equal(lk, sddmm2.nn_logits_cuda(*args))
    calls = {"fwd": lambda: ts.nn_v1_fwd_cuda(*args),
             "bwd": lambda: ts.nn_v1_bwd_cuda(*args, g),
             "bwd_bf16": lambda: ts.nn_v1_bwd_cuda(*args, g, True)}
    for key, fn in calls.items():
        out[f"{key}_ms"] = smoke.cuda_ms(fn, reps=20, primed=True)
        out[f"{key}_kernels"] = smoke.kernel_breakdown(fn)
    out["fwd_global_ms"] = smoke.cuda_ms(lambda: ts.nn_v1_fwd_cuda(
        *args, table="global"), reps=20, primed=True)
    out["bwd_global_ms"] = smoke.cuda_ms(lambda: ts.nn_v1_bwd_cuda(
        *args, g, table="global"), reps=20, primed=True)
    return out


def dm_v1_times(smoke, graph, gs, dev) -> dict:
    """B6 on one packed graph: checked against the plain versions (float32
    and bf16), forward, float32 and bf16 backward timed whole and launch by
    launch, the forward's and backward's global modes whole (the backward
    has one mode since its redesign: "global" runs it), and the digests of
    its logits and of B8's."""
    import torch

    from tip_tpu_torch.ops import sddmm2
    from tip_tpu_torch.ops import typed_segment as ts
    from tip_tpu_torch.ops.matmul import bf16_round

    bufs = (graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"])
    d, n, n_et = ts.D, gs.n_drug, gs.n_et
    gen = torch.Generator().manual_seed(27)
    z = (0.5 * torch.randn(n, d, generator=gen)).to(dev)
    w = (0.3 * torch.randn(n_et, d, generator=gen)).to(dev)
    g = torch.randn(bufs[0].shape, generator=gen).to(dev)
    out = {"slots": bufs[0].numel()}
    for bf16 in (False, True):
        args = (bf16_round(z) if bf16 else z, w, *bufs)
        el, ml = smoke.max_err(ts.distmult_v1_fwd_cuda(*args),
                               ts.distmult_v1_fwd_plain(*args))
        smoke.check(el <= 1e-5 * ml, f"B6 logits err {el} of max {ml}")
        errs = smoke._frac_errs(ts.distmult_v1_bwd_cuda(*args, g, bf16),
                                ts.distmult_v1_bwd_plain(*args, g, bf16))
        smoke.check(max(errs) <= 1e-4, f"B6 bf16={bf16} grads err {errs}")
        out["bf16" if bf16 else "float32"] = {"logit_max_abs_err": el,
                                              "grad_err_frac": errs}
    args = (z, w, *bufs)
    lk = ts.distmult_v1_fwd_cuda(*args)
    out["logits_digest"] = digest(lk)
    out["b8_logits_digest"] = digest(sddmm2.distmult_logits_cuda(*args))
    dz, dw = ts.distmult_v1_bwd_cuda(*args, g)
    out["dw_digest"] = digest(dw)
    out["dw_deterministic"] = torch.equal(
        dw, ts.distmult_v1_bwd_cuda(*args, g)[1])
    calls = {"fwd": lambda: ts.distmult_v1_fwd_cuda(*args),
             "bwd": lambda: ts.distmult_v1_bwd_cuda(*args, g),
             "bwd_bf16": lambda: ts.distmult_v1_bwd_cuda(*args, g, True)}
    for key, fn in calls.items():
        out[f"{key}_ms"] = smoke.cuda_ms(fn, reps=20, primed=True)
        out[f"{key}_kernels"] = smoke.kernel_breakdown(fn)
    out["fwd_global_ms"] = smoke.cuda_ms(lambda: ts.distmult_v1_fwd_cuda(
        *args, table="global"), reps=20, primed=True)
    out["bwd_global_ms"] = smoke.cuda_ms(lambda: ts.distmult_v1_bwd_cuda(
        *args, g, table="global"), reps=20, primed=True)
    return out


def b8_digests(graph, gs, dev) -> dict:
    """Digests of B8's logits and of its backward's dw, float32 and bf16
    (B8's walk moved into a header shared with B6: its bits must not)."""
    import torch

    from tip_tpu_torch.ops import sddmm2
    from tip_tpu_torch.ops.matmul import bf16_round

    bufs = (graph["dd_src2d"], graph["dd_dst2d"], graph["dd_chunk_type"])
    gen = torch.Generator().manual_seed(28)
    z = (0.5 * torch.randn(gs.n_drug, sddmm2.D, generator=gen)).to(dev)
    w = (0.3 * torch.randn(gs.n_et, sddmm2.D, generator=gen)).to(dev)
    g = torch.randn(bufs[0].shape, generator=gen).to(dev)
    out = {"logits": digest(sddmm2.distmult_logits_cuda(z, w, *bufs))}
    for bf16 in (False, True):
        zr = bf16_round(z) if bf16 else z
        _, dw = sddmm2.distmult_bwd_cuda(zr, w, *bufs, g, bf16)
        out["dw_bf16" if bf16 else "dw"] = digest(dw)
    return out


def gcn_spmm_times(smoke, graph, gs, data, dev) -> dict:
    """B5 on one windowed P-P graph at d = 32 and 16: checked, timed whole
    and launch by launch, beside torch.sparse.mm on the CSR matrix."""
    import torch

    from tip_tpu_torch.ops import typed_segment as ts

    bufs = (graph["ppw_src"], graph["ppw_dstl"], graph["ppw_w"],
            graph["ppw_chunk_window"], gs.pp_n_windows, gs.pp_window, gs.n_prot)
    adj = smoke.pp_csr(data, gs.n_prot, dev)
    gen = torch.Generator().manual_seed(22)
    out = {"slots": bufs[0].numel(), "max_row_edges": int(torch.bincount(
        torch.from_numpy(data.pp_norm_index[1].astype("int64"))).max())}
    for d in (32, 16):
        x = torch.randn(gs.n_prot, d, generator=gen).to(dev)
        rep = {}
        for dt in ("float32", "bfloat16"):
            k = ts.gcn_spmm_cuda(x, *bufs, compute_dtype=dt)
            e, m = smoke.max_err(k, ts.gcn_spmm_plain(x, *bufs, compute_dtype=dt))
            smoke.check(e <= 1e-5 * m, f"B5 d={d} {dt} err {e} of max {m}")
            rep[f"{dt}_max_abs_err"] = e
        first = ts.gcn_spmm_cuda(x, *bufs)
        rep["deterministic"] = torch.equal(first, ts.gcn_spmm_cuda(x, *bufs))
        fn = lambda: ts.gcn_spmm_cuda(x, *bufs)  # noqa: E731
        rep["ms"] = smoke.cuda_ms(fn, reps=50, primed=True)
        rep["kernels"] = smoke.kernel_breakdown(fn)
        rep["library_ms"] = smoke.library_call(
            lambda: torch.sparse.mm(adj, x), first, 1e-5, "B5")
        out[f"d{d}"] = rep
    return out


def chunked_step(smoke, data, dev, decoder: str = "distmult") -> dict:
    """TIP-cat with ``decoder`` on the chunked layout: step times and the
    profile."""
    import dataclasses

    import dense_bce_bench  # beside this file, first on sys.path
    import torch

    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.train.model import TIP, make_graph_arrays

    cfg = dataclasses.replace(ModelConfig.tip_cat(), decoder=decoder)
    graph, gs = make_graph_arrays(data, dev, dense_dtype=None, decoder=decoder)
    model = TIP.for_data(cfg, data, gs, dev)
    times = dense_bce_bench.step_ms(model, graph)
    out = {"step_ms": times, "step_ms_median": sorted(times)[len(times) // 2],
           **smoke.profile_steps(model, graph)}
    out["top"] = out["top"][:8]
    del graph, model
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    import bench_root  # beside this file, first on sys.path

    parser = argparse.ArgumentParser(
        description="Kernels B8, B9, B5, B11, B10, B7 and B6, and the "
                    "TIP-cat and TIP-NN chunked steps")
    bench_root.add_option(parser)
    args = parser.parse_args(argv)
    root = bench_root.import_package(args.root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sddmm_bench needs a GPU")
    from tip_tpu_torch import kernels
    from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
    from tip_tpu_torch.ops.matmul import set_matmul_precision
    from tip_tpu_torch.scripts.decoder_ab import DECAGON_SHAPE
    from tip_tpu_torch.train.model import make_graph_arrays

    smoke = bench_root.chip_smoke()
    dev = torch.device("cuda", 0)
    set_matmul_precision()
    kernels.build(["distmult_sddmm", "nn_sddmm", "ring_spmm",
                   "typed_neighbor_sum", "gcn_spmm", "typed_neg_sampler",
                   "nn_sddmm_v1", "distmult_sddmm_v1"])
    out = {"root": str(root), "card": smoke.card_line()}
    decagon = build_trigraph(synthetic_trigraph(**DECAGON_SHAPE), 0.9, 1111)
    big = build_trigraph(synthetic_trigraph(**smoke.BEYOND_DENSE), 0.9, 1111)
    skewed = build_trigraph(smoke.skewed_dd_raw(), 0.9, 1111)
    hub = build_trigraph(smoke.with_hub(smoke.pp_only_raw()), 0.9, 1111)
    for tag, data in (("main", big), ("decagon", decagon), ("skewed", skewed),
                      ("hub", hub)):
        graph, gs = make_graph_arrays(data, dev, dense_dtype=None,
                                      pp_dense=False)
        if tag in ("main", "decagon"):
            rep = smoke.check_distmult_sddmm(graph, gs, data, dev)
            out[f"b8_{tag}"] = {k: rep[k] for k in B8_KEYS}
            out[f"b8_{tag}"]["digests"] = b8_digests(graph, gs, dev)
        if tag != "hub":
            out[f"b9_{tag}"] = nn_sddmm_times(smoke, graph, gs, dev)
        if tag in ("main", "decagon"):
            out[f"b10_{tag}"] = sampler_times(smoke, graph, gs, dev)
            out[f"b7_{tag}"] = nn_v1_times(smoke, graph, gs, dev)
            out[f"b6_{tag}"] = dm_v1_times(smoke, graph, gs, dev)
        if tag in ("decagon", "hub"):
            out[f"b5_{tag}"] = gcn_spmm_times(smoke, graph, gs, data, dev)
        del graph
        torch.cuda.empty_cache()
    out["b11"] = ring_step_times(smoke, decagon, dev)
    out["tip_chunked"] = chunked_step(smoke, big, dev)
    out["tip_nn_chunked"] = chunked_step(smoke, big, dev, decoder="nn")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
