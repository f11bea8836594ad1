"""Kernels B8 (the DistMult SDDMM, csrc/distmult_sddmm.cu) and B11 (the ring
SpMM step, csrc/ring_spmm.cu), and the TIP-cat chunked step that launches
B8.

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
primed CUDA events (the device's time over 20 calls, B11 50).  Then the
TIP-cat chunked step (1,536 x 800): the median of 5 synchronised steps
after 2 warm-up, and chip_smoke.py's profile (device busy ms a step, idle
share).  Prints one JSON line.  ``--root DIR`` times the
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


def chunked_step(smoke, data, dev) -> dict:
    """TIP-cat on the chunked layout: step times and the profile."""
    import dense_bce_bench  # beside this file, first on sys.path
    import torch

    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.train.model import TIP, make_graph_arrays

    graph, gs = make_graph_arrays(data, dev, dense_dtype=None)
    model = TIP.for_data(ModelConfig.tip_cat(), data, gs, dev)
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
        description="Kernels B8 and B11, and the TIP-cat chunked step")
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
    kernels.build(["distmult_sddmm", "ring_spmm", "typed_neighbor_sum",
                   "gcn_spmm", "typed_neg_sampler"])
    out = {"root": str(root), "card": smoke.card_line()}
    decagon = build_trigraph(synthetic_trigraph(**DECAGON_SHAPE), 0.9, 1111)
    big = build_trigraph(synthetic_trigraph(**smoke.BEYOND_DENSE), 0.9, 1111)
    for tag, data in (("main", big), ("decagon", decagon)):
        graph, gs = make_graph_arrays(data, dev, dense_dtype=None,
                                      pp_dense=False)
        rep = smoke.check_distmult_sddmm(graph, gs, data, dev)
        out[f"b8_{tag}"] = {k: rep[k] for k in B8_KEYS}
        del graph
        torch.cuda.empty_cache()
    out["b11"] = ring_step_times(smoke, decagon, dev)
    out["tip_chunked"] = chunked_step(smoke, big, dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
