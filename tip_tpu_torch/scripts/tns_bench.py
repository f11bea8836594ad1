"""Kernel B4 (the typed neighbour sum, csrc/typed_neighbor_sum.cu) on the
Decagon-shaped chunk buffers, whole and on each rank's block of them as
the sharded path splits them: parallel/sharded.py's ``shard_graph`` pads
the chunk axis to a multiple of the ranks and ``place_graph`` gives rank r
its block; every rank still writes all relations' P^T rows, most of them
zeros on its block.

    python3 tip_tpu_torch/scripts/tns_bench.py [--root DIR] [--ranks 4]

Checks the forward and backward at both R-GCN widths (d = 64, 32) against
the plain versions (1e-5 and 1e-4 of the largest magnitude), times each
with chip_smoke.py's primed CUDA events (the device's time over 20 calls)
and prints one JSON line.  ``--root DIR`` imports the ``tip_tpu_torch``
package under DIR in place of this checkout's (another commit unpacked
there), so that two versions can be timed on one card in one session; it
calls the wrappers with their positional arguments only.  Run it as a
file, as above, for ``--root`` to take effect.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json

SEED = 21  # x and dP^T


def rank_blocks(graph: dict, gs, ranks: int) -> list:
    """[(src2d, dst2d, chunk_type)] of each rank's block of a chunked
    graph's D-D buffers, as the sharded path places them, on the graph's
    device."""
    from tip_tpu_torch.parallel.sharded import shard_graph

    keys = ("dd_src2d", "dd_dst2d", "dd_chunk_type", "dd_valid")
    dev = graph["dd_src2d"].device
    sgraph, sgs = shard_graph({k: graph[k].cpu() for k in keys}, gs, ranks)
    m = sgs.dd_n_chunks // ranks
    return [tuple(sgraph[k][r * m:(r + 1) * m].to(dev) for k in keys[:3])
            for r in range(ranks)]



def main(argv=None) -> dict:
    import bench_root  # beside this file, first on sys.path

    parser = argparse.ArgumentParser(
        description="Kernel B4 on the whole chunk buffers and a rank's block")
    bench_root.add_option(parser)
    parser.add_argument("--ranks", type=int, default=4)
    args = parser.parse_args(argv)
    root = bench_root.import_package(args.root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tns_bench needs a GPU")
    from tip_tpu_torch import kernels
    from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
    from tip_tpu_torch.ops import typed_segment as ts
    from tip_tpu_torch.scripts.decoder_ab import DECAGON_SHAPE
    from tip_tpu_torch.train.model import make_graph_arrays

    smoke = bench_root.chip_smoke()
    dev = torch.device("cuda", 0)
    kernels.build(["typed_neighbor_sum"])
    data = build_trigraph(synthetic_trigraph(**DECAGON_SHAPE), 0.9, 1111)
    graph, gs = make_graph_arrays(data, dev, dense_dtype=None, pp_dense=False)
    n, n_et = gs.n_drug, gs.n_et
    bufs = {"whole": (graph["dd_src2d"], graph["dd_dst2d"],
                      graph["dd_chunk_type"])}
    bufs.update({f"rank{r}": b for r, b in
                 enumerate(rank_blocks(graph, gs, args.ranks))})
    gen = torch.Generator().manual_seed(SEED)
    out = {"root": str(root), "card": smoke.card_line(),
           "chunks": {k: b[0].shape[0] for k, b in bufs.items()}}
    for d in (64, 32):
        x = torch.randn(n, d, generator=gen).to(dev)
        dpt = torch.randn(n_et, d, n, generator=gen).to(dev)
        for name, b in bufs.items():
            ef, mf = smoke.max_err(ts.typed_neighbor_sum_fwd_cuda(x, *b, n_et),
                                   ts.typed_neighbor_sum_fwd_plain(x, *b, n_et))
            smoke.check(ef <= 1e-5 * mf, f"B4 {name} d={d} forward err {ef}")
            eb, mb = smoke.max_err(ts.typed_neighbor_sum_bwd_cuda(dpt, *b),
                                   ts.typed_neighbor_sum_bwd_plain(dpt, *b))
            smoke.check(eb <= 1e-4 * mb, f"B4 {name} d={d} backward err {eb}")
            out[f"{name}_d{d}"] = {
                "fwd_ms": smoke.cuda_ms(lambda: ts.typed_neighbor_sum_fwd_cuda(
                    x, *b, n_et), reps=20, primed=True),
                "bwd_ms": smoke.cuda_ms(lambda: ts.typed_neighbor_sum_bwd_cuda(
                    dpt, *b), reps=20, primed=True),
                "fwd_err": ef, "bwd_err": eb}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
