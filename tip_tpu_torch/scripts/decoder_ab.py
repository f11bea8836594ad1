"""A/B of the chunked decoder routes at Decagon shape: the v1 SDDMMs
against the v2 ones and a plain gather.

    python -m tip_tpu_torch.scripts.decoder_ab [float32|bfloat16]
        [--synthetic] [--cpu] [--data-dir DIR] [--out PATH]

Port of scripts/decoder_ab.py.  The graph is packed with
``make_graph_arrays(data, dense_dtype=kd, sampled=True)``, so the chunk
buffers ship beside the pages; z comes from TIP-cat's encoder at published
widths, parameters from a seed.  Measured, forward and forward + backward
of the masked softplus sum over the chunk buffers' slots, on the pages'
own shapes:

  * DistMult: ``v1`` (kernel B6, ops/typed_segment.py), ``v2`` (kernel B8,
    ops/sddmm2.py) and ``gather``, the plain ``(z[src] z[dst] w[et]).sum``
    (the JAX script's xla_gather);
  * the NN decoder, which the JAX script lacks: ``v1`` (kernel B7), ``v2``
    (kernel B9) and ``gather`` over the hiddens of a seeded NN decoder;
  * each route's relative error of the masked softplus sum against v1;
  * the negative sampler (kernel B10 and its borrow pass), and the
    DistMult positives' BCE over the full pages.

Times are CUDA events over ``reps`` calls after ``warmup`` (each the larger
of the host's and the device's time), on the GPU unless ``--cpu`` is
given; a CPU run times the plain versions by the host clock and says so.
The command line takes 10 timed calls after 2 on the GPU, 1 after 1 on the
CPU.  The JSON goes to stdout and, with ``--out``, to that file.
``--synthetic`` builds the Decagon-shaped graph chip_smoke.py trains on;
otherwise the Decagon files are read from ``--data-dir`` (or
``$TIP_DATA_DIR``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# Decagon shape: 645 drugs, 19,081 proteins, 1,097 relations; ~4,600 drawn
# pairs a relation give Decagon's ~8.3 M directed D-D train edges after
# de-duplication and the 90/10 split
DECAGON_SHAPE = dict(n_drug=645, n_prot=19081, n_et=1097, pairs_per_et=4600,
                     n_pp_pairs=715612, n_dp=18596, seed=0)
SPLIT = dict(split_rate=0.9, seed=1111)


def launches_per_route(warmup: int, reps: int) -> int:
    """Kernel launches of one SDDMM route in :func:`decoder_ab`: a forward
    for the agreement check, ``warmup + reps`` timed forwards and as many
    timed forward + backward pairs."""
    return 1 + 3 * (warmup + reps)


def _timer(dev, warmup: int, reps: int):
    """ms per call of fn(): CUDA events on a GPU, the host clock on the
    CPU, after ``warmup`` calls."""

    def time_ms(fn) -> float:
        for _ in range(warmup):
            fn()
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / reps

    return time_ms


def decoder_ab(data, kd: str = "float32", device=None, warmup: int = 2,
               reps: int = 10) -> dict:
    """The A/B on a packed tri-graph ``data`` with kernel dtype ``kd``;
    returns the result dict (see the module docstring)."""
    from tip_tpu_torch import kernels
    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.nn.decoders import (
        distmult_dense_pos_bce_sum,
        nn_decoder_init,
        nn_hiddens,
    )
    from tip_tpu_torch.ops.dense_bce_sym import softplus
    from tip_tpu_torch.ops.sddmm2 import (
        distmult_logits_padded2,
        nn_logits_padded2,
    )
    from tip_tpu_torch.ops.typed_segment import (
        distmult_logits_padded,
        nn_logits_padded,
    )
    from tip_tpu_torch.sampling import typed_negative_sampling_chunked
    from tip_tpu_torch.train.model import TIP, make_graph_arrays, resolve_device

    dev = resolve_device(device)
    graph, gs = make_graph_arrays(data, dev, dense_dtype=kd, sampled=True)
    model = TIP.for_data(ModelConfig.tip_cat(kernel_dtype=kd,
                                             negatives="sampled"),
                         data, gs, dev)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    nn_dec = nn_decoder_init(gen, model.cfg.n_hid2, gs.n_et,
                             model.cfg.nn_decoder_l1_dim, device=dev)
    with torch.no_grad():
        z0 = model.encode(params, graph)
        h10, h20 = nn_hiddens(nn_dec, z0)
    src2d, dst2d = graph["dd_src2d"], graph["dd_dst2d"]
    ct, valid = graph["dd_chunk_type"], graph["dd_valid"]
    n, chunk = gs.n_drug, gs.dd_chunk
    src = src2d.reshape(-1).long()
    dst = dst2d.reshape(-1).clamp(max=n - 1).long()  # pads: masked by valid
    et = ct.long().repeat_interleave(chunk)

    dm_routes = {
        "v1": lambda z, w: distmult_logits_padded(z, w, src2d, dst2d, ct, kd),
        "v2": lambda z, w: distmult_logits_padded2(z, w, src2d, dst2d, ct, n,
                                                   kd),
        "gather": lambda z, w: (z[src] * z[dst] * w[et]).sum(-1),
    }
    nn_routes = {
        "v1": lambda h1, h2, w1, w2: nn_logits_padded(
            h1, h2, w1, w2, src2d, dst2d, ct, kd),
        "v2": lambda h1, h2, w1, w2: nn_logits_padded2(
            h1, h2, w1, w2, src2d, dst2d, ct, n, kd),
        "gather": lambda h1, h2, w1, w2: (
            (h1[src] * w1[et]).sum(-1) + (h2[dst] * w2[et]).sum(-1)),
    }
    inputs = {
        "distmult": (dm_routes, [z0, params["decoder"]["weight"].detach()]),
        "nn": (nn_routes, [h10, h20, nn_dec["w1_l2"], nn_dec["w2_l2"]]),
    }
    time_ms = _timer(dev, warmup, reps)
    kernels.reset_launch_counts()
    out = {"dtype": kd, "device": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else "cpu"),
           "timer": "cuda events" if dev.type == "cuda" else "host clock",
           "warmup": warmup, "reps": reps, "n_drug": n, "n_et": gs.n_et,
           "n_chunks": gs.dd_n_chunks, "chunk": chunk,
           "slots": src2d.numel(), "valid_slots": int(valid.sum())}

    for decoder, (routes, args) in inputs.items():
        leaves = [a.detach().requires_grad_(True) for a in args]

        def masked(fn):
            return torch.sum(softplus(fn(*leaves).reshape(-1)) * valid)

        rows, ref = {}, None
        for name, fn in routes.items():
            with torch.no_grad():
                val = float(masked(fn))
            ref = val if ref is None else ref
            rows[name] = {
                "fwd_ms": time_ms(lambda fn=fn: masked(fn).detach()),
                "fwd_bwd_ms": time_ms(lambda fn=fn: torch.autograd.grad(
                    masked(fn), leaves)),
                "value": val,
                "rel_err_vs_v1": abs(val - ref) / abs(ref),
            }
        out[decoder] = rows

    bitmap = graph["dd_bitmap"]
    out["sampler"] = {"ms": time_ms(lambda: typed_negative_sampling_chunked(
        12345, ct, bitmap, n, gs.n_et, chunk))}
    z = z0.detach().requires_grad_(True)
    w = params["decoder"]["weight"].detach().requires_grad_(True)
    pages = graph["dd_adj_t"]
    out["dense_pos_bce"] = {
        "fwd_ms": time_ms(lambda: distmult_dense_pos_bce_sum(
            w, z, pages, kd).detach()),
        "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
            distmult_dense_pos_bce_sum(w, z, pages, kd), (w, z))),
    }
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="A/B of the chunked decoder routes (PyTorch/CUDA)")
    parser.add_argument("dtype", nargs="?", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--synthetic", action="store_true",
                        help="the Decagon-shaped random graph")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain versions)")
    parser.add_argument("--data-dir", default=None, help="Decagon data dir")
    parser.add_argument("--out", default=None, help="write the JSON here")
    args = parser.parse_args(argv)

    from tip_tpu_torch.data import (
        build_trigraph, load_decagon_raw, synthetic_trigraph,
    )
    from tip_tpu_torch.ops.matmul import set_matmul_precision
    from tip_tpu_torch.train.model import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    set_matmul_precision()
    if args.synthetic:
        raw = synthetic_trigraph(**DECAGON_SHAPE)
    else:
        kw = {"data_dir": args.data_dir} if args.data_dir else {}
        raw = load_decagon_raw(**kw)
    data = build_trigraph(raw, **SPLIT)
    result = decoder_ab(data, args.dtype, device, warmup=1 if args.cpu else 2,
                        reps=1 if args.cpu else 10)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
