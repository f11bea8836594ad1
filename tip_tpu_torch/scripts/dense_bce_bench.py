"""The dense loss kernels B1 (csrc/dense_bce_sym.cu), B2 (csrc/dense_bce.cu)
and B3 (csrc/dense_bce_nn.cu) at Decagon shape, and the steps of the paths
that launch B2 and B3.

    python3 tip_tpu_torch/scripts/dense_bce_bench.py [--root DIR]

Runs chip_smoke.py's checks of the three kernels (every tolerance, the
oracle modes, descent, value-only equal to fused, determinism, the other
shapes) with their timings: chip_smoke.py's primed CUDA events, the
device's time over 20 calls, fused and value-only, B2 on the float32 and
bf16 pages, B3 on the uint8, bf16 and float32 pages.  Then the training
steps of "tip pages" (TIP-cat on the float32 pages, B2), "dr-nn dense"
(B3 on uint8 pages) and "dr-nn pages" (B3 on the float32 pages): the
median of 5 synchronised steps after 2 warm-up, and chip_smoke.py's
profile (device busy ms a step, idle share).  Prints one JSON line.
``--root DIR`` times the ``tip_tpu_torch`` package under DIR (another
commit unpacked there) in place of this checkout's (bench_root.py); run
the script as a file, as above.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

KEYS = ("ms", "value_only_ms", "bound_ms", "bound_by", "loss_rel_err",
        "grad_err_frac", "dw_max_abs_err", "dz_max_abs_err")


def _brief(rep: dict) -> dict:
    return {k: rep[k] for k in KEYS if k in rep}


def step_ms(model, graph, steps: int = 5, warmup: int = 2) -> list:
    """Host-clock times of ``steps`` training steps (loss, backward, Adam),
    each ending in a device sync, after ``warmup``."""
    import torch

    from tip_tpu_torch import convert
    from tip_tpu_torch.train.loop import step_seed

    params = model.init(torch.Generator().manual_seed(0))
    for p in convert.leaves(params):
        p.requires_grad_(True)
    opt = torch.optim.Adam(convert.leaves(params), lr=0.01)
    out = []
    for k in range(warmup + steps):
        t0 = time.time()
        opt.zero_grad(set_to_none=True)
        model.loss(params, graph, step_seed(0, k)).backward()
        opt.step()
        torch.cuda.synchronize()
        out.append(1e3 * (time.time() - t0))
    return out[warmup:]


def path_steps(smoke, data, dev) -> dict:
    """Step medians and profiles of the paths that launch B2 and B3."""
    import torch

    from tip_tpu_torch.config import ModelConfig
    from tip_tpu_torch.models.runner import build_variant
    from tip_tpu_torch.train.model import TIP, make_graph_arrays

    out = {}
    graph, gs = make_graph_arrays(data, dev, dense_dtype="float32")
    models = {"tip pages": (TIP.for_data(ModelConfig.tip_cat(), data, gs, dev),
                            graph)}
    for name, prec in (("dr-nn dense", "default"), ("dr-nn pages", "highest")):
        model, g, _ = build_variant("dr-nn", data, dev, matmul_precision=prec)
        models[name] = (model, g)
    for name, (model, g) in models.items():
        times = step_ms(model, g)
        out[name] = {"step_ms": times,
                     "step_ms_median": sorted(times)[len(times) // 2],
                     **smoke.profile_steps(model, g)}
        del out[name]["top"]
    del models, graph
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    import bench_root  # beside this file, first on sys.path

    parser = argparse.ArgumentParser(
        description="Kernels B1, B2, B3 and the steps that launch B2 and B3")
    bench_root.add_option(parser)
    args = parser.parse_args(argv)
    root = bench_root.import_package(args.root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dense_bce_bench needs a GPU")
    from tip_tpu_torch import kernels
    from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
    from tip_tpu_torch.ops.matmul import set_matmul_precision
    from tip_tpu_torch.scripts.decoder_ab import DECAGON_SHAPE
    from tip_tpu_torch.train.model import make_graph_arrays

    smoke = bench_root.chip_smoke()
    dev = torch.device("cuda", 0)
    set_matmul_precision()
    kernels.build(["dense_bce_sym", "dense_bce", "dense_bce_nn"])
    data = build_trigraph(synthetic_trigraph(**DECAGON_SHAPE), 0.9, 1111)
    graph, gs = make_graph_arrays(data, dev, dense_dtype="bfloat16")
    out = {"root": str(root), "card": smoke.card_line()}
    b1 = smoke.check_dense_bce_sym(graph, gs, data, dev)
    b2 = smoke.check_dense_bce(graph, gs, data, dev)
    b3 = smoke.check_dense_bce_nn(graph, gs, data, dev)
    del graph
    torch.cuda.empty_cache()
    out["b1"] = _brief(b1)
    out["b2"] = {dt: _brief(b2[dt]) for dt in ("float32", "bfloat16")}
    out["b3"] = {"uint8": _brief(b3), **{dt: _brief(b3[dt]) for dt in (
        "bfloat16", "float32")}}
    out["steps"] = path_steps(smoke, data, dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
