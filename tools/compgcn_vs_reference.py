"""CompGCN's z, loss and first gradients on the card against the plain
reference, element by element, at the cell's timed sizes.

    python3 tools/compgcn_vs_reference.py [--seeds 2147700001,2147700013]

For each seed: the weights and the first training step of the cell
``compgcn.decagon_strips`` through the program (tipbench's set-up and step),
against ``tipbench/reference/models/compgcn.py`` (plain torch, float32,
TF32 off, the D-D messages in blocks of 32 relations) from the same weights
and draws.  Gaps: z and each gradient block as max |x - x_ref| / max
|x_ref| over the block, the loss relative.  The gradient blocks split the
leaves by the paths that feed them: ``decoder/rel`` rows [0, R) (the
decoder and the in-direction D-D messages), [R, K) (P-P, D-P in), [K,
K + R) (the out-direction D-D messages: kernel B16's backward alone), [K +
R, 2K); ``encoder/ent`` drug rows and protein rows.

Tolerances, each with its reason (PERF.md §6 gives the readings):

* z 1e-6 and the loss 1e-6: float32 sums of exact products in other
  orders, through BN and tanh, and the same cells and draws;
* 2e-5 for every block fed by float32 paths: the backward's float32 sums in
  other orders;
* 5e-3 for the blocks fed through the P-P messages (rel [R, K), [K + R,
  2K), the protein rows of ent): kernel B12's backward rounds the operand's
  gradient to bf16 and so does the reference, and a rounding can go the
  other way for float32 round-off of its input, one bf16 unit (2^-8).

Two planted variants must fail them: the program with B16's backward on one
bf16 term of G (not three), and the reference with TF32 operands in the
loss's products.  Prints one JSON line a reading; exits 1 if a sound
reading fails or a planted one passes.  Needs the card; a diagnostic, run
by hand: nothing tests it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WORKLOAD = "compgcn.decagon_strips"
TOL_Z = TOL_LOSS = 1e-6
TOL_F32 = 2e-5
TOL_PP = 5e-3


def main(argv=None) -> int:
    import torch

    from tip_tpu_torch.convert import leaves
    from tip_tpu_torch.ops import rel_scaled as b16
    from tip_tpu_torch.train.loop import step_seed
    from tipbench import run
    from tipbench.lib import weights
    from tipbench.lib.step import TrainStep
    from tipbench.reference.follow import draw_test_negatives, follow
    from tipbench.reference.model import leaves as named_leaves
    from tipbench.reference.model import model_of

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="2147700001,2147700013,2147700029")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    os.environ["TIP_CACHE_DIR"] = run.CACHE_DIR
    files = run.cell_files(run.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                           WORKLOAD)
    config, traffic = files["config"], files["traffic"]
    dev = torch.device("cuda")
    ctx = run.prepare(files, dev)
    mod = model_of(config["model"])
    r, nd = ctx["gs"].n_et, ctx["gs"].n_drug
    k = r + 2
    blocks = {"decoder/rel": {"rel[:R]": slice(0, r), "rel[R:K]": slice(r, k),
                              "rel[K:K+R]": slice(k, k + r),
                              "rel[K+R:]": slice(k + r, 2 * k)},
              "encoder/ent": {"ent[:n_drug]": slice(0, nd),
                              "ent[n_drug:]": slice(nd, None)}}
    through_pp = {"rel[R:K]", "rel[K+R:]", "ent[n_drug:]"}

    def gap(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float((a - b).abs().max() / b.abs().max())

    def program(seed):
        w0 = weights.make(mod.param_spec(config, ctx["gs"]), seed, dev)
        params = weights.tree({n: v.clone() for n, v in w0.items()})
        ts = TrainStep(ctx["model"], ctx["graph"], ctx["test"], params,
                       config["lr"], seed, step_seed, leaves)
        zs = []
        with run.shadowed(ts.model, "encode", run.recording(zs, True)):
            loss = ts(0)
        grads = {p: x.grad.detach().clone() for p, x in named_leaves(params)}
        return w0, {"z": zs[0], "losses": [loss], "grad": grads}

    def reference(w0, seed):
        neg = draw_test_negatives(ctx["raw"], traffic, seed)
        return follow(config["model"], ctx["raw"], traffic, config["lr"], w0,
                      seed, 1, neg, dev)

    def reading(tag, seed, got, ref, sound):
        g = {}
        for p in ref["grad"]:
            for name, sl in blocks.get(p, {p: slice(None)}).items():
                g[name] = gap(got["grad"][p][sl], ref["grad"][p][sl])
        out = {"z": gap(got["z"], ref["z"]),
               "loss": abs(got["losses"][0] - ref["losses"][0])
               / abs(ref["losses"][0]), "grads": g}
        ok = (out["z"] <= TOL_Z and out["loss"] <= TOL_LOSS
              and all(v <= (TOL_PP if n in through_pp else TOL_F32)
                      for n, v in g.items()))
        print(json.dumps({"reading": tag, "seed": seed, "within": ok, **out}),
              flush=True)
        return ok == sound

    good = True
    orig = b16.rel_scaled_grad_cuda
    dense_logits = mod.dense_logits
    for seed in (int(s) for s in args.seeds.split(",") if s):
        w0, got = program(seed)
        ref = reference(w0, seed)
        good &= reading("sound", seed, got, ref, True)
        b16.rel_scaled_grad_cuda = lambda s, ub, z, g: orig(
            s, ub, z, g.to(torch.bfloat16).float())
        try:
            good &= reading("b16_backward_one_bf16_term", seed,
                            program(seed)[1], ref, False)
        finally:
            b16.rel_scaled_grad_cuda = orig
        mod.dense_logits = lambda z, dec, t0, t1, prec: dense_logits(
            z, dec, t0, t1, dataclasses.replace(prec, control="tf32"))
        try:
            good &= reading("reference_tf32_loss", seed,
                            reference(w0, seed), ref, False)
        finally:
            mod.dense_logits = dense_logits
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
