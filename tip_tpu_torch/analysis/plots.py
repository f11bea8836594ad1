"""Training-curve plots from run-history JSONs.

A port of tip_tpu/analysis/plots.py (matplotlib, the non-interactive Agg
backend), the equivalent of the reference's matplotlib output: the
per-epoch AUPRC curve rendered at the end of each model script (reference:
model/ddm-nn.py:245-260) and the multi-run comparison plots of the
evaluation notebook (reference: analysis/evaluation.ipynb cells 14-18).
Consumes the ``{"history": [{"epoch", "loss", "auprc"?, ...}]}`` JSONs that
every run of either package writes with ``--out``.

CLI:
    python -m tip_tpu_torch.analysis.plots runs/tip_cat.json [more.json ...] \
        [--out curves.png] [--metric auprc]

One axes pair: loss (left y, per epoch) and the chosen ranking metric
(right y, at the eval epochs).  Multiple inputs overlay for comparison,
labeled by the run's ``variant`` field or file stem.
"""

from __future__ import annotations

import argparse
import json
import os


def load_history(path: str):
    with open(path) as f:
        d = json.load(f)
    hist = d.get("history", d if isinstance(d, list) else [])
    label = d.get("variant") or os.path.splitext(os.path.basename(path))[0]
    return label, hist


def plot_runs(paths, out: str, metric: str = "auprc") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax_loss = plt.subplots(figsize=(7.2, 4.2), dpi=150)
    ax_m = ax_loss.twinx()
    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    for i, path in enumerate(paths):
        label, hist = load_history(path)
        c = colors[i % len(colors)]
        epochs = [r["epoch"] for r in hist if "loss" in r]
        losses = [r["loss"] for r in hist if "loss" in r]
        if epochs:
            ax_loss.plot(epochs, losses, color=c, alpha=0.45, lw=1.2,
                         label=f"{label} loss")
        me = [(r["epoch"], r[metric]) for r in hist if metric in r]
        if me:
            ax_m.plot(*zip(*me), color=c, marker="o", ms=3.5, lw=1.6,
                      label=f"{label} {metric}")
    ax_loss.set_xlabel("epoch")
    ax_loss.set_ylabel("training loss")
    ax_m.set_ylabel(f"test {metric.upper()}")
    lines = ax_loss.get_lines() + ax_m.get_lines()
    ax_loss.legend(lines, [l.get_label() for l in lines], fontsize=7,
                   loc="center right", framealpha=0.9)
    ax_loss.set_title("training curves")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", help="run-history JSONs")
    ap.add_argument("--out", default="curves.png")
    ap.add_argument("--metric", default="auprc",
                    choices=["auprc", "auroc", "ap"])
    args = ap.parse_args(argv)
    out = plot_runs(args.runs, args.out, args.metric)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
