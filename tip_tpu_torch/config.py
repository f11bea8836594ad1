"""Typed configuration for the port's models and training.

A copy of tip_tpu/config.py (the port imports nothing of the JAX package):
the same frozen dataclasses, defaults and CLI flag helpers, so one set of
flags describes a run in either package.  Options whose code paths this
package does not implement yet are rejected where they are used
(train/loop.py, train/model.py), never silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for the TIP tri-graph model.

    Defaults reproduce TIP-cat (reference: tip.py:14).  For TIP-add
    (reference: tip.py:17) use ``ModelConfig.tip_add()``: the protein->drug
    dimension must equal the drug embedding dimension because the two are
    summed (reference: src/layers.py:499-500).
    """

    mode: str = "cat"  # 'cat' | 'add'
    prot_drug_dim: int = 16  # dim of the protein->drug hierarchy conv output
    n_embed: int = 48  # dim of the learned drug embedding
    n_hid1: int = 32  # output dim of R-GCN layer 1
    n_hid2: int = 16  # output dim of R-GCN layer 2 (= final drug embedding)
    num_base: int = 32  # number of bases in the basis decomposition
    pp_hid1: int = 32  # P-P GCN layer-1 width (reference: src/layers.py:382)
    pp_hid2: int = 16  # P-P GCN layer-2 width
    decoder: str = "distmult"  # 'distmult' | 'nn'
    nn_decoder_l1_dim: int = 16  # reference: src/layers.py:601
    # Input precision ('float32' | 'bfloat16') of the chunked path's kernels
    # (B4, B5, B8); the dense strips and bf16 pages take bf16-rounded
    # operands either way, the float32 pages float32 ones, as the JAX
    # package's do.
    kernel_dtype: str = "float32"
    # Negative-sampling estimator: 'sampled' draws one negative per positive
    # slot (the reference's estimator, src/neg_sampling.py);
    # 'poisson' uses the Poissonized dense estimator fused into the dense
    # BCE kernel (ops/pallas_dense_bce.py) — same expected loss and per-cell
    # marginals, total draw count Binomial instead of exact.  'auto' =
    # poisson whenever the dense fast path is active, sampled otherwise.
    negatives: str = "auto"

    def __post_init__(self) -> None:
        if self.mode not in ("cat", "add"):
            raise ValueError(f"mode must be 'cat' or 'add', got {self.mode!r}")
        if self.mode == "add" and self.n_embed != self.prot_drug_dim:
            raise ValueError(
                "TIP-add requires n_embed == prot_drug_dim "
                f"(got {self.n_embed} != {self.prot_drug_dim})"
            )
        if self.decoder not in ("distmult", "nn"):
            raise ValueError(f"unknown decoder {self.decoder!r}")
        if self.negatives not in ("auto", "poisson", "sampled"):
            raise ValueError(f"unknown negatives mode {self.negatives!r}")

    @property
    def rgcn_in_dim(self) -> int:
        return self.n_embed + self.prot_drug_dim if self.mode == "cat" else self.n_embed

    @staticmethod
    def tip_cat(**kw) -> "ModelConfig":
        return ModelConfig(mode="cat", prot_drug_dim=16, n_embed=48, **kw)

    @staticmethod
    def tip_add(**kw) -> "ModelConfig":
        return ModelConfig(mode="add", prot_drug_dim=64, n_embed=64, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization / loop hyperparameters (reference: tip.py:7,14,21)."""

    lr: float = 0.01
    epochs: int = 100
    seed: int = 1111
    split_rate: float = 0.9  # train fraction of each relation's edges
    remat: bool = False  # recompute the encoder in backward
    log_every: int = 1
    eval_every: int = 0  # 0 = eval only at the end
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 = only final
    # Fetch the loss to the host every N epochs (1 = per step, the
    # reference's behaviour).  Each fetch waits for the device; losses of
    # the epochs in between are still recorded (they stay on the device and
    # are fetched together at the next sync point).
    sync_every: int = 1


_FLAG_TYPES = {"int": int, "float": float, "str": str, "bool": bool}


def _field_type(f: dataclasses.Field):
    # Under `from __future__ import annotations` f.type is a string.
    name = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "str")
    if name.startswith("Optional[") and name.endswith("]"):
        name = name[len("Optional["):-1]
    return _FLAG_TYPES.get(name, str)


def add_config_flags(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("model")
    g.add_argument("--mode", choices=["cat", "add"], default="cat")
    g.add_argument("--decoder", choices=["distmult", "nn"], default="distmult")
    for f in dataclasses.fields(ModelConfig):
        if f.name in ("mode", "decoder"):
            continue
        g.add_argument(f"--{f.name.replace('_', '-')}", type=_field_type(f), default=None)
    t = parser.add_argument_group("train")
    for f in dataclasses.fields(TrainConfig):
        if _field_type(f) is bool:
            t.add_argument(f"--{f.name.replace('_', '-')}", action="store_true", default=None)
        else:
            t.add_argument(f"--{f.name.replace('_', '-')}", type=_field_type(f), default=None)


def configs_from_args(args: argparse.Namespace):
    """Build (ModelConfig, TrainConfig) from parsed flags; None flags keep defaults."""
    mode = args.mode or "cat"
    base = ModelConfig.tip_cat() if mode == "cat" else ModelConfig.tip_add()
    m_over = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(ModelConfig)
        if getattr(args, f.name, None) is not None
    }
    t_over = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(TrainConfig)
        if getattr(args, f.name, None) is not None
    }
    return dataclasses.replace(base, **m_over), TrainConfig(**t_over)
