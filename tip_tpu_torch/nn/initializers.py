"""Parameter initializers with the JAX package's distributions
(tip_tpu/nn/initializers.py), drawn from a ``torch.Generator``.

Draws happen on the generator's device (the CPU for a default generator)
and are moved to ``device``, so one seed gives the same parameters on
either device.  They are not the JAX package's numbers: parity tests hand
both packages the same parameters through convert.py.
"""

from __future__ import annotations

import math

import torch


def normal(gen: torch.Generator, shape, std: float = 1.0, device=None):
    out = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return (std * out).to(device)


def glorot_uniform(gen: torch.Generator, shape, device=None):
    """PyG glorot: U(-a, a) with a = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = shape[-2], shape[-1]
    a = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (out * (2 * a) - a).to(device)


def rgcn_std(in_channels: int, after_relu: bool) -> float:
    """std for R-GCN basis/root weights."""
    return 2.0 / in_channels if after_relu else 1.0 / math.sqrt(in_channels)


def hierarchy_std(in_dim: int, after_relu: bool) -> float:
    """std for the bipartite protein->drug conv weight."""
    return 1.0 / math.sqrt(in_dim) if after_relu else 2.0 / math.sqrt(in_dim)
