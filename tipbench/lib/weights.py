"""The weights a run starts from, made on the device from ``--seed``.

A driver states its parameter tree as (path, shape, kind, scale) entries,
with the distributions of the program's initializers
(tip_tpu_torch/nn/initializers.py at the commit that added this
benchmark): "normal" N(0, scale^2), "glorot" U(-a, a) with a = sqrt(6 /
(fan_in + fan_out)), "zeros".  All normal leaves come from one draw and
all uniform leaves from another, on the device's own generator, so the
same seed gives the same weights on the same kind of device.  The program
and the reference get the same weights.
"""

from __future__ import annotations

import math

import torch


def make(spec, seed: int, device) -> dict:
    """{path: float32 tensor} of the entries of ``spec``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) & (2**63 - 1))
    sizes = {k: sum(math.prod(s) for _, s, kind, _ in spec if kind == k)
             for k in ("normal", "glorot")}
    normal = torch.randn(sizes["normal"], generator=gen, device=dev)
    uniform = torch.rand(sizes["glorot"], generator=gen, device=dev)
    out, used = {}, {"normal": 0, "glorot": 0}
    for path, shape, kind, scale in spec:
        size = math.prod(shape)
        if kind == "zeros":
            out[path] = torch.zeros(shape, device=dev)
            continue
        src = normal if kind == "normal" else uniform
        x = src[used[kind]:used[kind] + size].reshape(shape)
        used[kind] += size
        if kind == "normal":
            out[path] = x * scale
        else:
            a = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            out[path] = x * (2 * a) - a
    return out


def tree(flat: dict) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}: the nested dicts the program takes."""
    root: dict = {}
    for path, x in flat.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return root
