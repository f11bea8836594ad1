"""Parameter transfer between the JAX package's pytrees and the port.

The port keeps the JAX package's parameter layout — nested dicts with the
same keys and shapes (``[in, out]`` weights, ``att [R, B]``,
``basis [B, in, out]``) — so a JAX pytree, given as nested dicts of numpy
arrays, maps leaf for leaf onto float32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device=None, requires_grad: bool = False):
    """Nested dicts of numpy arrays -> nested dicts of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, requires_grad)
                for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree), device=device)
    return t.requires_grad_(requires_grad) if t.is_floating_point() else t


def params_to_numpy(tree):
    """Nested dicts of tensors -> nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def leaves(tree):
    """The tensors of a nested dict, in key order (an optimizer's params)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]
