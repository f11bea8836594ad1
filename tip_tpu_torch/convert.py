"""Parameter and optimizer-state transfer between the JAX package's
pytrees and the port.

The port keeps the JAX package's parameter layout — nested dicts with the
same keys and shapes (``[in, out]`` weights, ``att [R, B]``,
``basis [B, in, out]``) — so a JAX pytree, given as nested dicts of numpy
arrays, maps leaf for leaf onto float32 tensors, and optax.adam's state
onto ``torch.optim.Adam``'s (the checkpoints of train/loop.py).
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


# optax.adam's state leaf by leaf in ``torch.optim.Adam``'s terms: its
# count is Adam's step, its mu and nu the first and second moments
OPTAX_ADAM = {"count": "step", "mu": "exp_avg", "nu": "exp_avg_sq"}


def adam_to_optax_leaves(opt: torch.optim.Adam, params) -> list:
    """The state of ``opt`` over the leaves of ``params`` as the leaves of
    ``optax.adam(lr).init(params)`` in its flatten order, numpy arrays:
    count (int32, shape ()), then the mu leaves, then the nu leaves, each
    group in :func:`leaves` order.  A parameter without state yet (no step
    taken) counts 0 with zero moments, as optax's init."""
    ps = leaves(params)
    states = [opt.state.get(p, {}) for p in ps]
    steps = {int(s[OPTAX_ADAM["count"]]) if s else 0 for s in states}
    if len(steps) > 1:
        raise ValueError(f"the parameters have taken different numbers of "
                         f"Adam steps: {sorted(steps)}")
    count = np.asarray(steps.pop() if steps else 0, dtype=np.int32)
    moments = [[(s[k].detach().cpu().numpy() if s
                 else np.zeros(tuple(p.shape), np.float32)) for s, p in
                zip(states, ps)] for k in (OPTAX_ADAM["mu"], OPTAX_ADAM["nu"])]
    return [count, *moments[0], *moments[1]]


def adam_from_optax_leaves(opt: torch.optim.Adam, params, flat) -> None:
    """Load optax.adam's state leaves ``flat`` (count, the mu leaves, the
    nu leaves, as :func:`adam_to_optax_leaves` gives them) into ``opt``,
    whose parameters are the leaves of ``params``; raises ``ValueError``
    where a moment's shape differs from its parameter's."""
    ps = leaves(params)
    if len(flat) != 1 + 2 * len(ps):
        raise ValueError(f"{len(flat)} optimizer leaves for {len(ps)} "
                         f"parameters: want 1 + 2 x {len(ps)}")
    count = int(np.asarray(flat[0]))
    sd = opt.state_dict()
    index = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    state = {}
    for j, p in enumerate(ps):
        mu, nu = (np.asarray(flat[1 + k * len(ps) + j]) for k in (0, 1))
        for name, m in (("mu", mu), ("nu", nu)):
            if m.shape != tuple(p.shape):
                raise ValueError(f"optimizer leaf {name}[{j}] shape "
                                 f"{m.shape} != parameter {tuple(p.shape)}")
        state[index[id(p)]] = {
            OPTAX_ADAM["count"]: torch.tensor(float(count)),
            OPTAX_ADAM["mu"]: torch.from_numpy(mu.copy()),
            OPTAX_ADAM["nu"]: torch.from_numpy(nu.copy()),
        }
    opt.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
