"""Kernel B9 of the port (tip_tpu_torch/ops/sddmm2.py, the NN-decoder SDDMM)
against the JAX package's nn_logits_padded2 on the CPU.

The CPU runs the plain PyTorch version; chip_smoke.py holds the CUDA kernel
against it on the card.  The JAX kernel runs in interpret mode, as
tests/test_sddmm2_nn.py runs it.  Pad slots score their pad src in both
packages (the caller masks them), so logits are compared masked by valid,
to 1e-5.  Gradients take one shared cotangent, pad slots included, and
agree to 1e-4 (float32 sums in another order: per chunk then per relation
in the JAX kernel, per (relation, endpoint) in the port).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import synthetic_trigraph
from tip_tpu.data.packing import pad_typed_edges, sort_typed_edges, split_typed_edges
from tip_tpu.ops.pallas_sddmm2 import nn_logits_padded2 as j_nn
from tip_tpu_torch import kernels
from tip_tpu_torch.ops import sddmm2 as port
from tip_tpu_torch.ops.matmul import compute_round


def _setup(n_drug, seed=5):
    raw = synthetic_trigraph(n_drug=n_drug, n_prot=10, n_et=4,
                             pairs_per_et=60, seed=seed)
    edges, _ = split_typed_edges(raw.dd_pair_list, p=0.95, seed=0)
    padded = pad_typed_edges(sort_typed_edges(edges), n_drug, chunk=32)
    nc = padded.chunk_type.shape[0]
    bufs = (padded.src.reshape(nc, 32), padded.dst.reshape(nc, 32),
            padded.chunk_type)
    rng = np.random.default_rng(seed)
    h1, h2 = np.maximum(rng.normal(size=(2, n_drug, 16)), 0).astype(np.float32)
    w1, w2 = rng.normal(size=(2, edges.n_et, 16)).astype(np.float32)
    valid = padded.valid.reshape(nc, 32).astype(np.float32)
    return bufs, (h1, h2, w1, w2), valid


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("n_drug", [40, 150])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_grads_match_jax(n_drug, dtype):
    bufs, params, valid = _setup(n_drug)
    jb = list(map(jnp.asarray, bufs))
    cot = np.random.default_rng(1).normal(size=valid.shape).astype(np.float32)

    def jloss(*p):
        lg = j_nn(*p, *jb, n_drug, jnp.dtype(dtype))
        return jnp.sum(lg * cot), lg

    with pltpu.force_tpu_interpret_mode():
        (_, jlg), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, params))
    ts = [torch.tensor(p, requires_grad=True) for p in params]
    lg = port.nn_logits_padded2(*ts, *_t(bufs), n_drug, dtype)
    (lg * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(lg.detach().numpy() * valid,
                               np.asarray(jlg) * valid, atol=1e-5)
    for t, want in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    # pad slots: the dst term is exactly 0, so a pad logit is its src score
    pad = valid == 0
    assert pad.any()
    h1, _, w1, _ = (compute_round(torch.from_numpy(p), dtype).numpy()
                    if i < 2 else p for i, p in enumerate(params))
    src, _, ct = bufs
    want_pad = (h1[src] * w1[ct][:, None, :]).sum(-1)
    np.testing.assert_allclose(lg.detach().numpy()[pad], want_pad[pad],
                               atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_backward_matches_autograd_of_per_slot_formula(bf16):
    """The hand-written backward (the CUDA kernel's factoring through the
    per-(relation, endpoint) sums of g) equals autograd through the
    per-slot formula; with bf16 each scattered dh contribution is rounded,
    which autograd does not do, so dh is held to bf16 rounding there."""
    bufs, params, _ = _setup(150, seed=3)
    g = np.random.default_rng(4).normal(size=bufs[0].shape).astype(np.float32)
    ts = [torch.tensor(p, requires_grad=True) for p in params]
    src, dst, ct = (torch.from_numpy(b).long() for b in bufs)
    h2p = torch.nn.functional.pad(ts[1], (0, 0, 0, 1))
    w1t, w2t = ts[2][ct][:, None, :], ts[3][ct][:, None, :]
    per_slot = (ts[0][src] * w1t).sum(-1) + (h2p[dst] * w2t).sum(-1)
    (per_slot * torch.from_numpy(g)).sum().backward()
    got = port.nn_bwd_plain(*_t(params), *_t(bufs), torch.from_numpy(g), bf16)
    want = [t.grad for t in ts]
    for i, (a, b) in enumerate(zip(got, want)):
        if bf16 and i < 2:
            # each contribution rounded to bf16: 2^-9 relative a term
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=4e-3 * float(b.abs().max()))
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                       rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_cuda_wrapper_refuses_them():
    bufs, params, _ = _setup(40)
    kernels.reset_launch_counts()
    ts = [torch.tensor(p, requires_grad=True) for p in params]
    port.nn_logits_padded2(*ts, *_t(bufs), 40).sum().backward()
    assert kernels.LAUNCHES[port.NN_KERNEL] == 0
    with pytest.raises(ValueError, match="CUDA"):
        port.nn_logits_cuda(*_t(params), *_t(bufs))
    with pytest.raises(ValueError, match="CUDA"):
        port.nn_bwd_cuda(*_t(params), *_t(bufs), torch.zeros(bufs[0].shape))
    with pytest.raises(ValueError, match="rows"):
        port.nn_logits_padded2(*ts, *_t(bufs), 41)


@pytest.mark.parametrize("bad", ["width", "nodes", "dtype", "h2", "w2"])
def test_cuda_argument_checks(bad):
    """What the CUDA wrapper refuses before it hands pointers to the kernel
    (the checks need no card)."""
    bufs, params, _ = _setup(40)
    args = [*_t(params), *_t(bufs)]
    port._check_nn_args(*args, table="shared")  # valid: passes
    if bad == "width":  # the kernel is built for l1 = 16
        args[:4] = [a[:, :12].contiguous() for a in args[:4]]
    elif bad == "nodes":  # the shared-memory vectors no longer fit
        args[0] = args[1] = torch.zeros(29056, 16)
    elif bad == "dtype":
        args[4] = args[4].long()
    elif bad == "h2":
        args[1] = args[1][:-1].contiguous()
    else:
        args[3] = args[3][:-1].contiguous()
    with pytest.raises(ValueError):
        port._check_nn_args(*args, table="shared")


def test_shared_vector_boundary():
    """The largest graph whose per-relation score / gradient-sum vectors
    (2 (n + 1) floats) the kernel keeps in shared memory; one node more
    takes the global-memory vectors, which have no limit."""
    n_max = 29055
    assert port.nn_shared_fits(n_max) and not port.nn_shared_fits(n_max + 1)
    bufs, params, _ = _setup(40)
    w = _t(params[2:])
    for n, shared in ((n_max, True), (n_max + 1, False), (100_000, False)):
        h = torch.zeros(n, 16)
        assert port._check_nn_args(h, h, *w, *_t(bufs)) == (n, shared)
        assert port._check_nn_args(h, h, *w, *_t(bufs),
                                   table="global") == (n, False)
