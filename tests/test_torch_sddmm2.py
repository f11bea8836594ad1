"""Kernel B8 of the port (tip_tpu_torch/ops/sddmm2.py, the DistMult SDDMM)
against the JAX package's distmult_logits_padded2 on the CPU.

The CPU runs the plain PyTorch version; chip_smoke.py holds the CUDA kernel
against it on the card.  The JAX kernel runs in interpret mode, as
tests/test_sddmm2.py runs it.  Logits agree to 1e-5 and the gradients dz,
dw to 1e-4 (float32 sums in another order: per chunk, then per relation,
in the JAX kernel); pad-slot logits are exactly 0 in both.  The gradient
checks feed both the same cotangent, so the bf16 rounding of each
scattered contribution sees the same float32 inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import synthetic_trigraph
from tip_tpu.data.packing import pad_typed_edges, sort_typed_edges, split_typed_edges
from tip_tpu.ops.pallas_sddmm2 import distmult_logits_padded2 as j_dm
from tip_tpu_torch import kernels
from tip_tpu_torch.ops import sddmm2 as port


def _setup(n_drug, seed=2):
    raw = synthetic_trigraph(n_drug=n_drug, n_prot=10, n_et=5,
                             pairs_per_et=70, seed=seed)
    edges, _ = split_typed_edges(raw.dd_pair_list, p=0.95, seed=0)
    padded = pad_typed_edges(sort_typed_edges(edges), n_drug, chunk=32)
    nc = padded.chunk_type.shape[0]
    bufs = (padded.src.reshape(nc, 32), padded.dst.reshape(nc, 32),
            padded.chunk_type)
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n_drug, 16)).astype(np.float32)
    w = rng.normal(size=(edges.n_et, 16)).astype(np.float32)
    valid = padded.valid.reshape(nc, 32).astype(np.float32)
    return bufs, z, w, valid


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("n_drug", [40, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_grads_match_jax(n_drug, dtype):
    bufs, z, w, valid = _setup(n_drug)
    jb = list(map(jnp.asarray, bufs))
    cot = np.random.default_rng(1).normal(size=valid.shape).astype(np.float32)

    def jloss(z, w):
        lg = j_dm(z, w, *jb, n_drug, jnp.dtype(dtype))
        return jnp.sum(lg * cot), lg

    with pltpu.force_tpu_interpret_mode():
        (_, jlg), (jgz, jgw) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(w))
    zt = torch.tensor(z, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    lg = port.distmult_logits_padded2(zt, wt, *_t(bufs), n_drug, dtype)
    (lg * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jlg), atol=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgz), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), atol=1e-4,
                               rtol=1e-4)
    # pad slots: exactly zero in both
    pad = valid == 0
    assert pad.any()
    assert np.all(lg.detach().numpy()[pad] == 0.0)
    assert np.all(np.asarray(jlg)[pad] == 0.0)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The hand-written backward (the CUDA kernel's arithmetic) equals
    autograd through the plain forward in float32."""
    bufs, z, w, _ = _setup(300, seed=3)
    g = np.random.default_rng(4).normal(size=bufs[0].shape).astype(np.float32)
    zt, wt = torch.tensor(z, requires_grad=True), torch.tensor(w, requires_grad=True)
    (port.distmult_logits_plain(zt, wt, *_t(bufs)) * torch.from_numpy(g)).sum().backward()
    dz, dw = port.distmult_bwd_plain(torch.from_numpy(z), torch.from_numpy(w),
                                     *_t(bufs), torch.from_numpy(g))
    np.testing.assert_allclose(dz.numpy(), zt.grad.numpy(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), wt.grad.numpy(), atol=1e-4, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_cuda_wrapper_refuses_them():
    bufs, z, w, _ = _setup(40)
    kernels.reset_launch_counts()
    zt = torch.tensor(z, requires_grad=True)
    port.distmult_logits_padded2(zt, torch.from_numpy(w), *_t(bufs), 40).sum().backward()
    assert kernels.LAUNCHES[port.KERNEL] == 0
    with pytest.raises(ValueError, match="CUDA"):
        port.distmult_logits_cuda(torch.from_numpy(z), torch.from_numpy(w),
                                  *_t(bufs))
    with pytest.raises(ValueError, match="rows"):
        port.distmult_logits_padded2(zt, torch.from_numpy(w), *_t(bufs), 41)


@pytest.mark.parametrize("bad", ["width", "nodes", "dtype"])
def test_cuda_argument_checks(bad):
    """What the CUDA wrapper refuses before it hands pointers to the kernel
    (the checks need no card)."""
    bufs, z, w, _ = _setup(40)
    args = [torch.from_numpy(z), torch.from_numpy(w), *_t(bufs)]
    port._check_cuda_args(*args, grads=True, table="shared")  # valid: passes
    if bad == "width":  # the kernel is built for d = 16 only
        args[0], args[1] = args[0][:, :12].contiguous(), args[1][:, :12].contiguous()
    elif bad == "nodes":  # the shared-memory z and dz tables no longer fit
        args[0] = torch.zeros(1800, 16)
    else:
        args[2] = args[2].long()
    with pytest.raises(ValueError):
        port._check_cuda_args(*args, grads=True, table="shared")


@pytest.mark.parametrize("grads,n_max", [(False, 3417), (True, 1693)])
def test_shared_table_boundary(grads, n_max):
    """The largest graph whose tables the kernel keeps in shared memory;
    one node more takes the global-memory tables, which have no limit."""
    assert port.shared_table_fits(n_max, grads)
    assert not port.shared_table_fits(n_max + 1, grads)
    bufs, _, w, _ = _setup(40)
    args = [torch.from_numpy(w), *_t(bufs)]
    for n, shared in ((n_max, True), (n_max + 1, False), (40_000, False)):
        z = torch.zeros(n, 16)
        assert port._check_cuda_args(z, *args, grads=grads) == (n, shared)
        assert port._check_cuda_args(z, *args, grads=grads,
                                     table="global") == (n, False)
