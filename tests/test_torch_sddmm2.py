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


@pytest.mark.parametrize("bad", ["width", "nodes", "dtype", "chunk"])
def test_cuda_argument_checks(bad):
    """What the CUDA wrapper refuses before it hands pointers to the kernel
    (the checks need no card)."""
    bufs, z, w, _ = _setup(40)
    args = [torch.from_numpy(z), torch.from_numpy(w), *_t(bufs)]
    # valid: both pass
    port._check_cuda_args(*args, grads=False, table="shared")
    port._check_cuda_args(*args, grads=True)
    grads, table = True, None
    if bad == "width":  # the kernel is built for d = 16 only
        args[0], args[1] = args[0][:, :12].contiguous(), args[1][:, :12].contiguous()
    elif bad == "nodes":  # the forward's shared-memory z table no longer fits
        args[0] = torch.zeros(3500, 16)
        grads, table = False, "shared"
    elif bad == "chunk":  # the backward's lane quads walk 16 slots
        args[2], args[3] = args[2][:, :24].contiguous(), args[3][:, :24].contiguous()
    else:
        args[2] = args[2].long()
    with pytest.raises(ValueError):
        port._check_cuda_args(*args, grads=grads, table=table)


def test_shared_table_boundary():
    """The largest graph whose z table the forward keeps in shared memory;
    one node more takes the global-memory mode, which has no limit.  The
    backward reads z through L1 at any size and has no shared table."""
    n_max = 3417
    assert port.shared_table_fits(n_max)
    assert not port.shared_table_fits(n_max + 1)
    bufs, _, w, _ = _setup(40)
    args = [torch.from_numpy(w), *_t(bufs)]
    for n, shared in ((n_max, True), (n_max + 1, False), (40_000, False)):
        z = torch.zeros(n, 16)
        assert port._check_cuda_args(z, *args, grads=False) == (n, shared)
        assert port._check_cuda_args(z, *args, grads=False,
                                     table="global") == (n, False)
        assert port._check_cuda_args(z, *args, grads=True) == (n, False)
        with pytest.raises(ValueError, match="no table"):
            port._check_cuda_args(z, *args, grads=True, table="shared")


def _bf16(x):
    """float32 -> bf16 (round to nearest even) -> float32, as
    __float2bfloat16_rn."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return r.view(np.float32)


def emulate_cuda_bwd(z, w, src2d, dst2d, ct, g, bf16: bool):
    """The arithmetic of csrc/distmult_sddmm.cu's backward in float32, in
    its order: lane quads of 8-quad warps of an 8-warp block walk 16-slot
    segments (segment k * 64 + warp * 8 + quad of a chunk), each keeping a
    run sum a side and reducing it into dz when its row changes; dwc a
    per-lane chain over the lane's slots, a shuffle tree over the quads,
    the warps in order; dw the chunks of a relation in order.  dz takes
    the reductions in this emulation's order (the kernel's is not fixed).
    Returns dz [n, d], dw, and the number of reductions a side."""
    f = np.float32
    n, d = z.shape
    zp = np.vstack([z, np.zeros((1, d), f)]).astype(f)
    nc, C = src2d.shape
    nseg = C // port.SEG
    per = 8 * port.BWD_WARPS  # segments a block takes at once
    dz = np.zeros((n + 1, d), f)
    dwc = np.zeros((nc, d), f)
    flushes = {"src": 0, "dst": 0}
    for c in range(nc):
        wt = w[ct[c]].astype(f)
        lanes = np.zeros((per, d), f)  # each quad's dw chain
        for s0 in range(0, nseg, per):
            for j in range(min(per, nseg - s0)):
                sl = slice((s0 + j) * port.SEG, (s0 + j + 1) * port.SEG)
                runs = {"src": [-1, None], "dst": [-1, None]}
                for s, dd, gv in zip(src2d[c, sl], dst2d[c, sl], g[c, sl]):
                    a, b, gv = zp[s], zp[dd], f(gv)
                    cs, cd = (gv * b) * wt, (gv * a) * wt
                    if bf16:
                        cs, cd = _bf16(cs), _bf16(cd)
                    lanes[j] = lanes[j] + (a * b) * gv
                    for side, row, v in (("src", s, cs), ("dst", dd, cd)):
                        run = runs[side]
                        if row == run[0]:
                            run[1] = run[1] + v
                        else:
                            if run[0] >= 0:
                                dz[run[0]] += run[1]
                                flushes[side] += 1
                            run[:] = [row, v]
                for side, (row, v) in runs.items():
                    dz[row] += v
                    flushes[side] += 1
        warps = lanes.reshape(port.BWD_WARPS, 8, d).copy()
        for o in (4, 2, 1):  # __shfl_down_sync by 16, 8, 4 lanes
            warps[:, :o] = warps[:, :o] + warps[:, o:2 * o]
        t = np.zeros(d, f)
        for u in range(port.BWD_WARPS):
            t = t + warps[u, 0]
        dwc[c] = t
    dw = np.zeros(w.shape, f)
    for c in range(nc):
        dw[ct[c]] = dw[ct[c]] + dwc[c]
    return dz[:n], dw, flushes


@pytest.mark.parametrize("chunk", [32, 1056])
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_backward_order_emulation_matches_plain(chunk, bf16):
    """The new backward's summation order (emulate_cuda_bwd; a chunk of
    1,056 slots makes a quad walk two segments) gives the plain version's
    dz and dw to float32 order, with and without the bf16 rounding of
    each contribution; one reduction a run of equal rows in a segment, so
    the dst-sorted positives and the pad tail take far fewer than one a
    slot."""
    raw = synthetic_trigraph(n_drug=60, n_prot=10, n_et=3, pairs_per_et=90,
                             seed=5)
    edges, _ = split_typed_edges(raw.dd_pair_list, p=0.95, seed=0)
    padded = pad_typed_edges(sort_typed_edges(edges), 60, chunk=chunk)
    nc = padded.chunk_type.shape[0]
    src2d = padded.src.reshape(nc, chunk)
    dst2d = padded.dst.reshape(nc, chunk)
    rng = np.random.default_rng(6)
    z = rng.normal(size=(60, 16)).astype(np.float32)
    w = rng.normal(size=(edges.n_et, 16)).astype(np.float32)
    g = rng.normal(size=src2d.shape).astype(np.float32)
    zr = _bf16(z) if bf16 else z  # the wrapper's compute_round
    dz, dw, flushes = emulate_cuda_bwd(zr, w, src2d, dst2d,
                                       padded.chunk_type, g, bf16)
    pdz, pdw = port.distmult_bwd_plain(*_t((zr, w, src2d, dst2d,
                                            padded.chunk_type, g)), bf16=bf16)
    np.testing.assert_allclose(dz, pdz.numpy(), atol=1e-5 * np.abs(dz).max())
    np.testing.assert_allclose(dw, pdw.numpy(), atol=1e-5 * np.abs(dw).max())
    # one reduction a run of equal rows in a segment
    for side, ids in (("src", src2d), ("dst", dst2d)):
        segs = ids.reshape(-1, port.SEG)
        assert flushes[side] == segs.shape[0] + int(
            (segs[:, 1:] != segs[:, :-1]).sum())
    assert flushes["dst"] < src2d.size / 2


def emulate_cuda_fwd(z, w, src2d, dst2d, ct):
    """csrc/distmult_fwd.cuh's logits in its global mode, in float32 and
    in its order: lane q of a slot's quad sums features 4q .. 4q + 3 in k
    order from 0, and the quad adds the four partial sums as (p0 + p1) +
    (p2 + p3)."""
    f = np.float32
    zp = np.vstack([z, np.zeros((1, z.shape[1]), f)]).astype(f)
    prod = (zp[src2d] * zp[dst2d]) * w[ct][:, None, :].astype(f)
    part = np.zeros(src2d.shape + (4,), f)
    for q in range(4):
        for k in range(4 * q, 4 * q + 4):
            part[..., q] = part[..., q] + prod[..., k]
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


def test_cuda_forward_order_emulation_matches_plain():
    """The global-mode forward's quad order (emulate_cuda_fwd) gives the
    plain logits to float32 order, and pad slots exactly +0.0."""
    bufs, z, w, valid = _setup(300, seed=4)
    got = emulate_cuda_fwd(z, w, *bufs)
    want = port.distmult_logits_plain(*_t((z, w, *bufs))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    pad = valid == 0
    assert pad.any() and np.all(got[pad] == 0) and not np.signbit(got[pad]).any()
