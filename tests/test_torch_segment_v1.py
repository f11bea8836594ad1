"""Kernels B6 and B7 of the port (tip_tpu_torch/ops/typed_segment.py: the
v1 DistMult and NN-decoder SDDMMs) against the JAX package's
distmult_logits_padded and nn_logits_padded on the CPU.

The CPU runs the plain PyTorch versions; chip_smoke.py holds the CUDA
kernels against them on the card.  The JAX kernels run in interpret mode,
as tests/test_torch_sddmm2.py runs B8.  Logits agree to atol 1e-5 and the
gradients to atol/rtol 1e-4 (float32 sums in another order: the TPU
kernels accumulate dz and dh over all chunks and dw per relation block).
Both get the same cotangent, so the bf16 rounding of each scattered
contribution sees the same float32 inputs.  dw is compared on the
relations that own a chunk: the TPU kernel never writes the others, the
port writes 0 there.  B6's and B7's backwards are also emulated in numpy
in the CUDA kernels' order (lane-quad run sums) and held against both.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tip_tpu.data import synthetic_trigraph
from tip_tpu.data.packing import pad_typed_edges, sort_typed_edges, split_typed_edges
from tip_tpu.ops.pallas_segment import distmult_logits_padded as j_dm1
from tip_tpu.ops.pallas_segment import nn_logits_padded as j_nn1
from tip_tpu_torch import kernels
from tip_tpu_torch.ops import sddmm2
from tip_tpu_torch.ops import typed_segment as port

N_ET = 7  # relations 5 and 6 own no chunk


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
    h1, h2 = (np.maximum(rng.normal(size=(n_drug, 16)), 0).astype(np.float32)
              for _ in range(2))
    w1, w2, w = (rng.normal(size=(N_ET, 16)).astype(np.float32)
                 for _ in range(3))
    valid = padded.valid.reshape(nc, 32).astype(np.float32)
    cot = rng.normal(size=valid.shape).astype(np.float32)
    owned = np.unique(padded.chunk_type)
    assert len(owned) < N_ET
    return bufs, dict(z=z, w=w, h1=h1, h2=h2, w1=w1, w2=w2), valid, cot, owned


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("n_drug", [40, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distmult_v1_matches_jax(n_drug, dtype):
    bufs, x, valid, cot, owned = _setup(n_drug)
    jb = list(map(jnp.asarray, bufs))

    def jloss(z, w):
        lg = j_dm1(z, w, *jb, jnp.dtype(dtype))
        return jnp.sum(lg * cot), lg

    with pltpu.force_tpu_interpret_mode():
        (_, jlg), (jgz, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                  has_aux=True)(x["z"], x["w"])
    zt = torch.tensor(x["z"], requires_grad=True)
    wt = torch.tensor(x["w"], requires_grad=True)
    lg = port.distmult_logits_padded(zt, wt, *_t(bufs), dtype)
    (lg * torch.from_numpy(cot)).sum().backward()
    _close(lg.detach(), jlg, 1e-5)
    _close(zt.grad, jgz, 1e-4, 1e-4)
    _close(wt.grad[owned], np.asarray(jgw)[owned], 1e-4, 1e-4)
    others = np.setdiff1d(np.arange(N_ET), owned)
    assert torch.all(wt.grad[others] == 0)
    pad = valid == 0
    assert pad.any()
    assert np.all(lg.detach().numpy()[pad] == 0.0)
    assert np.all(np.asarray(jlg)[pad] == 0.0)


@pytest.mark.parametrize("n_drug", [40, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nn_v1_matches_jax(n_drug, dtype):
    bufs, x, valid, cot, owned = _setup(n_drug)
    jb = list(map(jnp.asarray, bufs))
    names = ("h1", "h2", "w1", "w2")

    def jloss(*args):
        lg = j_nn1(*args, *jb, jnp.dtype(dtype))
        return jnp.sum(lg * cot), lg

    with pltpu.force_tpu_interpret_mode():
        (_, jlg), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                          has_aux=True)(*(x[k] for k in names))
    tx = [torch.tensor(x[k], requires_grad=True) for k in names]
    lg = port.nn_logits_padded(*tx, *_t(bufs), dtype)
    (lg * torch.from_numpy(cot)).sum().backward()
    # every slot, pad slots too: their src term is the same garbage in both
    _close(lg.detach(), jlg, 1e-5)
    _close(tx[0].grad, jg[0], 1e-4, 1e-4)
    _close(tx[1].grad, jg[1], 1e-4, 1e-4)
    others = np.setdiff1d(np.arange(N_ET), owned)
    for t, j in zip(tx[2:], jg[2:]):
        _close(t.grad[owned], np.asarray(j)[owned], 1e-4, 1e-4)
        assert torch.all(t.grad[others] == 0)
    pad = valid == 0
    assert pad.any() and np.any(np.asarray(jlg)[pad] != 0.0)


@pytest.mark.parametrize("kernel", ["distmult", "nn"])
def test_plain_backward_matches_autograd_of_plain_forward(kernel):
    """The hand-written backward (the CUDA kernels' arithmetic) equals
    autograd through the plain forward in float32."""
    bufs, x, _, cot, _ = _setup(300, seed=3)
    names = ("z", "w") if kernel == "distmult" else ("h1", "h2", "w1", "w2")
    fwd, bwd = ((port.distmult_v1_fwd_plain, port.distmult_v1_bwd_plain)
                if kernel == "distmult"
                else (port.nn_v1_fwd_plain, port.nn_v1_bwd_plain))
    tx = [torch.tensor(x[k], requires_grad=True) for k in names]
    (fwd(*tx, *_t(bufs)) * torch.from_numpy(cot)).sum().backward()
    got = bwd(*(torch.from_numpy(x[k]) for k in names), *_t(bufs),
              torch.from_numpy(cot))
    for g, t in zip(got, tx):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-4,
                                   rtol=1e-5)


def test_v1_equals_v2_in_float32_on_valid_slots():
    """B6 and B8, B7 and B9 compute the same logits and gradients; they
    round to bf16 at other points, so they agree in float32 only."""
    bufs, x, valid, cot, _ = _setup(300, seed=4)
    tb = _t(bufs)
    g = torch.from_numpy(cot * valid)  # a masked loss: pad slots carry no g
    ok = torch.from_numpy(valid) > 0
    z, w = torch.from_numpy(x["z"]), torch.from_numpy(x["w"])
    _close(port.distmult_v1_fwd_plain(z, w, *tb)[ok],
           sddmm2.distmult_logits_plain(z, w, *tb)[ok], 1e-5)
    for a, b in zip(port.distmult_v1_bwd_plain(z, w, *tb, g),
                    sddmm2.distmult_bwd_plain(z, w, *tb, g)):
        _close(a, b, 1e-4, 1e-4)
    hw = [torch.from_numpy(x[k]) for k in ("h1", "h2", "w1", "w2")]
    _close(port.nn_v1_fwd_plain(*hw, *tb)[ok],
           sddmm2.nn_logits_plain(*hw, *tb)[ok], 1e-5)
    for a, b in zip(port.nn_v1_bwd_plain(*hw, *tb, g),
                    sddmm2.nn_bwd_plain(*hw, *tb, g)):
        _close(a, b, 1e-4, 1e-4)


def test_cpu_tensors_take_the_plain_versions_and_cuda_wrappers_refuse_them():
    bufs, x, _, _, _ = _setup(40)
    tb = _t(bufs)
    kernels.reset_launch_counts()
    zt = torch.tensor(x["z"], requires_grad=True)
    port.distmult_logits_padded(zt, torch.from_numpy(x["w"]), *tb).sum().backward()
    hw = [torch.tensor(x[k], requires_grad=True) for k in ("h1", "h2", "w1", "w2")]
    port.nn_logits_padded(*hw, *tb, "bfloat16").sum().backward()
    assert kernels.LAUNCHES[port.DM1] == 0 and kernels.LAUNCHES[port.NN1] == 0
    z, w = torch.from_numpy(x["z"]), torch.from_numpy(x["w"])
    for call in (lambda: port.distmult_v1_fwd_cuda(z, w, *tb),
                 lambda: port.distmult_v1_bwd_cuda(z, w, *tb, z[:0]),
                 lambda: port.nn_v1_fwd_cuda(z, z, w, w, *tb),
                 lambda: port.nn_v1_bwd_cuda(z, z, w, w, *tb, z[:0])):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("bad", ["width", "relations", "nodes", "dtype",
                                 "g_shape", "table", "chunk"])
@pytest.mark.parametrize("kernel", ["distmult", "nn"])
def test_cuda_argument_checks(kernel, bad):
    """What the CUDA wrappers refuse before they hand pointers to a kernel
    (the checks need no card)."""
    bufs, x, _, cot, _ = _setup(40)
    if kernel == "distmult":
        nodes = {"z": torch.from_numpy(x["z"])}
        rels = {"w": torch.from_numpy(x["w"])}
    else:
        nodes = {k: torch.from_numpy(x[k]) for k in ("h1", "h2")}
        rels = {k: torch.from_numpy(x[k]) for k in ("w1", "w2")}
    tb, g = _t(bufs), torch.from_numpy(cot)
    # both forwards keep a table in shared memory, neither backward
    port._check_v1_args(nodes, rels, tb, False, "shared", g)  # valid: passes
    port._check_v1_args(nodes, rels, tb, True, "global", g)
    with pytest.raises(ValueError, match="no table"):
        port._check_v1_args(nodes, rels, tb, True, "shared", g)
    table = "shared"
    if bad == "width":  # the kernels are built for width 16 only
        nodes = {k: v[:, :12].contiguous() for k, v in nodes.items()}
    elif bad == "relations":  # relation rows of another width
        rels = {k: v[:, :8].contiguous() for k, v in rels.items()}
    elif bad == "nodes":  # the shared-memory tables (score rows) no longer fit
        n_big = 3500 if kernel == "distmult" else 30_000
        nodes = {k: torch.zeros(n_big, 16) for k in nodes}
    elif bad == "dtype":
        tb[0] = tb[0].long()
    elif bad == "g_shape":
        g = g[:, :16].contiguous()
    elif bad == "chunk":  # the lane quads walk 16-slot segments
        tb = [tb[0][:, :24].contiguous(), tb[1][:, :24].contiguous(), tb[2]]
        g = g[:, :24].contiguous()
        for grads in (False, True):
            with pytest.raises(ValueError, match="multiple of 16"):
                port._check_v1_args(nodes, rels, tb, grads, None, g)
    else:
        table = "device"
    with pytest.raises(ValueError):
        port._check_v1_args(nodes, rels, tb, False, table, g)


@pytest.mark.parametrize("tables,grads,n_max", [
    (1, False, 3417), (1, True, 0), (2, False, 29055), (2, True, 0)])
def test_shared_table_boundary(tables, grads, n_max):
    """The largest graph whose tables B6's forward (one node table, B8's)
    or B7's (two score rows, B9's) keeps in shared memory; one node more
    takes the global-memory mode, which has no limit.  Both backwards add
    into device memory at every n (n_max 0: never in shared memory)."""
    if n_max:
        assert port.v1_shared_fits(n_max, tables, grads)
    assert not port.v1_shared_fits(n_max + 1, tables, grads)
    bufs, x, _, _, _ = _setup(40)
    names = ("z",) if tables == 1 else ("h1", "h2")
    rels = {k: torch.from_numpy(x[k]) for k in (("w",) if tables == 1
                                                else ("w1", "w2"))}
    for n, shared in ((n_max, n_max > 0), (n_max + 1, False),
                      (40_000, False)):
        nodes = {k: torch.zeros(n, 16) for k in names}
        assert port._check_v1_args(nodes, rels, _t(bufs), grads) == (n, shared)
        assert port._check_v1_args(nodes, rels, _t(bufs), grads,
                                   "global") == (n, False)


# ---------------------------------------------------------------------------
# B6's and B7's backwards in the CUDA kernels' order (csrc/quad_walk.cuh)
# ---------------------------------------------------------------------------

SEG, BWD_WARPS = 16, 8  # a quad's segment; warps of a backward block


def _bf16(x):
    """Round float32 to bf16 (nearest even), kept as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def emulate_walk(src2d, dst2d, ct, g, n, n_et, d, slot, to, rows):
    """(tables [2, n + 1, d], dw [n_et, rows, d], reductions a side) in
    float32 in the order of the lane-quad backwards (csrc/quad_walk.cuh):
    lane quads of 8-quad warps of an 8-warp block walk 16-slot segments
    (segment k * 64 + warp * 8 + quad of a chunk); ``slot(t, s, dst, g)``
    gives a slot's contributions to its src and dst rows and its dw
    partials [rows, d]; each side's contributions enter a run sum, and a
    run of equal rows is added to tables[to[side]] once, where it ends;
    the quad's dw partials are chains over its slots, summed by a shuffle
    tree over a warp's quads, then the warps in order; dw the chunks of a
    relation in order.  The tables take the runs in this emulation's order
    (the kernel's is not fixed)."""
    f = np.float32
    nc, C = src2d.shape
    nseg, per = C // SEG, 8 * BWD_WARPS
    tabs = np.zeros((2, n + 1, d), f)
    dwc = np.zeros((nc, rows, d), f)
    runs_added = [0, 0]
    for c in range(nc):
        lanes = np.zeros((per, rows, d), f)
        for s0 in range(0, nseg, per):
            for j in range(min(per, nseg - s0)):
                sl = slice((s0 + j) * SEG, (s0 + j + 1) * SEG)
                runs = [[-1, None], [-1, None]]
                for s, dd, gv in zip(src2d[c, sl], dst2d[c, sl], g[c, sl]):
                    cs, cd, part = slot(ct[c], s, dd, f(gv))
                    lanes[j] = lanes[j] + part
                    for side, (row, v) in enumerate(((s, cs), (dd, cd))):
                        run = runs[side]
                        if row == run[0]:
                            run[1] = run[1] + v
                        else:
                            if run[0] >= 0:
                                tabs[to[side], run[0]] += run[1]
                                runs_added[side] += 1
                            run[:] = [row, v]
                for side, (row, v) in enumerate(runs):
                    tabs[to[side], row] += v
                    runs_added[side] += 1
        warps = lanes.reshape(BWD_WARPS, 8, rows, d).copy()
        for o in (4, 2, 1):  # __shfl_down_sync by 16, 8, 4 lanes
            warps[:, :o] = warps[:, :o] + warps[:, o:2 * o]
        t = np.zeros((rows, d), f)
        for u in range(BWD_WARPS):
            t = t + warps[u, 0]
        dwc[c] = t
    dw = np.zeros((n_et, rows, d), f)
    for c in range(nc):
        dw[ct[c]] = dw[ct[c]] + dwc[c]
    return tabs, dw, runs_added


def emulate_v1_bwd(h1, h2, w1, w2, src2d, dst2d, ct, g, bf16: bool):
    """B7's backward (csrc/nn_sddmm_v1.cu) in the kernel's order
    (emulate_walk): each slot's contributions w1[t] g and w2[t] g are
    rounded (bf16) before they enter a run sum a side, into dh1 and dh2;
    its dw partials h1[src] g and h2[dst] g.  (dh1, dh2, dw1, dw2,
    reductions a side)."""
    f = np.float32
    n, d = h1.shape
    hp = [np.vstack([h, np.zeros((1, d), f)]).astype(f) for h in (h1, h2)]

    def slot(t, s, dd, gv):
        v = [w1[t].astype(f) * gv, w2[t].astype(f) * gv]
        if bf16:
            v = [_bf16(x) for x in v]
        return v[0], v[1], np.stack([hp[0][s] * gv, hp[1][dd] * gv])

    tabs, dw, runs = emulate_walk(src2d, dst2d, ct, g, n, w1.shape[0], d,
                                  slot, (0, 1), 2)
    return tabs[0, :n], tabs[1, :n], dw[:, 0], dw[:, 1], runs


def emulate_dm1_bwd(z, w, src2d, dst2d, ct, g, bf16: bool):
    """B6's backward (csrc/distmult_sddmm_v1.cu: distmult_bwd.cuh's walk,
    B8's, with B6's product order) in the kernel's order (emulate_walk):
    each slot's contributions (z[dst] w[t]) g to its src row and (z[src]
    w[t]) g to its dst row are rounded (bf16) before they enter a run sum,
    both into the one table dz; its dw partial (z[src] z[dst]) g.  (dz,
    dw, reductions a side)."""
    f = np.float32
    n, d = z.shape
    zp = np.vstack([z, np.zeros((1, d), f)]).astype(f)

    def slot(t, s, dd, gv):
        a, b, wt = zp[s], zp[dd], w[t].astype(f)
        cs, cd = (b * wt) * gv, (a * wt) * gv
        if bf16:
            cs, cd = _bf16(cs), _bf16(cd)
        return cs, cd, ((a * b) * gv)[None]

    tabs, dw, runs = emulate_walk(src2d, dst2d, ct, g, n, w.shape[0], d,
                                  slot, (0, 0), 1)
    return tabs[0, :n], dw[:, 0], runs


def _skewed_setup(chunk, seed=8):
    """60 drugs, relation 0 holding every drug pair (a skewed relation of
    many chunks), relations 1-2 a few; each relation's last chunk ends in
    a pad tail."""
    raw = synthetic_trigraph(n_drug=60, n_prot=10, n_et=3, pairs_per_et=40,
                             seed=seed)
    lo, hi = np.triu_indices(60, 1)
    pairs = [np.stack([lo, hi]).astype(np.int32), *raw.dd_pair_list[1:]]
    edges, _ = split_typed_edges(pairs, p=0.95, seed=0)
    padded = pad_typed_edges(sort_typed_edges(edges), 60, chunk=chunk)
    nc = padded.chunk_type.shape[0]
    bufs = (padded.src.reshape(nc, chunk), padded.dst.reshape(nc, chunk),
            padded.chunk_type)
    rng = np.random.default_rng(seed)
    h1, h2 = (np.maximum(rng.normal(size=(60, 16)), 0).astype(np.float32)
              for _ in range(2))
    w1, w2 = (rng.normal(size=(3, 16)).astype(np.float32) for _ in range(2))
    cot = rng.normal(size=bufs[0].shape).astype(np.float32)
    valid = padded.valid.reshape(nc, chunk)
    z = rng.normal(size=(60, 16)).astype(np.float32)
    w = rng.normal(size=(3, 16)).astype(np.float32)
    return bufs, (h1, h2, w1, w2), cot, valid, (z, w)


@pytest.mark.parametrize("chunk", [32, 1056])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_order_emulation_matches_plain_and_jax(chunk, dtype):
    """The new backward's order (emulate_v1_bwd; a chunk of 1,056 slots
    makes a quad walk two segments) gives the plain version's and the JAX
    interpret kernel's dh1, dh2, dw1, dw2 to the file's tolerance, on a
    skewed relation with pad tails, with and without the bf16 rounding of
    each contribution; one reduction a run of equal rows in a segment, so
    the dst-sorted positives and the pad tails take far fewer than one a
    slot."""
    bufs, hw, cot, valid, _ = _skewed_setup(chunk)
    src2d, dst2d, ct = bufs
    assert (ct == 0).sum() > len(ct) / 2 and (~valid).any()
    bf16 = dtype == "bfloat16"
    hr = [_bf16(h) if bf16 else h for h in hw[:2]]  # compute_round
    got = emulate_v1_bwd(*hr, *hw[2:], *bufs, cot, bf16)
    plain = port.nn_v1_bwd_plain(*_t((*hr, *hw[2:], *bufs, cot)), bf16=bf16)
    for a, b in zip(got[:4], plain):
        _close(a, b, 1e-4, 1e-4)

    def jloss(*args):
        return jnp.sum(j_nn1(*args, *map(jnp.asarray, bufs),
                             jnp.dtype(dtype)) * cot)

    with pltpu.force_tpu_interpret_mode():
        jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*hw)
    for a, b in zip(got[:4], jg):
        _close(a, b, 1e-4, 1e-4)
    for side, ids in enumerate((src2d, dst2d)):
        segs = ids.reshape(-1, SEG)
        assert got[4][side] == segs.shape[0] + int(
            (segs[:, 1:] != segs[:, :-1]).sum())
    assert got[4][1] < src2d.size / 2


@pytest.mark.parametrize("chunk", [32, 1056])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_distmult_backward_order_emulation_matches_plain_and_jax(
        chunk, dtype):
    """B6's new backward in its order (emulate_dm1_bwd: B8's lane-quad walk,
    each contribution (z[other] w) g rounded before it enters a run sum)
    gives the plain version's and the JAX interpret kernel's dz and dw to
    the file's tolerance, on a skewed relation with pad tails, float32 and
    bf16; one reduction a run of equal rows a side, and a pad slot adds
    nothing to its src row (its dst row, n, is scratch)."""
    bufs, _, cot, valid, (z, w) = _skewed_setup(chunk)
    src2d, dst2d, ct = bufs
    assert (ct == 0).sum() > len(ct) / 2 and (~valid).any()
    bf16 = dtype == "bfloat16"
    zr = _bf16(z) if bf16 else z  # compute_round
    dz, dw, runs = emulate_dm1_bwd(zr, w, *bufs, cot, bf16)
    pdz, pdw = port.distmult_v1_bwd_plain(*_t((zr, w, *bufs, cot)),
                                          bf16=bf16)
    _close(dz, pdz, 1e-4, 1e-4)
    _close(dw, pdw, 1e-4, 1e-4)

    def jloss(z, w):
        return jnp.sum(j_dm1(z, w, *map(jnp.asarray, bufs),
                             jnp.dtype(dtype)) * cot)

    with pltpu.force_tpu_interpret_mode():
        jgz, jgw = jax.grad(jloss, argnums=(0, 1))(z, w)
    _close(dz, jgz, 1e-4, 1e-4)
    owned = np.unique(ct)
    _close(dw[owned], np.asarray(jgw)[owned], 1e-4, 1e-4)
    for side, ids in enumerate((src2d, dst2d)):
        segs = ids.reshape(-1, SEG)
        assert runs[side] == segs.shape[0] + int(
            (segs[:, 1:] != segs[:, :-1]).sum())
    assert runs[1] < src2d.size / 2
    # the pad slots alone add exactly zero to their src rows
    pad_g = np.where(valid, 0, cot).astype(np.float32)
    pad_dz, pad_dw, _ = emulate_dm1_bwd(zr, w, *bufs, pad_g, bf16)
    assert not pad_dz.any() and not pad_dw.any()
