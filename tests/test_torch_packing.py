"""The port's host-side packing (tip_tpu_torch/data) is bit-identical to the
JAX package's, in both D-D layouts, and the port imports nothing of JAX or
the JAX package."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tip_tpu.data as jdata
from tip_tpu.data import packing as jpack
from tip_tpu.sampling.negative import bitmap_byte_planes
from tip_tpu.sampling.negative import build_typed_bitmap as j_bitmap
from tip_tpu.train.model import make_graph_arrays as j_graph_arrays
import tip_tpu_torch
from tip_tpu_torch.data import packing as tpack
from tip_tpu_torch.train.model import make_graph_arrays as t_graph_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_KW = dict(n_drug=150, n_prot=64, n_et=5, pairs_per_et=120, n_pp_pairs=200,
              n_dp=120, seed=3)


@pytest.fixture(scope="module")
def both():
    jraw = jdata.synthetic_trigraph(**RAW_KW)
    traw = tpack.synthetic_trigraph(**RAW_KW)
    return (jraw, jdata.build_trigraph(jraw, split_rate=0.9, seed=5),
            traw, tpack.build_trigraph(traw, split_rate=0.9, seed=5))


def _equal(a, b, what):
    assert type(a) is type(b) or isinstance(a, np.ndarray), what
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


def _typed_equal(a, b, what):
    for k in ("edge_index", "edge_type", "range_list"):
        _equal(getattr(a, k), getattr(b, k), f"{what}.{k}")


def test_synthetic_raw_identical(both):
    jraw, _, traw, _ = both
    assert jraw.n_drug == traw.n_drug and jraw.n_prot == traw.n_prot
    assert len(jraw.dd_pair_list) == len(traw.dd_pair_list)
    for a, b in zip(jraw.dd_pair_list, traw.dd_pair_list):
        _equal(a, b, "dd_pair_list")
    for k in ("et_ids", "pp_edge_index", "dp_edge_index"):
        _equal(getattr(jraw, k), getattr(traw, k), k)


def test_trigraph_fields_identical(both):
    _, jd, _, td = both
    for f in dataclasses.fields(jd):
        a, b = getattr(jd, f.name), getattr(td, f.name)
        if isinstance(a, jpack.TypedEdges):
            _typed_equal(a, b, f.name)
        elif a is None:
            assert b is None, f.name
        else:
            _equal(a, b, f.name)


def test_dense_layouts_identical(both):
    _, jd, _, td = both
    n = jd.n_drug
    da_j = jpack.dense_relation_adj(jd.dd_train, n)
    da_t = tpack.dense_relation_adj(td.dd_train, n)
    _equal(da_j, da_t, "dense_relation_adj")
    _equal(jpack.sym_strip_pack(da_j), tpack.sym_strip_pack(da_t), "strips")
    _equal(jpack.poisson_neg_thresholds_sym(jd.dd_train, n),
           tpack.poisson_neg_thresholds_sym(td.dd_train, n), "q8")
    for a, b in zip(jpack.dense_pp_parts(jd.pp_norm_index, jd.n_prot),
                    tpack.dense_pp_parts(td.pp_norm_index, td.n_prot)):
        _equal(a, b, "dense_pp_parts")
    assert (jpack.max_multiplicity(jd.dd_train, n)
            == tpack.max_multiplicity(td.dd_train, n))
    _equal(j_bitmap(jd.dd_test.edge_index, jd.dd_test.edge_type, n, jd.n_et),
           tpack.build_typed_bitmap(td.dd_test.edge_index,
                                    td.dd_test.edge_type, n, td.n_et),
           "bitmap")


def test_poisson_neg_thresholds_identical(both):
    _, jd, _, td = both
    for split in ("dd_train", "dd_test"):
        _equal(jpack.poisson_neg_thresholds(getattr(jd, split), jd.n_drug),
               tpack.poisson_neg_thresholds(getattr(td, split), td.n_drug),
               f"{split} q")
    q = tpack.poisson_neg_thresholds(td.dd_train, td.n_drug)
    assert q.shape == (td.n_et, 3) and q.dtype == np.int32
    assert np.all(q[:, 0] >= q[:, 1]) and np.all(q[:, 1] >= q[:, 2])


@pytest.mark.parametrize("dtype", ["uint8", "bfloat16", "float32"])
def test_cast_dense_adj_exact_or_raises(both, dtype):
    """The full pages hold the JAX package's counts exactly; a count past
    the dtype's exact range raises instead of wrapping."""
    _, jd, _, td = both
    da = tpack.dense_relation_adj(td.dd_train, td.n_drug)
    pages = tpack.cast_dense_adj(da, dtype)
    if dtype == "bfloat16":  # bf16 bit patterns: a float32's upper half
        assert pages.dtype == np.uint16
        pages = (pages.astype(np.uint32) << 16).view(np.float32)
    else:
        assert pages.dtype == np.dtype(dtype)
    assert pages.shape == da.shape
    want = np.asarray(jpack.cast_dense_adj(
        jpack.dense_relation_adj(jd.dd_train, jd.n_drug), np.float32))
    assert np.array_equal(pages.astype(np.float32), want)
    top = tpack.PAGE_EXACT_MAX[dtype]
    if top < np.iinfo(da.dtype).max:
        heavy = da.copy()
        heavy[0, 0, 0] = top
        tpack.cast_dense_adj(heavy, dtype)  # the largest exact count passes
        heavy[0, 0, 0] = top + 1
        with pytest.raises(ValueError, match="not exactly representable"):
            tpack.cast_dense_adj(heavy, dtype)
    with pytest.raises(ValueError, match="page dtype"):
        tpack.cast_dense_adj(da, "int16")


def test_graph_arrays_match_jax_layout(both):
    _, jd, _, td = both
    jg, jgs = j_graph_arrays(jd, dense_dtype="bfloat16")
    tg, tgs = t_graph_arrays(td, device="cpu", dense_dtype="bfloat16")
    assert "dd_adj_t" not in tg  # the strips replace the full pages
    for k in ("dd_deg", "dd_adj_sym", "dd_neg_q8", "pp_a1", "pp_dinv",
              "dp_src", "dp_dst", "dp_deg"):
        want = np.asarray(jg[k])
        got = tg[k].numpy()
        if k in ("dp_src", "dp_dst"):  # the port indexes with int64
            got = got.astype(want.dtype)
        assert np.array_equal(got, want), k
    assert tgs.dd_n_valid == jgs.dd_n_valid


def test_asymmetric_pages_raise_naming_later_slice(both):
    _, _, _, td = both
    src, dst = td.dd_train.edge_index
    keep = ~((td.dd_train.edge_type == 0) & (src == src[0]) & (dst == dst[0]))
    broken = dataclasses.replace(
        td, dd_train=tpack.TypedEdges(
            td.dd_train.edge_index[:, keep], td.dd_train.edge_type[keep],
            tpack._ranges_from_counts(np.bincount(
                td.dd_train.edge_type[keep], minlength=td.n_et))))
    # the strips cannot be built: the full bf16 pages, as the JAX package
    # falls back
    graph, gs = t_graph_arrays(broken, device="cpu", dense_dtype="bfloat16")
    assert gs.dd_layout == "pages" and "dd_adj_sym" not in graph
    assert graph["dd_adj_t"].dtype == torch.bfloat16
    want = tpack.dense_relation_adj(broken.dd_train, broken.n_drug)
    assert np.array_equal(graph["dd_adj_t"].float().numpy(), want)


@pytest.mark.parametrize("chunk", [32, 1024])
def test_pad_typed_edges_identical(both, chunk):
    _, jd, _, td = both
    for split in ("dd_train", "dd_test"):
        a = jpack.pad_typed_edges(getattr(jd, split), jd.n_drug, chunk=chunk)
        b = tpack.pad_typed_edges(getattr(td, split), td.n_drug, chunk=chunk)
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{split}.{f.name}")


@pytest.mark.parametrize("window,chunk", [(64, 32), (1024, 512)])
def test_pad_windowed_edges_identical(both, window, chunk):
    _, jd, _, td = both
    a = jpack.pad_windowed_edges(jd.pp_norm_index, jd.pp_norm_weight,
                                 jd.n_prot, window=window, chunk=chunk)
    b = tpack.pad_windowed_edges(td.pp_norm_index, td.pp_norm_weight,
                                 td.n_prot, window=window, chunk=chunk)
    for f in dataclasses.fields(a):
        _equal(getattr(a, f.name), getattr(b, f.name), f.name)


def test_chunked_graph_arrays_match_jax_layout(both):
    _, jd, _, td = both
    kw = dict(dd_chunk=32, pp_window=64, pp_chunk=32)
    jg, jgs = j_graph_arrays(jd, **kw)
    tg, tgs = t_graph_arrays(td, device="cpu", **kw)
    assert "dd_adj_sym" not in tg and "pp_a1" not in tg
    for k in ("dd_src2d", "dd_dst2d", "dd_valid", "dd_chunk_type", "ppw_src",
              "ppw_dstl", "ppw_w", "ppw_chunk_window"):
        want, got = np.asarray(jg[k]), tg[k].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    for k in ("dd_deg", "dp_deg"):  # int64 here, int32 in JAX without x64
        assert np.array_equal(tg[k].numpy(), np.asarray(jg[k])), k
    # the bitmap travels as int32 words holding the same bits
    assert np.array_equal(tg["dd_bitmap"].numpy().view(np.uint32),
                          np.asarray(jg["dd_bitmap"]))
    for f in ("n_drug", "n_prot", "n_et", "dd_chunk", "dd_n_chunks",
              "dd_n_valid", "pp_window", "pp_n_windows", "drug_feat_dim"):
        assert getattr(tgs, f) == getattr(jgs, f), f
    assert tgs.dd_layout == "chunked"


def test_bitmap_bytes_are_jax_byte_planes(both):
    """The CUDA sampler reads byte (pair >> 3) of a relation's slice of the
    uint32 bitmap; that is the byte JAX's sampler table holds at
    [t, lane = b & 127, row = b >> 7], for every byte."""
    _, jd, _, td = both
    n, n_et = td.n_drug, td.n_et
    planes = bitmap_byte_planes(jd.dd_train_bitmap, n_et, n)  # [R, 128, rows]
    tg, _ = t_graph_arrays(td, device="cpu")
    got = tg["dd_bitmap"].view(torch.uint8).numpy().reshape(n_et, -1)
    want = planes.transpose(0, 2, 1).reshape(n_et, -1).view(np.uint8)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert got.any()  # the check is not vacuous


def _port_sources():
    pkg = os.path.dirname(tip_tpu_torch.__file__)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return paths


def test_port_sources_import_no_jax():
    banned = ("jax", "optax", "tip_tpu")
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_port_imports_with_jax_blocked():
    """Every module of the package imports with jax, optax and tip_tpu made
    unimportable."""
    pkg = os.path.dirname(tip_tpu_torch.__file__)
    mods = ["tip_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([pkg], "tip_tpu_torch.")]
    code = (
        "import sys\n"
        "for m in ('jax', 'optax', 'tip_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "tip_tpu_torch.train.loop" in mods and "tip_tpu_torch.kernels" in mods
    assert "tip_tpu_torch.scripts.decoder_ab" in mods
