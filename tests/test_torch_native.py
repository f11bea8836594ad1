"""The port's native packing library (tip_tpu_torch/native) against its plain
numpy versions and against the JAX package's numpy branches
(tip_tpu/native/__init__.py, written out here: calling that module would
enter its in-place build), bit for bit; its build when six processes start
it at once into an empty directory; and the error a broken source gives.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tip_tpu_torch import native
from tip_tpu_torch.data import packing as tpack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Decagon's width: 645 drugs, 1,097 relations (scripts/decoder_ab.py)
N_DECAGON, ET_DECAGON = 645, 1097
CASES = ["random", "empty", "duplicates", "one_relation", "decagon_keys"]


def _edges(case: str):
    """(et, dst, src, n_nodes) int32 edges of one test case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "empty":
        z = np.zeros(0, np.int32)
        return z, z.copy(), z.copy(), 1
    if case == "random":
        n, n_et, e = 97, 11, 5000
    elif case == "duplicates":  # few distinct edges, each many times
        n, n_et, e = 5, 2, 3000
    elif case == "one_relation":
        n, n_et, e = 300, 1, 4000
    else:  # the largest keys of Decagon's width: n_et * n^2 - 1 and near
        n, n_et, e = N_DECAGON, ET_DECAGON, 6000
    et = rng.integers(0, n_et, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    if case == "decagon_keys":
        et[:100], dst[:100] = n_et - 1, n - 1
        src[:100] = rng.integers(n - 3, n, 100)
    return et, dst, src, n


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_sort_edges_order_is_lexsort(case):
    et, dst, src, n = _edges(case)
    order = native.sort_edges_order(et, dst, src, n)
    _equal(order, native.sort_edges_order_plain(et, dst, src, n))
    _equal(order, np.lexsort((src, dst, et)))  # the JAX package's branch
    if case == "duplicates":  # ties keep their index order
        key = (et.astype(np.int64) * n + dst) * n + src
        for k in np.unique(key):
            idx = order[key[order] == k]
            assert np.all(np.diff(idx) > 0)


@pytest.mark.parametrize("case", CASES)
def test_build_bitmap_matches_bitwise_or_at(case):
    et, dst, src, n = _edges(case)
    n_et = int(et.max()) + 1 if et.size else 1
    stride = tpack.bitmap_stride_bits(n)
    keys = et.astype(np.int64) * stride + dst.astype(np.int64) * n + src
    space = n_et * stride
    if case == "decagon_keys":  # the last bit of the key space
        keys = np.concatenate([keys, [space - 1, space - 32]])
    got = native.build_bitmap(keys, space)
    _equal(got, native.build_bitmap_plain(keys, space))
    want = np.zeros((space + 31) // 32, np.uint32)  # the JAX package's
    np.bitwise_or.at(want, (keys >> 5).astype(np.int64),
                     np.uint32(1) << (keys & 31).astype(np.uint32))
    _equal(got, want)
    assert int(np.unpackbits(got.view(np.uint8)).sum()) == np.unique(keys).size


@pytest.mark.parametrize("case", CASES)
def test_pad_typed_fill_matches_the_fill_loop(case):
    et, dst, src, n = _edges(case)
    order = np.lexsort((src, dst, et))
    et, dst, src = et[order], dst[order], src[order]
    n_et = int(et.max()) + 1 if et.size else 1
    counts = np.bincount(et, minlength=n_et)
    ends = np.cumsum(counts)
    ranges = np.stack([ends - counts, ends], 1).astype(np.int32)
    chunk = 32
    padded = np.maximum(1, -(-counts // chunk)) * chunk
    outs = (np.cumsum(padded) - padded).astype(np.int64)
    total = int(padded.sum())
    got = native.pad_typed_fill(src, dst, ranges, outs, total, n)
    for a, b in zip(got, native.pad_typed_fill_plain(src, dst, ranges, outs,
                                                     total, n)):
        _equal(a, b)
    psrc = np.zeros(total, np.int32)  # the JAX package's fill loop
    pdst = np.full(total, n, np.int32)
    valid = np.zeros(total, np.uint8)
    for t in range(n_et):
        s, e, o = int(ranges[t, 0]), int(ranges[t, 1]), int(outs[t])
        psrc[o:o + e - s] = src[s:e]
        pdst[o:o + e - s] = dst[s:e]
        valid[o:o + e - s] = 1
    for a, b in zip(got, (psrc, pdst, valid.astype(bool))):
        _equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_bincount_i32_matches_bincount(case):
    _, dst, _, n = _edges(case)
    got = native.bincount_i32(dst, n)
    _equal(got, native.bincount_i32_plain(dst, n))
    _equal(got, np.bincount(dst, minlength=n).astype(np.int64))


@pytest.mark.parametrize("fn", ["sort", "bitmap", "fill", "bincount"])
def test_out_of_range_inputs_raise(fn):
    """The C loops index by their inputs unchecked; the bindings check the
    ranges first."""
    x = np.array([0, 3, 7], np.int32)
    with pytest.raises(ValueError):
        if fn == "sort":
            native.sort_edges_order(x, x, x, 7)
        elif fn == "bitmap":
            native.build_bitmap(np.array([0, 64], np.int64), 40)
        elif fn == "fill":
            native.pad_typed_fill(x, x, np.array([[0, 3]], np.int32),
                                  np.array([0]), 2, 8)
        else:
            native.bincount_i32(np.array([-1, 2], np.int32), 4)


def test_packing_runs_the_library_and_the_plain_versions_agree(monkeypatch):
    """build_trigraph runs the library (the plain versions made to raise do
    not stop it), and under ``plain_versions`` packs the same graph, bit
    for bit."""
    raw = tpack.synthetic_trigraph(n_drug=90, n_prot=40, n_et=4,
                                   pairs_per_et=80, n_pp_pairs=100, n_dp=60,
                                   seed=2)
    plain = {}
    with native.plain_versions():
        plain_data = tpack.build_trigraph(raw, split_rate=0.9, seed=5)
        plain_pad = tpack.pad_typed_edges(plain_data.dd_train, 90, chunk=32)
    for name in ("sort_edges_order", "build_bitmap", "pad_typed_fill",
                 "bincount_i32"):
        plain[name] = getattr(native, f"{name}_plain")

        def refuse(*a, _name=name, **k):
            raise AssertionError(f"the main path ran {_name}'s plain version")
        monkeypatch.setattr(native, f"{name}_plain", refuse)
    data = tpack.build_trigraph(raw, split_rate=0.9, seed=5)
    pad = tpack.pad_typed_edges(data.dd_train, 90, chunk=32)
    for f in data.__dataclass_fields__:
        a, b = getattr(data, f), getattr(plain_data, f)
        if isinstance(a, tpack.TypedEdges):
            for k in ("edge_index", "edge_type", "range_list"):
                _equal(getattr(a, k), getattr(b, k))
        elif isinstance(a, np.ndarray):
            _equal(a, b)
        else:
            assert a == b, f
    for k in ("src", "dst", "chunk_type", "range_list", "valid"):
        _equal(getattr(pad, k), getattr(plain_pad, k))


_WORKER = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from tip_tpu_torch import native
native.load(build_dir={build!r})
native.BUILD_DIR = {build!r}
rng = np.random.default_rng(7)
et, dst, src = (rng.integers(0, 50, 20000).astype(np.int32) for _ in range(3))
order = native.sort_edges_order(et, dst, src, 50)
assert np.array_equal(order, np.lexsort((src, dst, et)))
bits = native.build_bitmap(et.astype(np.int64) * 2500 + dst * 50 + src, 125000)
print(hash(order.tobytes()), hash(bits.tobytes()))
"""


def test_six_processes_build_into_an_empty_directory_at_once(tmp_path):
    """Six processes that start together each find no library and build it;
    each writes a file of its own and renames it into place, so every one
    loads a whole library and computes the same result, and no temporary
    file stays behind."""
    build = str(tmp_path / "build")
    code = _WORKER.format(root=ROOT, build=build)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ, PYTHONHASHSEED="0"))
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out for out, _ in outs}) == 1
    assert os.listdir(build) == ["libtipcore.so"]


def test_a_stale_library_is_rebuilt(tmp_path):
    build = str(tmp_path / "build")
    so = native.build(build_dir=build)
    os.utime(so, (1.0, 1.0))  # older than the source
    native.load(build_dir=build)
    assert os.path.getmtime(so) > 1.0


def test_a_broken_source_raises_with_the_compiler_message(tmp_path):
    with open(native.SOURCE) as f:
        text = f.read()
    broken = tmp_path / "tipcore.cpp"
    broken.write_text(text.replace("std::sort(", "std::sort_not_a_function("))
    with pytest.raises(RuntimeError, match="sort_not_a_function") as e:
        native.load(source=str(broken), build_dir=str(tmp_path / "build"))
    assert "g++ exited" in str(e.value) and "error" in str(e.value)
    assert not os.path.exists(tmp_path / "build" / "libtipcore.so")
    assert os.listdir(tmp_path / "build") == []
