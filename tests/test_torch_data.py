"""The port's data layer (tip_tpu_torch/data: preprocess, compat, decagon's
band selection, cache) against the JAX package on the same inputs: every
output bit-identical, byte-equal on disk where both write files."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tip_tpu.data as jdata
from tip_tpu.data import cache as jcache
from tip_tpu.data.compat import load_data_dict as j_load_data_dict
from tip_tpu.data.decagon import et_list_by_nnz_band as j_band
from tip_tpu.data.preprocess import preprocess_decagon as j_preprocess
from tests.test_compat import _make_reference_pickle
from tests.test_preprocess import _write_raw
from tip_tpu_torch.config import ModelConfig, TrainConfig
from tip_tpu_torch.data import cache as tcache
from tip_tpu_torch.data import packing as tpack
from tip_tpu_torch.data.compat import load_data_dict
from tip_tpu_torch.data.decagon import (
    DP_UNSHIFTED, et_list_by_nnz_band, has_reference_data, load_decagon_raw,
)
from tip_tpu_torch.data.preprocess import preprocess_decagon
from tip_tpu_torch.train.loop import train

RAW_KW = dict(n_drug=150, n_prot=64, n_et=5, pairs_per_et=120, n_pp_pairs=200,
              n_dp=120, seed=3)
NARROW = dict(prot_drug_dim=8, n_embed=16, n_hid1=16, n_hid2=8, num_base=8,
              pp_hid1=16, pp_hid2=8)


def assert_graphs_identical(a, b):
    """Every field of two TriGraphData (either package's) equal, dtype and
    shape included."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if hasattr(x, "edge_index"):
            pairs = [(getattr(x, k), getattr(y, k), f"{f.name}.{k}")
                     for k in ("edge_index", "edge_type", "range_list")]
        elif x is None:
            assert y is None, f.name
            continue
        elif not isinstance(x, np.ndarray):
            assert x == y, f.name
            continue
        else:
            pairs = [(x, y, f.name)]
        for u, v, what in pairs:
            assert u.dtype == v.dtype and u.shape == v.shape, what
            assert np.array_equal(u, v), what


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _band_raw_dir(tmp_path):
    """Raw CSVs with relations of 1 to 12 pairs (2 to 24 symmetric nnz)."""
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    rng = np.random.default_rng(4)
    rows = ["d1,d2,se,name"]
    for t in range(12):
        for _ in range(t + 1):
            i, j = rng.choice(20, 2, replace=False)
            rows.append(f"CID{i:09d},CID{j:09d},C{t:07d},se{t}")
    (raw_dir / "bio-decagon-combo.csv").write_text("\n".join(rows) + "\n")
    (raw_dir / "bio-decagon-ppi.csv").write_text("g1,g2\n10,11\n11,12\n")
    (raw_dir / "bio-decagon-targets.csv").write_text(
        "d,g\nCID000000001,11\nCID000000002,12\n")
    return str(raw_dir)


def test_preprocess_outputs_byte_equal(tmp_path):
    """Both packages' preprocess_decagon on tests/test_preprocess.py's CSVs
    (a mirrored duplicate, a target gene outside the PPI) write the same
    files, byte for byte, and return the same counts; the port writes one
    file more, the marker DP_UNSHIFTED (data/decagon.py)."""
    raw_dir = str(tmp_path / "raw")
    _write_raw(raw_dir)
    info = preprocess_decagon(raw_dir, str(tmp_path / "port"))
    assert info == j_preprocess(raw_dir, str(tmp_path / "jax"))
    assert info == (3, 3, 2, 2)
    port, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted([*jax_files, DP_UNSHIFTED])
    assert {"graph_info.pkl", os.path.join("index_map", "drug-map.pkl"),
            os.path.join("sym_adj", "drug-sparse-adj", "type_1.npz")} \
        <= set(port)
    for k in jax_files:
        assert port[k] == jax_files[k], k


def test_preprocessed_targets_load_on_their_own_drug_and_protein(tmp_path):
    """preprocess_decagon then load_decagon_raw keeps each drug-protein
    edge on its own drug and protein, drug 0 and protein 0 included (the
    CSVs' first drug targets their first protein).  Without the marker, as
    on the reference's shipped data, the loader applies the reference's -1
    shift and equals the JAX package's loader; the cache keys the two
    graphs apart and keeps the JAX package's name for the shifted one."""
    raw_dir, out = str(tmp_path / "raw"), str(tmp_path / "out")
    _write_raw(raw_dir)
    preprocess_decagon(raw_dir, out)
    maps = {}
    for name in ("drug-map", "protein-map"):
        with open(os.path.join(out, "index_map", f"{name}.pkl"), "rb") as f:
            maps[name] = pickle.load(f)
    with open(os.path.join(raw_dir, "bio-decagon-targets.csv")) as f:
        targets = [line.split(",") for line in f.read().splitlines()[1:]]
    want = {(maps["protein-map"][int(g)], maps["drug-map"][int(d[3:])])
            for d, g in targets if int(g) in maps["protein-map"]}
    assert (0, 0) in want and len(want) == 2

    raw = load_decagon_raw(out, et_list=[0, 1])
    assert raw.dp_shift == 0
    assert raw.dp_edge_index.dtype == np.int32
    assert set(zip(*raw.dp_edge_index.tolist())) == want

    os.remove(os.path.join(out, DP_UNSHIFTED))
    shifted = load_decagon_raw(out, et_list=[0, 1])
    jraw = jdata.load_decagon_raw(out, et_list=[0, 1])
    assert shifted.dp_shift == 1
    assert np.array_equal(shifted.dp_edge_index, jraw.dp_edge_index)
    assert np.array_equal(shifted.dp_edge_index, raw.dp_edge_index - 1)
    assert tcache._fingerprint(shifted, 0.9, 5) == \
        jcache._fingerprint(jraw, 0.9, 5)
    assert tcache._fingerprint(raw, 0.9, 5) != \
        tcache._fingerprint(shifted, 0.9, 5)


def test_preprocess_roundtrip(tmp_path):
    """tests/test_preprocess.py's checks on the port's outputs."""
    raw_dir, out_dir = str(tmp_path / "raw"), str(tmp_path / "out")
    _write_raw(raw_dir)
    assert preprocess_decagon(raw_dir, out_dir) == (3, 3, 2, 2)
    adj = os.path.join(out_dir, "sym_adj")
    a0 = sp.load_npz(os.path.join(adj, "drug-sparse-adj", "type_0.npz"))
    assert (a0 != a0.T).nnz == 0 and a0.nnz == 4
    a1 = sp.load_npz(os.path.join(adj, "drug-sparse-adj", "type_1.npz"))
    assert a1.nnz == 2 and a1.max() == 1.0  # the mirrored duplicate
    pp = sp.load_npz(os.path.join(adj, "protein-sparse-adj.npz"))
    assert (pp != pp.T).nnz == 0 and pp.nnz == 6
    dp = sp.load_npz(os.path.join(adj, "drug-protein-sparse-adj.npz"))
    assert dp.shape == (3, 3) and dp.nnz == 2  # the outside target dropped
    assert has_reference_data(out_dir)
    assert not has_reference_data(str(tmp_path / "raw"))


def test_et_list_by_nnz_band_identical(tmp_path):
    raw_dir = _band_raw_dir(tmp_path)
    out_dir = str(tmp_path / "out")
    preprocess_decagon(raw_dir, out_dir)
    for low, high in ((0, 100), (4, 13), (9, 10), (30, 40)):
        got, want = et_list_by_nnz_band(low, high, out_dir), \
            j_band(low, high, out_dir)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want), (low, high)
    band = et_list_by_nnz_band(4, 13, out_dir)
    assert 0 < len(band) < 12
    traw = load_decagon_raw(out_dir, et_list=band)
    jraw = jdata.load_decagon_raw(out_dir, et_list=band)
    for a, b in zip(traw.dd_pair_list, jraw.dd_pair_list):
        assert np.array_equal(a, b)


def test_load_data_dict_identical(tmp_path):
    """tests/test_compat.py's reference pickle: the port's TriGraphData
    equals the JAX package's field for field, and the round trip holds."""
    path = str(tmp_path / "data_dict.pkl")
    want = _make_reference_pickle(path)
    got = load_data_dict(path)
    assert_graphs_identical(got, j_load_data_dict(path))
    assert (got.n_drug, got.n_prot, got.n_et) == \
        (want.n_drug, want.n_prot, want.n_et)
    for k in ("dd_train_deg", "dd_train_keys", "dp_edge_index"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert np.array_equal(got.dd_train.edge_index, want.dd_train.edge_index)
    assert got.d_norm is None  # all-ones d_norm collapses to the no-op path


def test_load_data_dict_keeps_a_real_d_norm(tmp_path):
    path = str(tmp_path / "data_dict.pkl")
    _make_reference_pickle(path)
    with open(path, "rb") as f:
        d = pickle.load(f)
    d["d_norm"] = torch.arange(1, d["n_drug"] + 1, dtype=torch.float32)
    with open(path, "wb") as f:
        pickle.dump(d, f)
    got = load_data_dict(path)
    assert got.d_norm.dtype == np.float32
    assert np.array_equal(got.d_norm, np.arange(1, d["n_drug"] + 1))
    assert_graphs_identical(got, j_load_data_dict(path))


def test_loaded_graph_trains(tmp_path):
    path = str(tmp_path / "data_dict.pkl")
    _make_reference_pickle(path)
    data = load_data_dict(path)
    _, result = train(ModelConfig(mode="cat", **NARROW),
                      TrainConfig(epochs=1), data, device="cpu")
    assert np.isfinite(result["history"][0]["loss"])
    assert result["per_relation"]["auprc"].shape == (data.n_et,)


@pytest.fixture()
def raws():
    return jdata.synthetic_trigraph(**RAW_KW), tpack.synthetic_trigraph(**RAW_KW)


def test_cached_trigraph_cold_then_warm(tmp_path, raws, monkeypatch):
    """A cold build equals build_trigraph and leaves only the cache file;
    a warm load equals the cold build and builds nothing."""
    _, raw = raws
    d = str(tmp_path / "cache")
    cold = tcache.cached_trigraph(raw, 0.9, 5, cache_dir=d)
    assert_graphs_identical(cold, tpack.build_trigraph(raw, 0.9, 5))
    assert os.listdir(d) == [f"trigraph_{tcache._fingerprint(raw, 0.9, 5)}.npz"]

    def no_build(*a, **k):
        raise AssertionError("the warm load rebuilt the graph")

    monkeypatch.setattr(tcache, "build_trigraph", no_build)
    assert_graphs_identical(tcache.cached_trigraph(raw, 0.9, 5, cache_dir=d),
                            cold)


def test_cached_trigraph_reads_tip_cache_dir(tmp_path, raws, monkeypatch):
    _, raw = raws
    monkeypatch.setenv("TIP_CACHE_DIR", str(tmp_path / "env"))
    tcache.cached_trigraph(raw, 0.9, 5)
    assert len(os.listdir(tmp_path / "env")) == 1
    monkeypatch.delenv("TIP_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert tcache.default_cache_dir() == str(
        tmp_path / "home" / ".cache" / "tip_tpu_torch")


@pytest.mark.parametrize("broken", ["garbage", "truncated"])
def test_cached_trigraph_rebuilds_a_broken_file(tmp_path, raws, broken):
    _, raw = raws
    d = tmp_path / "cache"
    name = f"trigraph_{tcache._fingerprint(raw, 0.9, 5)}.npz"
    if broken == "garbage":
        d.mkdir()
        (d / name).write_bytes(b"not an npz")
    else:
        tcache.cached_trigraph(raw, 0.9, 5, cache_dir=str(d))
        whole = (d / name).read_bytes()
        (d / name).write_bytes(whole[:len(whole) // 2])
    got = tcache.cached_trigraph(raw, 0.9, 5, cache_dir=str(d))
    assert_graphs_identical(got, tpack.build_trigraph(raw, 0.9, 5))
    assert os.listdir(d) == [name]


@pytest.mark.parametrize("writer", ["tip_tpu", "tip_tpu_torch"])
def test_cache_file_loads_in_the_other_package(tmp_path, raws, monkeypatch,
                                               writer):
    """The same fingerprint names the file in both packages, and an npz
    written by either loads in the other without a rebuild."""
    jraw, traw = raws
    assert jcache._fingerprint(jraw, 0.9, 5) == tcache._fingerprint(traw, 0.9, 5)
    d = str(tmp_path / "cache")
    pkgs = {"tip_tpu": (jcache, jraw), "tip_tpu_torch": (tcache, traw)}
    (wmod, wraw), = [v for k, v in pkgs.items() if k == writer]
    (rmod, rraw), = [v for k, v in pkgs.items() if k != writer]
    written = wmod.cached_trigraph(wraw, 0.9, 5, cache_dir=d)

    def no_build(*a, **k):
        raise AssertionError("the cache file did not load")

    monkeypatch.setattr(rmod, "build_trigraph", no_build)
    assert_graphs_identical(rmod.cached_trigraph(rraw, 0.9, 5, cache_dir=d),
                            written)
