"""The port's drug-structure similarity (tip_tpu_torch/data/drug_structure.py)
against the JAX package: tests/test_drug_structure.py's cases on the port,
and the Dice matrix bit-equal to the JAX package's on the same counts."""

import csv
import glob
import os
import shutil

import numpy as np
import pytest

from tip_tpu.data import drug_structure as jds
from tests.test_drug_structure import BENZENE, ETHANOL, REF_SDF_DIR
from tip_tpu_torch.data.drug_structure import (
    calculate_drug_similarity,
    dice_similarity_matrix,
    fold_fingerprints,
    morgan_fingerprint,
    parse_molfile,
)


def _dice(counts, block):
    return dice_similarity_matrix(counts, block=block, device="cpu")


def test_parse_molfile_ethanol():
    mol = parse_molfile(ETHANOL)
    assert mol.symbols == ["C", "C", "O"]
    assert mol.bonds.shape == (2, 3)
    assert list(mol.bonds[0]) == [0, 1, 1]


def test_parse_charge_property_line():
    mol = parse_molfile(ETHANOL.replace("M  END", "M  CHG  1   3  -1\nM  END"))
    assert mol.charges[2] == -1


def test_fingerprint_identical_molecules_identical():
    a = morgan_fingerprint(parse_molfile(ETHANOL))
    b = morgan_fingerprint(parse_molfile(ETHANOL))
    assert a == b and len(a) > 0
    assert a == jds.morgan_fingerprint(jds.parse_molfile(ETHANOL))


def test_fingerprint_distinguishes_molecules():
    a = morgan_fingerprint(parse_molfile(ETHANOL))
    b = morgan_fingerprint(parse_molfile(BENZENE))
    assert a != b
    assert b == jds.morgan_fingerprint(jds.parse_molfile(BENZENE))


def test_benzene_symmetry_single_radius0_id():
    # the six aromatic carbons share one invariant; the radius-1
    # environments are deduplicated by bond set
    fp = morgan_fingerprint(parse_molfile(BENZENE))
    assert sorted(fp.values(), reverse=True)[0] == 6


def test_dice_matrix_properties():
    fps = [morgan_fingerprint(parse_molfile(m))
           for m in (ETHANOL, BENZENE, ETHANOL)]
    sim = _dice(fold_fingerprints(fps, n_bits=1 << 12), block=8)
    assert sim.shape == (3, 3) and sim.dtype == np.float32
    np.testing.assert_allclose(np.diag(sim), 1.0, atol=1e-6)
    np.testing.assert_allclose(sim, sim.T, atol=1e-6)
    np.testing.assert_allclose(sim[0, 2], 1.0, atol=1e-6)  # identical mols
    assert sim[0, 1] < 0.5  # ethanol vs benzene


def test_dice_matches_exact_counted_dice():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 5, size=(7, 64)).astype(np.float32)
    sim = _dice(c, block=4)
    for i in range(7):
        for j in range(7):
            num = 2.0 * np.minimum(c[i], c[j]).sum()
            np.testing.assert_allclose(sim[i, j], num / (c[i].sum() + c[j].sum()),
                                       rtol=1e-5)


@pytest.mark.parametrize("block", [64, 256, 1024])
def test_dice_bit_equal_to_jax(block):
    """300 drugs, more than one of the JAX package's 256-row blocks and
    several of the port's; sparse small counts as folded fingerprints
    give, a row of zeros among them (the max(denominator, 1) guard)."""
    rng = np.random.default_rng(1)
    c = np.where(rng.random((300, 256)) < 0.1,
                 rng.integers(1, 7, (300, 256)), 0).astype(np.float32)
    c[17] = 0
    got, want = _dice(c, block), jds.dice_similarity_matrix(c)
    assert got.dtype == want.dtype and got.shape == want.shape == (300, 300)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fold_fingerprints_identical():
    fps = [morgan_fingerprint(parse_molfile(m)) for m in (ETHANOL, BENZENE)]
    fps.append({2 ** 62 + 5: 3, 7: 1})
    for n_bits in (64, 1 << 15):
        got, want = fold_fingerprints(fps, n_bits), jds.fold_fingerprints(fps, n_bits)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_calculate_drug_similarity_matches_jax(tmp_path):
    """A directory of molfiles (one unparseable, skipped by both) gives the
    JAX package's ids, matrix and CSV."""
    sdf = tmp_path / "sdf"
    sdf.mkdir()
    (sdf / "DB0001.sdf").write_text(ETHANOL + "$$$$\n")
    (sdf / "DB0002.sdf").write_text(BENZENE + "\n$$$$\n")
    (sdf / "DB0003.sdf").write_text(ETHANOL.replace("  1  2  1  0", "  1  2  2  0"))
    (sdf / "DB0004.sdf").write_text("broken\n")
    got = calculate_drug_similarity(str(sdf), output_file=str(tmp_path / "a.csv"),
                                    device="cpu")
    want = jds.calculate_drug_similarity(str(sdf),
                                         output_file=str(tmp_path / "b.csv"))
    assert list(got["ids"]) == list(want["ids"]) == ["DB0001", "DB0002", "DB0003"]
    assert np.array_equal(got["similarity"], want["similarity"])
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


@pytest.mark.skipif(not os.path.isdir(REF_SDF_DIR), reason="no reference SDFs")
def test_real_drugbank_sdf_end_to_end(tmp_path):
    sub = tmp_path / "sdf"
    sub.mkdir()
    for p in sorted(glob.glob(os.path.join(REF_SDF_DIR, "*.sdf")))[:12]:
        shutil.copy(p, sub)
    out = tmp_path / "sim.csv"
    res = calculate_drug_similarity(str(sub), output_file=str(out), device="cpu")
    n = len(res["ids"])
    assert n >= 10
    sim = res["similarity"]
    np.testing.assert_allclose(np.diag(sim), 1.0, atol=1e-6)
    assert ((sim >= -1e-6) & (sim <= 1 + 1e-6)).all()
    assert sim[~np.eye(n, dtype=bool)].mean() < 0.9
    with open(out) as f:
        rows = list(csv.reader(f))
    assert len(rows) == n + 1 and rows[0][1:] == list(res["ids"])
