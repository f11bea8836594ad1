"""The operation and byte counts behind every roofline and mfu, against
counts worked by hand at a tiny shape."""

import pytest

from tipbench.counts import peaks, work

TIP = {"model": "tip_cat", "n_drug": 3, "n_prot": 4, "n_et": 2,
       "n_train": 6, "e_pp": 10, "e_dp": 5, "dd_n_chunks": 2,
       "n_embed": 2, "prot_drug_dim": 1, "n_hid1": 2, "n_hid2": 2,
       "num_base": 2, "pp_hid1": 2, "pp_hid2": 1}
DR = {"model": "dr_nn", "n_drug": 3, "n_prot": 0, "n_et": 2, "n_train": 6,
      "e_pp": 0, "e_dp": 0, "dd_n_chunks": 2, "n_embed": 2, "n_hid1": 2,
      "n_hid2": 2, "num_base": 2, "nn_decoder_l1_dim": 2}


def test_tip_step_flops():
    # layer 1, d 3 -> 2: 6*3 + 2*2*2*3*3 + 2*2*3*3*2 + 2*3*3*2 = 18+72+72+36
    # layer 2, d 2 -> 2: 6*2 + 2*2*2*3*2 + 2*2*3*2*2 + 2*3*2*2 = 12+48+48+24
    rgcn = 198 + 132
    pp = 2 * 10 * 3 + 2 * 4 * 2 * 1  # 60 + 16
    hier = 5 * 1 + 2 * 3 * 1 * 1  # 5 + 6
    dec = 2 * 6 * 4 * 2  # 96
    assert work.step_flops(TIP) == 3 * (rgcn + pp + hier + dec)


def test_dr_nn_step_flops():
    # layer 1, d 2 -> 2 and layer 2, d 2 -> 2: 132 each
    dec = 2 * 6 * 4 * 2 + 2 * 2 * 3 * 2 * 2  # 96 + 48
    assert work.step_flops(DR) == 3 * (132 + 132 + dec)


def test_b1_bound():
    # one 128-block row: strips 2 x 128 x 128 int8; 9 cells a relation
    nbytes = 2 * 128 * 128 + 4 * (2 * 2 + 3 * 2 + 2 * 8) + 4 * (1 + 4 + 6)
    want = max(nbytes / 3.35e12, 3 * 18 * 12 / 495e12, 18 * 20 / 67e12)
    assert work.b1_bound_s(TIP) == pytest.approx(want, rel=1e-12)


def test_b2_bound():
    nbytes = 4 * 18 + 4 * (4 + 6 + 6) + 4 * (1 + 4 + 6)
    want = max(nbytes / 3.35e12, 3 * 18 * 12 / 495e12, 18 * 20 / 67e12)
    assert work.b2_bound_s(TIP) == pytest.approx(want, rel=1e-12)


def test_b3_bound():
    args = 2 * 2 * 2 + 2 * 3 * 2  # w1, w2 [2, 2]; h1, h2 [3, 2]
    nbytes = 18 + 4 * 6 + 4 * args + 4 * (1 + args)
    flops = 25 * 18 + 8 * 2 * 3 * 2
    want = max(nbytes / 3.35e12, flops / 67e12)
    assert work.b3_bound_s(DR) == pytest.approx(want, rel=1e-12)


def test_b4_bound():
    edges = 8 * 6 + 4 * 2
    want = 0.0
    for d in (3, 2):
        fwd = edges + 4 * 3 * d + 4 * 2 * d * 3
        want += 2 * max(fwd / 3.35e12, 6 * d / 67e12)
    assert work.b4_bound_s(TIP) == pytest.approx(want, rel=1e-12)


def test_peaks():
    assert peaks.bound_s(3.35e12, 0) == 1.0
    assert peaks.bound_s(0, 67e12) == 1.0
    assert peaks.tensor_core_bound_s(0, 1, 1) == 20 / 67e12
