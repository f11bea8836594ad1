"""Decagon's operations a step (counts/work.py: the reference algorithm,
edge-proportional, forward and backward as 3 x the forward), the widths
h1, h2 of the configuration:

  * layer 1 on one-hot inputs: each relation's D-D messages over its train
    edges and self loops, 2 (E + R n) h1; P-P, 2 E_pp h1 (self loops in
    E_pp); drug-protein both ways, 2 x 2 E_dp h1;
  * layer 2, drug rows: the relations' transforms 2 R n h1 h2 and their
    messages 2 (E + R n) h2; the proteins' transform 2 n_prot h1 h2 and
    their messages 2 E_dp h2;
  * DEDICOM: each relation's row operand ((z d_t) R) d_t for every drug,
    2 R n (h2^2 + h2), then a dot a scored edge (one positive and one
    negative a train edge), 2 h2."""


def step_flops(s: dict) -> float:
    n, r, e = s["n_drug"], s["n_et"], s["n_train"]
    h1, h2 = s["n_hid1"], s["n_hid2"]
    e_pp, e_dp, n_prot = s["e_pp"], s["e_dp"], s["n_prot"]
    layer1 = 2.0 * (e + r * n) * h1 + 2.0 * e_pp * h1 + 4.0 * e_dp * h1
    layer2 = (2.0 * r * n * h1 * h2 + 2.0 * (e + r * n) * h2
              + 2.0 * n_prot * h1 * h2 + 2.0 * e_dp * h2)
    dec = 2.0 * r * n * (h2 * h2 + h2) + 2 * e * 2.0 * h2
    return 3 * (layer1 + layer2 + dec)
