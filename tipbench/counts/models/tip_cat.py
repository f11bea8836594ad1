"""TIP-cat's operations a step (counts/work.py): two R-GCN layers on
x = [embedding | hierarchy]; the P-P GCN, 2 E_pp d_out a layer on
identity features plus the 2 n_prot h1 h2 product of layer 2; the
hierarchy, E_dp d + 2 n d d_out; DistMult, 4 d a scored edge, one
positive and one negative scored a train edge."""

from tipbench.counts.work import rgcn_layer_flops


def step_flops(s: dict) -> float:
    n, e = s["n_drug"], s["n_train"]
    d_in1 = s["n_embed"] + s["prot_drug_dim"]
    rgcn = (rgcn_layer_flops(s, d_in1, s["n_hid1"])
            + rgcn_layer_flops(s, s["n_hid1"], s["n_hid2"]))
    pp = (2.0 * s["e_pp"] * (s["pp_hid1"] + s["pp_hid2"])
          + 2.0 * s["n_prot"] * s["pp_hid1"] * s["pp_hid2"])
    hier = s["e_dp"] * s["pp_hid2"] + 2.0 * n * s["pp_hid2"] * s["prot_drug_dim"]
    dec = 2 * e * 4.0 * s["n_hid2"]
    return 3 * (rgcn + pp + hier + dec)
