"""CompGCN's operations a step (counts/work.py: the reference algorithm,
edge-proportional, forward and backward as 3 x the forward), the widths
d0 = init_dim, d1 = gcn_dim of the configuration:

  * messages over |T| + |T^-1| = 2 (E + E_pp - n_prot + E_dp) triples (the
    D-D train edges, the P-P train edges less the normalisation's self
    loops, the drug-protein triples), each x_t * z_r, its norm and its add,
    3 d0;
  * the four [., d0] x [d0, d1] products: P_in W_I, P_out W_O, (X *
    z_loop) W_S over the N entities and Z W_rel over the 2K relations,
    with the self loop's composition N d0;
  * BN and tanh, 8 N d1;
  * DistMult as counts/models/tip_cat.py counts it: 4 d1 a scored edge, one
    positive and one negative a train edge."""


def step_flops(s: dict) -> float:
    n, e = s["n_drug"] + s["n_prot"], s["n_train"]
    d0, d1 = s["init_dim"], s["gcn_dim"]
    k = s["n_et"] + 2
    triples = e + s["e_pp"] - s["n_prot"] + s["e_dp"]
    messages = 2 * triples * 3.0 * d0
    products = 3 * 2.0 * n * d0 * d1 + 2.0 * (2 * k) * d0 * d1 + n * d0
    bn = 8.0 * n * d1
    dec = 2 * e * 4.0 * d1
    return 3 * (messages + products + bn + dec)
