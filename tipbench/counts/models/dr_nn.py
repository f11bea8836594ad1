"""DR-NN's operations a step (counts/work.py): two R-GCN layers on the
embedding; the NN decoder, 4 l1 a scored edge (one positive and one
negative a train edge) plus 2 x 2 n d l1 for the hiddens."""

from tipbench.counts.work import rgcn_layer_flops


def step_flops(s: dict) -> float:
    n, e = s["n_drug"], s["n_train"]
    rgcn = (rgcn_layer_flops(s, s["n_embed"], s["n_hid1"])
            + rgcn_layer_flops(s, s["n_hid1"], s["n_hid2"]))
    l1 = s["nn_decoder_l1_dim"]
    dec = 2 * e * 4.0 * l1 + 2 * 2.0 * n * s["n_hid2"] * l1
    return 3 * (rgcn + dec)
