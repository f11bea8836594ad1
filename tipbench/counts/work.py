"""Operations and bytes of a training step, from the cell's shapes.

``shape`` is the run's summary of sizes (run.py:shape_of): n_drug, n_prot,
n_et, n_train (directed D-D train edges), e_pp (normalized P-P edges, self
loops included), e_dp (drug-protein edges), dd_n_chunks, and the
configuration's widths.

step_flops: the reference algorithm's floating-point operations a step,
forward and backward (3 x the forward), no recomputed work: what an
edge-proportional sparse implementation must do, whatever layout the
program runs (rewritten from the algorithmic branch of bench.py's
``_step_flops``, without its dense-formulation count).  Each model's
formula is a file ``tipbench/counts/models/<model>.py`` (found by the
configuration's ``model``), built from the layer counts here.  Forward,
per R-GCN layer (d_in -> d_out, B bases, R relations, n drugs, E edges):

    E d_in                 neighbour sums
    + 2 R B n d_in         basis mixing of the per-relation sums
    + 2 B n d_in d_out     basis projections
    + 2 n d_in d_out       root term

*_bound_s: the least time of one step's work of a kernel (counts/peaks.py):
each input byte read once and each output byte written once, operations at
the fastest rate that keeps the kernel's stated precision.
"""

from __future__ import annotations

from tipbench.counts.peaks import bound_s, tensor_core_bound_s
from tipbench.lib.found import load_module

SYM_BLOCK = 128


def rgcn_layer_flops(s: dict, d_in: int, d_out: int) -> float:
    """One R-GCN layer's forward operations."""
    n, r, b = s["n_drug"], s["n_et"], s["num_base"]
    return (s["n_train"] * d_in + 2.0 * r * b * n * d_in
            + 2.0 * b * n * d_in * d_out + 2.0 * n * d_in * d_out)


def step_flops(s: dict) -> float:
    """The step's operations by the model's own formula."""
    return load_module("counts/models", s["model"]).step_flops(s)


def b1_bound_s(s: dict) -> float:
    """Kernel B1, the fused symmetric-strip pass (loss, dw, dz): reads the
    int8 strips [R, 128, NB * 128], w [R, d], z [n, d], the thresholds
    [R, 8] int32; writes the loss, dw, dz; the cells of the upper block
    triangle inside n x n."""
    n, r, d = s["n_drug"], s["n_et"], s["n_hid2"]
    nb = -(-n // SYM_BLOCK)
    strips = r * SYM_BLOCK * nb * (nb + 1) // 2 * SYM_BLOCK
    cells = r * sum(min(SYM_BLOCK, n - i * SYM_BLOCK) * (n - i * SYM_BLOCK)
                    for i in range(nb))
    nbytes = strips + 4 * (r * d + n * d + r * 8) + 4 * (1 + r * d + n * d)
    return tensor_core_bound_s(nbytes, cells, d)


def b2_bound_s(s: dict) -> float:
    """Kernel B2 on float32 pages [R, n, n] (loss, dw, dz), thresholds
    [R, 3] int32; every cell of the pages."""
    n, r, d = s["n_drug"], s["n_et"], s["n_hid2"]
    nbytes = (4 * r * n * n + 4 * (r * d + n * d + r * 3)
              + 4 * (1 + r * d + n * d))
    return tensor_core_bound_s(nbytes, r * n * n, d)


def b3_bound_s(s: dict) -> float:
    """Kernel B3 on uint8 pages [R, n, n] (loss and the gradients of w1,
    w2 [R, l1] and h1, h2 [n, l1]), thresholds [R, 3] int32; about 25
    float operations a cell (outer sum, softplus, sigmoid, counts, G, two
    running sums) and the 2 x 4 R n l1 contractions, all float32 on the
    SIMT units."""
    n, r, l1 = s["n_drug"], s["n_et"], s["nn_decoder_l1_dim"]
    args = 2 * r * l1 + 2 * n * l1
    nbytes = r * n * n + 4 * r * 3 + 4 * args + 4 * (1 + args)
    return bound_s(nbytes, 25.0 * r * n * n + 8.0 * r * n * l1)


def b4_bound_s(s: dict) -> float:
    """Kernel B4's work in one TIP-cat step on the chunked layout: the
    forward of both R-GCN layers (d = n_embed + prot_drug_dim, n_hid1) and
    the backward of both.  Forward: reads the valid edges' (src, dst)
    int32, the chunk types, x [n, d]; writes the sums [R, d, n]; E d adds.
    Backward: reads the edges, the chunk types, dP [R, d, n]; writes dx
    [n, d]; E d adds."""
    n, r, e = s["n_drug"], s["n_et"], s["n_train"]
    edges = 8 * e + 4 * s["dd_n_chunks"]
    total = 0.0
    for d in (s["n_embed"] + s["prot_drug_dim"], s["n_hid1"]):
        total += bound_s(edges + 4 * n * d + 4 * r * d * n, e * d)
        total += bound_s(edges + 4 * r * d * n + 4 * n * d, e * d)
    return total
