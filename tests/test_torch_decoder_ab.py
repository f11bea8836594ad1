"""The port's decoder A/B entry point (tip_tpu_torch/scripts/decoder_ab.py)
on the CPU, at a small graph, with the plain versions of kernels B6-B10.

It reports, for the DistMult and the NN decoder, the forward and forward +
backward times of the v1, v2 and gather routes and each route's relative
error of the masked softplus sum against v1 (float32: the routes compute
the same sum in another order, so within 1e-5), plus the sampler and the
dense positive BCE; on the CPU it launches no kernel and says it timed by
the host clock.
"""

import json

import numpy as np
import pytest
import torch

from tip_tpu_torch import data, kernels
from tip_tpu_torch.data import build_trigraph, synthetic_trigraph
from tip_tpu_torch.scripts import decoder_ab


def _small_graph():
    return build_trigraph(synthetic_trigraph(), **decoder_ab.SPLIT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_ab_reports_every_route_on_the_cpu(dtype):
    kernels.reset_launch_counts()
    res = decoder_ab.decoder_ab(_small_graph(), dtype, "cpu", warmup=1, reps=1)
    assert (res["dtype"], res["device"], res["timer"]) == (dtype, "cpu",
                                                           "host clock")
    assert res["slots"] == res["n_chunks"] * res["chunk"] > res["valid_slots"]
    for decoder in ("distmult", "nn"):
        assert set(res[decoder]) == {"v1", "v2", "gather"}
        for row in res[decoder].values():
            assert row["fwd_ms"] > 0 and row["fwd_bwd_ms"] > 0
            assert np.isfinite(row["value"])
        assert res[decoder]["v1"]["rel_err_vs_v1"] == 0.0
        # v2 rounds at other points in bf16; the gather never rounds z
        tol = 1e-5 if dtype == "float32" else 1e-4
        for name in ("v2", "gather"):
            assert res[decoder][name]["rel_err_vs_v1"] <= tol, (decoder, name)
    assert res["sampler"]["ms"] > 0
    assert set(res["dense_pos_bce"]) == {"fwd_ms", "fwd_bwd_ms"}
    assert not any(res["launches"].values())


def test_decoder_ab_command_line_writes_out(tmp_path, monkeypatch):
    """``--synthetic --cpu --out``: the Decagon-shaped graph is swapped for
    a small one here; the JSON printed is the JSON written."""
    shapes = []

    def small(**shape):
        shapes.append(shape)
        return synthetic_trigraph()

    monkeypatch.setattr(data, "synthetic_trigraph", small)
    out = tmp_path / "ab.json"
    res = decoder_ab.main(["--synthetic", "--cpu", "--out", str(out)])
    assert shapes == [decoder_ab.DECAGON_SHAPE]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert (res["dtype"], res["warmup"], res["reps"]) == ("float32", 1, 1)


def test_decoder_ab_launches_per_route():
    """chip_smoke.py's exact launch counts: one forward for the agreement,
    then warmup + reps forwards and as many forward + backward pairs."""
    assert decoder_ab.launches_per_route(2, 10) == 37
    assert decoder_ab.launches_per_route(0, 1) == 4


def test_decoder_ab_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder_ab.main(["--synthetic"])
