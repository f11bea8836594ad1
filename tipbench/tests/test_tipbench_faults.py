"""A run with the timed path broken underneath comes out not correct, once
a fault the cells can have (lib/faults.py): the state left unchanged, half
of the batch left out with the mean over the rest, an answer altered where
it is produced; and the control, the reference in TF32 in the program's
place, fails the cell's limits.  On the CPU at a tiny graph, with the
limits committed for each cell."""

import pytest

from tipbench import calibrate, run
from tipbench.lib import check, faults
from tipbench.tests import tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "CACHE_DIR", str(tmp_path / "cache"))


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(workload, fault):
    with tiny.layout_of(workload):
        out = run.run(tiny.files(workload), seed=2**31 + 21, seconds=0,
                      trace=False, device="cpu", plant=faults.FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    files = tiny.files(workload)
    values = calibrate.control_numbers(files, 2**31 + 23, "cpu")
    ok, checks = check.judge(values, files["limits"])
    assert not ok, checks


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cells_on_the_card(workload):
    """The kernels' path at a tiny graph: correct, and a fault not."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with tiny.layout_of(workload):
        out = run.run(tiny.files(workload), seed=5, seconds=0, trace=False,
                      device="cuda")
        assert out["correct"], out["checks"]
        out = run.run(tiny.files(workload), seed=5, seconds=0, trace=False,
                      device="cuda", plant=faults.half_batch)
        assert not out["correct"], out["checks"]
