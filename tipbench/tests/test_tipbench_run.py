"""run.py on a machine without a card, and in a checkout that holds only
the benchmark's files: non-zero, and no result line."""

import os
import shutil
import subprocess
import sys

import pytest

from tipbench.tests.tiny import ROOT

ARGS = ["--workload", "tip_cat.decagon_strips", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def test_exits_nonzero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "tipbench/run.py", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "tipbench"), tmp_path / "tipbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "tipbench/run.py", *ARGS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
