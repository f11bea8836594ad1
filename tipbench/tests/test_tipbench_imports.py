"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX package
(``tip_tpu``), compared by each module's whole top-level name:
``tip_tpu_torch`` passes."""

import ast
import os
import subprocess
import sys

from tipbench import run
from tipbench.tests.tiny import ROOT

BENCH = os.path.join(ROOT, "tipbench")


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    seen = set()
    for d, _, names in os.walk(BENCH):
        for name in names:
            if name.endswith(".py"):
                for mod in imported(os.path.join(d, name)):
                    seen.add(mod.split(".")[0])
    assert "tip_tpu_torch" in seen
    assert not seen & set(run.FORBIDDEN), seen & set(run.FORBIDDEN)


def test_top_level_names_compared_whole():
    mods = dict(sys.modules)
    try:
        sys.modules["tip_tpu_torch_probe"] = object()
        assert "tip_tpu_torch_probe" not in run.forbidden_modules()
        sys.modules["tip_tpu.probe"] = object()
        assert "tip_tpu.probe" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_a_run_loads_nothing_forbidden():
    """Every driver, metric and the reference imported in a fresh process
    leaves no forbidden module behind."""
    code = (
        "import os, sys; sys.path.insert(0, sys.argv[1]);"
        "from tipbench import run;"
        "from tipbench.reference import follow;"
        "[run.load_module(k, n[:-3]) for k in ('drivers', 'metrics')"
        " for n in os.listdir(os.path.join(run.BENCH_DIR, k))"
        " if n.endswith('.py') and n != '__init__.py'];"
        "import tip_tpu_torch.train.loop, tip_tpu_torch.models.runner;"
        "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, ROOT], check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"
