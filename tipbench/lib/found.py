"""The files of a cell, found by the names in BENCHMARK.json: a module
``tipbench/<kind>/<name>.py`` (a driver, a metric's reader, a generator,
a model's reference or operation count), loaded from its path, so that a
name may hold dots."""

from __future__ import annotations

import importlib.util
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(kind: str, name: str):
    """tipbench/<kind>/<name>.py as a module (loaded once a process)."""
    key = f"tipbench_{kind}_{name}".replace("/", "_").replace(".", "_") \
        .replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
