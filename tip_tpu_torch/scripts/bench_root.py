"""The ``--root DIR`` option of the bench scripts (dense_bce_bench.py,
tns_bench.py): they import the ``tip_tpu_torch`` package of another
checkout (another commit unpacked there) in place of this one's, so that
two versions are timed on one card in one session, and use this
checkout's chip_smoke.py for the checks, timing and profile.  A bench
imports this module from its own directory, which is first on sys.path
when it runs as a file (``python3 tip_tpu_torch/scripts/<bench>.py``),
before anything imports the package.
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import sys

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def add_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--root", default=None,
                        help="a checkout whose tip_tpu_torch is timed "
                             "(default: this one)")


def import_package(root) -> pathlib.Path:
    """Put the checkout ``root`` (None: this one) first on sys.path and
    import its tip_tpu_torch; return the resolved root."""
    root = pathlib.Path(root or CHECKOUT).resolve()
    sys.path.insert(0, str(root))
    import tip_tpu_torch

    if not pathlib.Path(tip_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"tip_tpu_torch came from {tip_tpu_torch.__file__}, "
                         f"not {root}: run the bench as a file")
    return root


def chip_smoke():
    """This checkout's chip_smoke.py, as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
