"""BENCHMARK.json and the files every cell, configuration and metric is
found by, against the benchmark contract's shapes and characters."""

import json
import os
import re

import pytest

from tipbench import run
from tipbench.lib import check, found
from tipbench.tests.tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["command"] == ["python3", "tipbench/run.py"]
    assert b["paths"] == ["tipbench"]
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs():
    b = bench()
    names = [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"tipbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, "tipbench", "drivers",
                                           f"{cfg['driver']}.py"))
        # the model's plain reference and operation count, by its name
        ref = found.load_module("reference/models", cfg["model"])
        assert all(callable(getattr(ref, f)) for f in (
            "param_spec", "encode", "score", "dense_logits"))
        assert callable(found.load_module("counts/models",
                                          cfg["model"]).step_flops)


def test_workloads_find_their_files():
    b = bench()
    names = [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and one_line(w["why"])
        files = run.cell_files(b, w["name"])
        # every number is compared in every cell
        assert set(files["limits"]) == set(check.NUMBERS)
        assert files["traffic"]["dd_layout"] in (
            "strips", "strips_pages", "pages", "chunked")
        gen = found.load_module("generators",
                                files["traffic"]["graph"]["kind"])
        assert callable(gen.make)
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        e2e = {m["name"] for m in files["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert files["per_layer"]


def test_metrics():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    cells = {w["name"] for w in b["workloads"]}
    names = list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        assert set(m["workloads"]) <= cells
        # every cell that lists the metric reports the metric it moves
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved), m["name"]
        mod = run.load_module("metrics", m["name"])
        assert callable(mod.read)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_layers_match_perf_md():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in bench()["per_layer"]:
        assert f"**{m['layer']}**" in perf, m["layer"]


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits"])
def test_data_files_are_json(kind):
    d = os.path.join(ROOT, "tipbench", kind)
    for name in os.listdir(d):
        assert NAME.match(name[:-len(".json")]) and name.endswith(".json")
        with open(os.path.join(d, name)) as f:
            json.load(f)


def test_a_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="no generators named"):
        found.load_module("generators", "no_such_kind")
