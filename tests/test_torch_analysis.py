"""The port's analysis layer (tip_tpu_torch/analysis) and the CLIs' --report
and --et-band against the JAX package: tests/test_analysis.py's cases on
the port, equal rows from both packages, and the GAF lookup by numeric
gene id that the JAX package misses."""

import json
import os
import pickle
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

from tip_tpu import analysis as janalysis
from tip_tpu.analysis import explain as jexplain
from tip_tpu.data.decagon import DEFAULT_DATA_DIR as J_DATA_DIR
from tip_tpu.data.decagon import has_reference_data as j_has_reference_data
from tests.test_analysis import _fake_per_rel
from tests.test_torch_data import _band_raw_dir
from tip_tpu_torch.analysis import (
    decagon_rank_comparison, load_side_effect_names, per_relation_table,
    save_report, top_bottom,
)
from tip_tpu_torch.analysis import explain, plots
from tip_tpu_torch.data.preprocess import preprocess_decagon

GAF_ROW = ["DB", "", "", "", "", "REF", "IEA", "", "P", "", "", "protein",
           "taxon:9606", "20240101", "DB"]


def _gaf_line(obj_id, symbol, term, qualifier=""):
    row = list(GAF_ROW)
    row[1], row[2], row[3], row[4] = obj_id, symbol, qualifier, term
    return "\t".join(row)


def _mini_gaf_obo(tmp_path):
    """tests/test_analysis.py's fixtures: 40 background genes all carry
    GO:0000002, genes 0-4 also GO:0000001; a NOT row to ignore."""
    lines = ["!gaf-version: 2.2"]
    for i in range(40):
        for t in ["GO:0000002"] + (["GO:0000001"] if i < 5 else []):
            lines.append(_gaf_line(f"ID{i}", f"G{i}", t))
    lines.append(_gaf_line("IDx", "G39", "GO:0000001", "NOT"))
    gaf = tmp_path / "mini.gaf"
    gaf.write_text("\n".join(lines) + "\n")
    obo = tmp_path / "mini.obo"
    obo.write_text(
        "format-version: 1.2\n\n[Term]\nid: GO:0000001\n"
        "name: study process\nnamespace: biological_process\n\n"
        "[Term]\nid: GO:0000002\nname: common process\n"
        "namespace: biological_process\nalt_id: GO:0000099\n\n")
    return str(gaf), str(obo)


def test_table_and_ranking(tmp_path):
    per = _fake_per_rel()
    rows = per_relation_table(per, et_ids=list(range(6)))
    assert len(rows) == 5  # invalid relation dropped
    assert rows == janalysis.per_relation_table(per, et_ids=list(range(6)))
    best, worst = top_bottom(rows, k=2)
    assert best[0]["auprc"] >= best[1]["auprc"] >= worst[1]["auprc"]
    assert (best, worst) == janalysis.top_bottom(rows, k=2)
    for name in ("report.json", "report.csv"):
        save_report(str(tmp_path / "port" / name), rows, {"auprc": 0.9})
        janalysis.save_report(str(tmp_path / "jax" / name), rows, {"auprc": 0.9})
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_names_and_ranks_match_jax_on_written_maps(tmp_path):
    """Side-effect names and Decagon's best/worst ranks from id maps of
    preprocess_decagon plus a name map, equal to the JAX package's; ids
    without a name fall back to type_{id}."""
    out = str(tmp_path / "out")
    preprocess_decagon(_band_raw_dir(tmp_path), out)
    with open(os.path.join(out, "index_map", "combo_map.pkl"), "rb") as f:
        combo = pickle.load(f)
    names = {code: f"se {code}" for code in list(combo)[:8]}
    with open(os.path.join(out, "index_map", "combo-name-map.pkl"), "wb") as f:
        pickle.dump(names, f)
    et_ids = np.arange(12)
    got = load_side_effect_names(et_ids, out)
    assert got == janalysis.load_side_effect_names(et_ids, out)
    assert got[:8] == [f"se {c}" for c in list(combo)[:8]]
    assert got[8:] == [f"type_{t}" for t in range(8, 12)]
    per = {"auprc": np.linspace(0, 1, 12), "valid": np.ones(12, bool)}
    assert decagon_rank_comparison(per, et_ids, out) == \
        janalysis.decagon_rank_comparison(per, et_ids, out)


@pytest.mark.skipif(not j_has_reference_data(), reason="needs reference data")
def test_names_and_decagon_ranks():
    from tip_tpu_torch.data.decagon import default_et_list

    et_ids = default_et_list(J_DATA_DIR)
    names = load_side_effect_names(et_ids, J_DATA_DIR)
    assert len(names) == len(et_ids)
    assert sum(n.startswith("type_") for n in names) < 10
    per = {"auprc": np.linspace(0, 1, len(et_ids)),
           "valid": np.ones(len(et_ids), bool)}
    cmp = decagon_rank_comparison(per, et_ids, J_DATA_DIR)
    assert cmp["n_relations"] == len(et_ids)
    assert len(cmp["decagon_best_ranks"]) > 0


def test_go_enrichment_machinery(tmp_path):
    """GAF/OBO parsing + Fisher-exact enrichment: a term concentrated in
    the study set ranks first with a small p, a uniform term does not; the
    rows equal the JAX package's."""
    gaf, obo = _mini_gaf_obo(tmp_path)
    anno = explain.parse_gaf(gaf)
    assert anno["G0"] == {"GO:0000001", "GO:0000002"}
    assert "GO:0000001" not in anno["G39"]  # NOT row skipped
    terms = explain.parse_obo(obo)
    assert terms == jexplain.parse_obo(obo)
    assert terms["GO:0000001"]["name"] == "study process"
    assert terms["GO:0000099"]["name"] == "common process"  # alt_id alias

    study = [f"G{i}" for i in range(5)]
    rows = explain.go_enrichment(study, anno, terms)
    assert rows == jexplain.go_enrichment(study, jexplain.parse_gaf(gaf), terms)
    assert rows[0]["go_id"] == "GO:0000001"
    assert rows[0]["p"] < 1e-4 and rows[0]["n_study"] == 5
    uniform = [r for r in rows if r["go_id"] == "GO:0000002"][0]
    assert uniform["p"] == 1.0
    assert rows[0]["q"] <= uniform["q"]
    # a study gene named by its object id counts once, as by its symbol
    both = explain.go_enrichment(study + ["ID0", "ID1"], anno, terms)
    assert both == rows


def _decagon_dir(tmp_path, gene_ids):
    """A preprocessed-data directory: two drugs, relation 0 between them,
    both targeting proteins 1 and 2 of the map, whose gene ids are
    ``gene_ids``."""
    out = tmp_path / "data"
    (out / "sym_adj" / "drug-sparse-adj").mkdir(parents=True)
    (out / "index_map").mkdir()
    sp.save_npz(str(out / "sym_adj" / "drug-sparse-adj" / "type_0.npz"),
                sp.coo_matrix(([1.0, 1.0], ([0, 1], [1, 0])), shape=(2, 2)))
    sp.save_npz(str(out / "sym_adj" / "drug-protein-sparse-adj.npz"),
                sp.coo_matrix(([1.0] * 4, ([0, 0, 1, 1], [1, 2, 1, 2])),
                              shape=(2, 3)))
    with open(out / "index_map" / "protein-map.pkl", "wb") as f:
        pickle.dump({g: i for i, g in enumerate(gene_ids)}, f)
    return str(out)


def test_gaf_finds_a_gene_by_its_numeric_id(tmp_path):
    """Decagon's protein map holds Entrez numerics; a GAF keyed by them in
    its object-id column enriches in the port, where the JAX package,
    keyed by symbol, finds no study gene."""
    data = _decagon_dir(tmp_path, [100, 5290, 7157])
    lines = ["!gaf-version: 2.2"]
    for i in range(30):
        lines.append(_gaf_line(str(1000 + i), f"BG{i}", "GO:0000002"))
    for gene, sym in ((5290, "PIK3CA"), (7157, "TP53")):
        for t in ("GO:0000001", "GO:0000002"):
            lines.append(_gaf_line(str(gene), sym, t))
    gaf = tmp_path / "num.gaf"
    gaf.write_text("\n".join(lines) + "\n")
    got = explain.enrich_side_effect(0, "unused.json", str(gaf), data_dir=data)
    assert [p["gene_id"] for p in got["proteins"]] == [5290, 7157]
    assert got["enrichment"][0]["go_id"] == "GO:0000001"
    assert got["enrichment"][0]["n_study"] == 2
    assert jexplain.enrich_side_effect(0, "unused.json", str(gaf),
                                       data_dir=data)["enrichment"] == []


def test_enrichment_warns_when_no_study_gene_matches(tmp_path):
    data = _decagon_dir(tmp_path, [100, 5290, 7157])
    gaf, _ = _mini_gaf_obo(tmp_path)
    with pytest.warns(UserWarning, match="none of the 2 study genes"):
        got = explain.enrich_side_effect(0, "unused.json", gaf, data_dir=data)
    assert got["enrichment"] == []
    gaf2 = tmp_path / "g.gaf"
    gaf2.write_text(_gaf_line("5290", "PIK3CA", "GO:0000001") + "\n")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        explain.enrich_side_effect(0, "unused.json", str(gaf2), data_dir=data)


def test_compare_reports_and_proteins_match_jax(tmp_path):
    rows_a = [{"et": t, "name": f"se{t}", "auprc": 0.1 * t, "auroc": 0.5,
               "ap": 0.5} for t in range(6)]
    rows_b = [{"et": t, "name": f"se{t}", "auprc": 0.05 * (6 - t),
               "auroc": 0.5, "ap": 0.5} for t in range(1, 7)]
    save_report(str(tmp_path / "a.json"), rows_a, {})
    save_report(str(tmp_path / "b.json"), rows_b, {})
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    got = explain.compare_reports(a, b, top=3)
    assert got == jexplain.compare_reports(a, b, top=3)
    assert [r["et"] for r in got] == [5, 4, 3]
    data = _decagon_dir(tmp_path, [100, 5290, 7157])
    with open(os.path.join(data, "index_map", "drug-map.pkl"), "wb") as f:
        pickle.dump({11: 0, 12: 1}, f)
    assert explain.proteins_of_side_effect(0, a, data) == \
        jexplain.proteins_of_side_effect(0, a, data)
    assert explain.drugs_targeting_protein(2, data) == \
        jexplain.drugs_targeting_protein(2, data)
    explain.main([a, b, "--top", "2", "--out", str(tmp_path / "cmp.json")])
    with open(tmp_path / "cmp.json") as f:
        assert json.load(f)["comparison"] == got[:2]


def test_plot_runs_writes_a_png(tmp_path):
    for name, variant in (("a.json", "tip-cat"), ("b.json", None)):
        hist = [{"epoch": e, "loss": 1.0 / (e + 1)} for e in range(4)]
        hist[-1]["auprc"] = 0.7
        with open(tmp_path / name, "w") as f:
            json.dump({"history": hist, **({"variant": variant}
                                           if variant else {})}, f)
    assert plots.load_history(str(tmp_path / "a.json"))[0] == "tip-cat"
    assert plots.load_history(str(tmp_path / "b.json"))[0] == "b"
    out = str(tmp_path / "curves.png")
    plots.main([str(tmp_path / "a.json"), str(tmp_path / "b.json"),
                "--out", out])
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _check_report(path, result, et_ids, names=None, ranked=False):
    """The report's rows are result["per_relation"]'s valid relations; its
    summary the final metrics, plus Decagon's ranks with ``ranked``."""
    with open(path) as f:
        rep = json.load(f)
    per = result["per_relation"]
    want = [{"et": int(t),
             "name": names[i] if names else f"type_{int(t)}",
             **{k: round(float(per[k][i]), 4) for k in ("auprc", "auroc", "ap")}}
            for i, t in enumerate(et_ids) if per["valid"][i]]
    assert rep["per_relation"] == want and len(want) > 0
    final = json.loads(json.dumps(result["final"]))
    ranks = {k: rep["summary"].pop(k) for k in
             ("n_relations", "decagon_best_ranks", "decagon_worst_ranks")
             if ranked}
    assert rep["summary"] == final
    if ranked:
        assert ranks["n_relations"] == len(et_ids)


def test_train_cli_report_synthetic(tmp_path):
    """--synthetic --cpu --report: the rows are result["per_relation"]'s,
    with type_{id} names and the plain summary (no name maps)."""
    from tip_tpu_torch.train.__main__ import main

    rep = str(tmp_path / "rep.json")
    result = main(["--synthetic", "--cpu", "--epochs", "2", "--report", rep,
                   "--data-dir", str(tmp_path / "none")])
    _check_report(rep, result, np.arange(7))


def _band_data(tmp_path):
    """A preprocessed directory of 12 relations (tests/test_torch_data.py)
    on 20 drugs."""
    out = str(tmp_path / "data")
    preprocess_decagon(_band_raw_dir(tmp_path), out)
    return out


def test_train_cli_et_band_cache_and_named_report(tmp_path, monkeypatch):
    """Real data: --et-band keeps the band's relations, the graph comes
    from the cache ($TIP_CACHE_DIR), the report is named from the maps."""
    from tip_tpu_torch.data.decagon import et_list_by_nnz_band
    from tip_tpu_torch.train.__main__ import main

    data = _band_data(tmp_path)
    monkeypatch.setenv("TIP_CACHE_DIR", str(tmp_path / "cache"))
    with open(os.path.join(data, "index_map", "combo_map.pkl"), "rb") as f:
        code_of = {v: k for k, v in pickle.load(f).items()}
    with open(os.path.join(data, "index_map", "combo-name-map.pkl"), "wb") as f:
        pickle.dump({c: f"se {c}" for c in code_of.values()}, f)
    rep = str(tmp_path / "rep.json")
    result = main(["--data-dir", data, "--et-band", "8,25", "--cpu",
                   "--epochs", "2", "--report", rep])
    band = et_list_by_nnz_band(8, 25, data)
    assert 0 < len(band) < 12
    assert result["per_relation"]["auprc"].shape == (len(band),)
    assert len(os.listdir(tmp_path / "cache")) == 1
    _check_report(rep, result, band, [f"se {code_of[int(t)]}" for t in band],
                  ranked=True)


def test_models_cli_et_band_and_report(tmp_path, monkeypatch):
    from tip_tpu_torch.data.decagon import et_list_by_nnz_band
    from tip_tpu_torch.models.__main__ import main

    data = _band_data(tmp_path)
    monkeypatch.setenv("TIP_CACHE_DIR", str(tmp_path / "cache"))
    rep = str(tmp_path / "rep.csv")
    result = main(["--variant", "dr-nn", "--data-dir", data, "--et-band",
                   "8,25", "--cpu", "--epochs", "2", "--report", rep])
    band = et_list_by_nnz_band(8, 25, data)
    with open(rep) as f:
        lines = f.read().splitlines()
    assert lines[0] == "et,name,auprc,auroc,ap"
    valid = result["per_relation"]["valid"]
    assert [int(l.split(",")[0]) for l in lines[1:]] == \
        [int(t) for i, t in enumerate(band) if valid[i]]
