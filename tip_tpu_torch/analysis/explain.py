"""Prediction-provenance exploration: which side effects does the protein
graph explain that drug co-occurrence alone does not?

A port of tip_tpu/analysis/explain.py (numpy/scipy), the equivalent of the
shippable half of the reference's ``check_data.ipynb``:

  * cells 0-5 compare a protein-based model's predictions against a
    drug-based model's per side effect and list the side effects the
    protein model gets right where the drug model fails — here done on the
    per-relation report JSONs (analysis/report.py) of any two runs, e.g.
    PR-HMP-NN (protein-based) vs DR-DF (drug-based), or TIP vs DR-DF;
  * cells 9-15 look up the drugs targeting a given protein through the
    drug-protein adjacency and the shipped index maps.

The notebook's second half (cells 18-32) runs GO-term enrichment of those
proteins over ``goa_human.gaf`` + ``go-basic.obo``, which it DOWNLOADS from
EBI/OBO at run time (check_data.ipynb cells 21, 27 — nothing is shipped).
The full enrichment machinery is implemented here — minimal GAF 2.x / OBO
parsers (:func:`parse_gaf`, :func:`parse_obo`) and a Fisher-exact
overrepresentation test (:func:`go_enrichment`) over the protein lists
:func:`proteins_of_side_effect` produces — so a user with the same two
files locally gets the notebook's full workflow:

    python -m tip_tpu_torch.analysis.explain A.json B.json --proteins-for 964 \
        --gaf goa_human.gaf --obo go-basic.obo

The download itself remains out of scope (the reference has the identical
runtime dependency).

One difference from the JAX package: :func:`parse_gaf` keys each
annotation by both the DB Object ID (GAF column 2) and the DB Object
Symbol (column 3), :func:`go_enrichment` counts a gene found under both
once, and :func:`enrich_side_effect` warns when none of its study genes is
a key of the annotations.  The JAX package keys by the
symbol alone, so the Decagon maps' numeric gene ids never match and its
enrichment returns no rows without saying why.

CLI:  python -m tip_tpu_torch.analysis.explain runs/pr_hmp_nn_report.json \
          runs/dr_df_report.json [--top 30]
"""

from __future__ import annotations

import json
import os
import pickle
import warnings
from typing import Dict, List, Optional

import numpy as np

from tip_tpu_torch.data.decagon import DEFAULT_DATA_DIR


def _rows_by_et(report_path: str) -> Dict[int, dict]:
    with open(report_path) as f:
        rep = json.load(f)
    if isinstance(rep, dict):  # analysis/report.py layout
        rows = rep.get("per_relation") or rep.get("rows")
    else:
        rows = rep
    return {int(r["et"]): r for r in rows}


def compare_reports(
    report_a: str, report_b: str, metric: str = "auprc", top: int = 30
) -> List[dict]:
    """Side effects ranked by metric(A) - metric(B) over the shared relations.

    A = the model whose explanatory edge is being probed (e.g. the
    protein-based PR-HMP-NN), B = the baseline (e.g. drug-only DR-DF); the
    head of the list is the check_data cell-4 analog — side effects the
    A-graph explains that B alone does not.
    """
    a, b = _rows_by_et(report_a), _rows_by_et(report_b)
    shared = sorted(set(a) & set(b))
    rows = []
    for t in shared:
        rows.append({
            "et": t,
            "name": a[t].get("name", f"type_{t}"),
            f"{metric}_a": a[t][metric],
            f"{metric}_b": b[t][metric],
            "delta": round(a[t][metric] - b[t][metric], 4),
        })
    rows.sort(key=lambda r: -r["delta"])
    return rows[:top]


def drugs_targeting_protein(
    protein_idx: int, data_dir: str = DEFAULT_DATA_DIR
) -> dict:
    """STITCH/gene ids of the drugs targeting one protein (compact index).

    check_data cells 9-15: a column slice of the drug-protein adjacency
    joined through the shipped index maps.
    """
    import scipy.sparse as sp

    dp = sp.load_npz(
        os.path.join(data_dir, "sym_adj", "drug-protein-sparse-adj.npz")
    ).tocsc()
    with open(os.path.join(data_dir, "index_map", "drug-map.pkl"), "rb") as f:
        drug_map = pickle.load(f)
    with open(os.path.join(data_dir, "index_map", "protein-map.pkl"), "rb") as f:
        protein_map = pickle.load(f)
    inv_drug = {v: k for k, v in drug_map.items()}
    inv_prot = {v: k for k, v in protein_map.items()}
    drug_rows = np.nonzero(
        np.asarray(dp[:, protein_idx].todense()).ravel()
    )[0]
    return {
        "protein_idx": int(protein_idx),
        "protein_gene_id": inv_prot.get(int(protein_idx)),
        "n_drugs": int(len(drug_rows)),
        "drug_ids": [inv_drug.get(int(d)) for d in drug_rows],
    }


def proteins_of_side_effect(
    et: int, report_a: str, data_dir: str = DEFAULT_DATA_DIR, top: int = 20
) -> dict:
    """Proteins targeted by the drug pairs of one side-effect relation —
    the hand-off list GO enrichment would consume (check_data cell 33's
    'know mechanism' note).  Counts how many of the relation's drugs target
    each protein and returns the most-shared ones."""
    import scipy.sparse as sp

    adj = sp.load_npz(
        os.path.join(data_dir, "sym_adj", "drug-sparse-adj", f"type_{et}.npz")
    ).tocoo()
    drugs = np.unique(np.concatenate([adj.row, adj.col]))
    dp = sp.load_npz(
        os.path.join(data_dir, "sym_adj", "drug-protein-sparse-adj.npz")
    ).tocsr()
    counts = np.asarray(dp[drugs].sum(axis=0)).ravel()
    order = np.argsort(-counts)[:top]
    with open(os.path.join(data_dir, "index_map", "protein-map.pkl"), "rb") as f:
        protein_map = pickle.load(f)
    inv_prot = {v: k for k, v in protein_map.items()}
    return {
        "et": int(et),
        "n_drugs": int(len(drugs)),
        "proteins": [
            {"protein_idx": int(p), "gene_id": inv_prot.get(int(p)),
             "n_targeting_drugs": int(counts[p])}
            for p in order if counts[p] > 0
        ],
    }


def parse_gaf(path: str) -> Dict[str, set]:
    """Minimal GAF 2.x parser: DB Object Symbol (column 3) -> set of GO ids
    (column 5), and each DB Object ID (column 2) -> the same set object as
    its symbol's, so a gene is found by either key and
    :func:`go_enrichment` still counts it once.  Rows with a NOT qualifier
    are skipped (standard practice); gzip-compressed files are handled (the
    EBI download is .gaf.gz — reference: check_data.ipynb cell 21)."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    anno: Dict[str, set] = {}
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("!"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 5 or "NOT" in cols[3]:
                continue
            terms = anno.setdefault(cols[2], set())
            terms.add(cols[4])
            anno.setdefault(cols[1], terms)
    return anno


def _one_per_gene(genes, anno: Dict[str, set]) -> List[str]:
    """The annotated ``genes``, one key per gene (an object id and its
    symbol share one set in :func:`parse_gaf`'s map)."""
    seen, out = set(), []
    for g in genes:
        terms = anno.get(g)
        if terms is not None and id(terms) not in seen:
            seen.add(id(terms))
            out.append(g)
    return out


def parse_obo(path: str) -> Dict[str, dict]:
    """Minimal OBO parser: GO id -> {name, namespace} (alt_ids aliased).
    Covers what the notebook uses of goatools' obo_parser
    (check_data.ipynb cell 28)."""
    terms: Dict[str, dict] = {}
    cur: Optional[dict] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line == "[Term]":
                cur = {"id": None, "name": "", "namespace": "", "alts": []}
            elif not line and cur and cur["id"]:
                terms[cur["id"]] = cur
                for a in cur["alts"]:
                    terms[a] = cur
                cur = None
            elif cur is not None and ":" in line:
                k, v = line.split(":", 1)
                v = v.strip()
                if k == "id" and cur["id"] is None:
                    cur["id"] = v
                elif k == "name":
                    cur["name"] = v
                elif k == "namespace":
                    cur["namespace"] = v
                elif k == "alt_id":
                    cur["alts"].append(v)
    if cur and cur["id"]:
        terms[cur["id"]] = cur
    return terms


def go_enrichment(
    study_genes, anno: Dict[str, set], obo: Optional[Dict[str, dict]] = None,
    background_genes=None, namespace: Optional[str] = None, top: int = 20,
) -> List[dict]:
    """Fisher-exact GO overrepresentation of ``study_genes`` against
    ``background_genes`` (default: every annotated gene).

    The check_data cells 26-32 analog (one term-per-row table instead of
    goatools objects): for each GO term annotating >= 1 study gene, the
    one-sided Fisher exact p of the 2x2 (in study x has term) table, with
    a Benjamini-Hochberg q value over the tested terms.
    """
    from scipy.stats import fisher_exact

    study = _one_per_gene(study_genes, anno)
    bg = _one_per_gene(background_genes or anno.keys(), anno)
    n_study, n_bg = len(study), len(bg)
    term_study: Dict[str, int] = {}
    for g in study:
        for t in anno[g]:
            term_study[t] = term_study.get(t, 0) + 1
    term_bg: Dict[str, int] = {}
    for g in bg:
        for t in anno[g]:
            term_bg[t] = term_bg.get(t, 0) + 1
    rows = []
    for t, k in term_study.items():
        info = (obo or {}).get(t, {})
        if namespace and info and info.get("namespace") != namespace:
            continue
        m = term_bg.get(t, k)
        _, p = fisher_exact(
            [[k, n_study - k], [m - k, n_bg - n_study - (m - k)]],
            alternative="greater",
        )
        rows.append({
            "go_id": t, "name": info.get("name", ""),
            "namespace": info.get("namespace", ""),
            "n_study": int(k), "n_background": int(m), "p": float(p),
        })
    rows.sort(key=lambda r: r["p"])
    for rank, r in enumerate(rows, 1):  # Benjamini-Hochberg
        r["q"] = min(1.0, r["p"] * len(rows) / rank)
    for i in range(len(rows) - 2, -1, -1):
        rows[i]["q"] = min(rows[i]["q"], rows[i + 1]["q"])
    return rows[:top]


def enrich_side_effect(
    et: int, report_a: str, gaf_path: str, obo_path: Optional[str] = None,
    data_dir: str = DEFAULT_DATA_DIR, top_proteins: int = 50,
    top_terms: int = 20,
) -> dict:
    """End-to-end check_data cells 18-32: the most-shared target proteins
    of one side-effect relation, GO-enriched against all targeted
    proteins.  Gene ids in the Decagon maps are Entrez numerics; they are
    looked up among the GAF's object ids and symbols (:func:`parse_gaf`),
    with a warning when none matches."""
    prot = proteins_of_side_effect(
        et, report_a, data_dir=data_dir, top=top_proteins
    )
    anno = parse_gaf(gaf_path)
    obo = parse_obo(obo_path) if obo_path else None
    genes = [str(p["gene_id"]) for p in prot["proteins"]]
    if genes and not any(g in anno for g in genes):
        warnings.warn(
            f"none of the {len(genes)} study genes of relation {et} is an "
            f"object id or symbol of {gaf_path}: the enrichment is empty")
    prot["enrichment"] = go_enrichment(genes, anno, obo, top=top_terms)
    return prot


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Compare two per-relation reports (check_data analog)"
    )
    ap.add_argument("report_a", help="probe model report (e.g. PR-HMP-NN)")
    ap.add_argument("report_b", help="baseline model report (e.g. DR-DF)")
    ap.add_argument("--metric", default="auprc")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--proteins-for", type=int, default=None, metavar="ET",
                    help="also list the most-shared target proteins of one "
                         "side-effect relation")
    ap.add_argument("--gaf", default=None, metavar="GOA_GAF",
                    help="GO annotation file (goa_human.gaf[.gz]) to "
                         "enrich the --proteins-for list against "
                         "(check_data cells 18-32)")
    ap.add_argument("--obo", default=None, metavar="GO_OBO",
                    help="go-basic.obo for term names/namespaces")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rows = compare_reports(args.report_a, args.report_b,
                           metric=args.metric, top=args.top)
    print(f"{'side effect':42s} {'A':>7s} {'B':>7s} {'delta':>7s}")
    for r in rows:
        print(f"{r['name'][:42]:42s} {r[args.metric + '_a']:7.4f} "
              f"{r[args.metric + '_b']:7.4f} {r['delta']:7.4f}")
    out = {"comparison": rows}
    if args.proteins_for is not None:
        if args.gaf:
            prot = enrich_side_effect(
                args.proteins_for, args.report_a, args.gaf, args.obo
            )
        else:
            prot = proteins_of_side_effect(args.proteins_for, args.report_a)
        out["proteins"] = prot
        print(f"\ntop shared target proteins of relation {args.proteins_for}:")
        for p in prot["proteins"][:10]:
            print(f"  gene {p['gene_id']}  targeted by "
                  f"{p['n_targeting_drugs']} of {prot['n_drugs']} drugs")
        for r in prot.get("enrichment", [])[:10]:
            print(f"  {r['go_id']} {r['name'][:40]:40s} "
                  f"k={r['n_study']}/{r['n_background']} p={r['p']:.2e} "
                  f"q={r['q']:.2e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"-> {args.out}")


if __name__ == "__main__":
    main()
