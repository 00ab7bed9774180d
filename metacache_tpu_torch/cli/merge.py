# copied from metacache_tpu/cli/merge.py
"""Merge mode: combine query results obtained from database partitions.

Reference: src/mode_merge.cpp. Result files must have been produced with
`-tophits -queryids -lowest species` (or any rank above sequence); the
`# TABLE_LAYOUT` header line locates the query_id/query_header/top_hits
columns, per-query `taxid:hits` candidate lists are merged with the same
sorted/taxon-merged insertion the classifier uses, and queries are
re-classified against a freshly loaded taxonomy.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

from ..classify import output as out_mod
from ..classify.classification import HostCandidate, classify, \
    evaluate_classification, ground_truth
from ..classify.options import ClassificationResults
from ..classify.stats import ClassificationStatistics
from ..config import ClassificationOptions
from ..core.candidates import (BestDistinctCandidates,
                               CandidateGenerationRules, MatchCandidate)
from ..taxonomy import ncbi
from ..taxonomy.model import Rank, TaxonomyCache, rank_from_name
from .main import Args, CliError, parse_query_options


def get_results_file_properties(path: str):
    """Parse '# TABLE_LAYOUT' (reference: mode_merge.cpp:80-149)."""
    layout = None
    sep = "\t|\t"
    with open(path) as f:
        for line in f:
            if line.startswith("# TABLE_LAYOUT:"):
                layout = line[len("# TABLE_LAYOUT:"):].strip()
                break
            if not line.startswith("#"):
                break
    if layout is None:
        raise CliError(f"{path}: no TABLE_LAYOUT header found")
    cols = [c.strip() for c in layout.split("|")]
    cols = [c for c in cols if c]
    try:
        qid_col = cols.index("query_id")
    except ValueError:
        raise CliError(f"{path}: results need -queryids")
    try:
        hits_col = cols.index("top_hits")
    except ValueError:
        raise CliError(f"{path}: results need -tophits")
    header_col = cols.index("query_header") if "query_header" in cols \
        else None
    if any(c.startswith("sequence:") or c == "rank:taxname" for c in cols):
        pass
    return {"qid": qid_col, "hits": hits_col, "header": header_col,
            "ncols": len(cols)}


def read_results(path: str, props, headers: Dict[int, str],
                 candidates: Dict[int, BestDistinctCandidates],
                 taxonomy: TaxonomyCache,
                 rules: CandidateGenerationRules):
    """Reference: mode_merge.cpp:158-238."""
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            fields = [c for c in
                      (x.strip() for x in line.rstrip("\n").split("|"))]
            if len(fields) < props["ncols"]:
                continue
            try:
                qid = int(fields[props["qid"]])
            except ValueError:
                continue
            if props["header"] is not None:
                headers.setdefault(qid, fields[props["header"]])
            gen = candidates.setdefault(qid,
                                        BestDistinctCandidates(rules))
            for tok in fields[props["hits"]].split(","):
                tok = tok.strip()
                if not tok or ":" not in tok:
                    continue
                taxid_s, hits_s = tok.rsplit(":", 1)
                try:
                    taxid = int(taxid_s)
                    hits = int(hits_s)
                except ValueError:
                    # sequence-level (non-numeric) hits cannot be merged
                    raise CliError(
                        f"{path}: results contain sequence-level top hits; "
                        "re-run queries with e.g. '-lowest species'")
                tax = taxonomy.taxon_with_id(taxid)
                if tax is None:
                    continue
                gen.insert(MatchCandidate(tax=tax, tgt=2**32 - 1,
                                          hits=hits))


def main_mode_merge(argv: List[str]) -> int:
    a = Args(argv)
    taxdir = a.take_value("-taxonomy", default="")
    if not taxdir:
        raise CliError("merge mode requires -taxonomy <dir>")
    opt, out_file, _split = parse_query_options(a)
    pos = a.positionals()
    if not pos:
        raise CliError("no result files given")

    files = []
    for p in pos:
        if os.path.isdir(p):
            files += sorted(os.path.join(p, f) for f in os.listdir(p)
                            if f.endswith((".txt", ".out")))
        else:
            files.append(p)

    tax = ncbi.make_taxonomic_hierarchy(
        os.path.join(taxdir, "nodes.dmp"),
        os.path.join(taxdir, "names.dmp"),
        os.path.join(taxdir, "merged.dmp"))
    taxonomy = TaxonomyCache(tax)
    taxonomy.update()

    lowest = rank_from_name(opt.classify.lowest_rank)
    if lowest == Rank.SEQUENCE:
        lowest = Rank.SPECIES  # merge requires rank above sequence
    rules = CandidateGenerationRules(
        max_candidates=opt.classify.max_candidates,
        merge_below_is_sequence=False,
        lowest_ranked_ancestor=lambda tgt: None)

    headers: Dict[int, str] = {}
    candidates: Dict[int, BestDistinctCandidates] = {}
    for path in files:
        props = get_results_file_properties(path)
        read_results(path, props, headers, candidates, taxonomy, rules)

    stream = open(out_file, "w") if out_file else sys.stdout
    results = ClassificationResults(stream)
    oopt = opt.output
    # merge mode has no database to deduce hitsMin from; the reference's
    # deduction rule (sketchlen/3 for s>=6, src/querying.cpp:256-265)
    # applied to the default sketchlen 16 gives 16/3 = 5
    hits_min = opt.classify.hits_min if opt.classify.hits_min >= 1 else 5
    highest = rank_from_name(opt.classify.highest_rank)
    if opt.show_query_params:
        class _P:
            format = oopt.format
            analysis = oopt.analysis
            evaluate = oopt.evaluate
            classify_resolved = (lowest, highest, hits_min,
                                 opt.classify.max_candidates,
                                 opt.classify.insert_size_max)
        stream.write(out_mod.show_query_parameters(
            _P, opt.pairing, opt.num_threads))
    stream.write(f"{oopt.format.tokens.comment}Merging {len(files)} "
                 "files:\n")
    for path in files:
        stream.write(f"{oopt.format.tokens.comment}{path}\n")
    if oopt.format.map_view_mode != out_mod.MapViewMode.NONE:
        stream.write(out_mod.show_query_mapping_header(oopt))

    tax_counts = {}
    for qid in sorted(candidates):
        cands = [HostCandidate(c.tax, c.tgt, c.hits)
                 for c in candidates[qid].top]
        best = classify(taxonomy, opt.classify, hits_min, cands,
                        lowest, highest)
        header = headers.get(qid, str(qid))
        truth = (ground_truth(taxonomy, header)
                 if (oopt.evaluate.precision or
                     oopt.evaluate.determine_ground_truth) else None)
        if best is not None:
            tax_counts[best] = tax_counts.get(best, 0) + 1
        evaluate_classification(best, truth, taxonomy,
                                oopt.evaluate.precision,
                                oopt.evaluate.taxon_coverage,
                                results.statistics)
        stream.write(out_mod.show_query_mapping(
            taxonomy, oopt, None, qid, header, best, truth,
            [(c.tax, c.tgt, c.hits, 0, 0) for c in candidates[qid].top],
            []))

    from ..classify import abundance as abd
    if oopt.analysis.show_tax_abundances:
        stream.write(out_mod.show_abundances(
            abd.sort_tax_counts(tax_counts), results.statistics,
            oopt.format))
    if oopt.analysis.abundance_per != Rank.NONE:
        est = abd.estimate_abundance(taxonomy, tax_counts,
                                     oopt.analysis.abundance_per)
        stream.write(out_mod.show_abundance_estimates(
            oopt.analysis.abundance_per, abd.sort_tax_counts(est),
            results.statistics, oopt.format))
    if opt.show_summary:
        stream.write(out_mod.show_summary(
            results.statistics, results.statistics.total(), 0.0,
            oopt.format.tokens.comment))
    if out_file:
        stream.close()
    return 0
