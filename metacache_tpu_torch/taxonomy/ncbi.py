# copied from metacache_tpu/taxonomy/ncbi.py
"""NCBI taxonomy dump file parsing.

Mirrors make_taxonomic_hierarchy (reference: src/taxonomy_io.cpp:56-186):

- names.dmp: keep *scientific name* rows only; fields separated by "\t|\t";
- merged.dmp: old-id -> new-id remapping; an (oldId -> parent=newId, no-rank)
  taxon is also inserted so old ids resolve;
- nodes.dmp: (taxonId, parentId, rankName); ids remapped through mergers;
  missing names become "--", empty names "<id>";
- rank of taxon 1 forced to `root`.

Also parses accession -> taxid mapping files (accession2taxid /
assembly_summary) with header-sniffed column selection
(reference: src/taxonomy_io.cpp:191-287).
"""
from __future__ import annotations

import os
from typing import Dict, Iterable

from .model import Rank, Taxon, Taxonomy, rank_from_name


def _dmp_fields(line: str) -> list[str]:
    # row terminator "\t|\n" / "\t|", field terminator "\t|\t"
    line = line.rstrip("\n")
    if line.endswith("\t|"):
        line = line[:-2]
    return line.split("\t|\t")


def read_taxon_names(path: str) -> Dict[int, str]:
    names: Dict[int, str] = {}
    if not os.path.isfile(path):
        return names
    with open(path, "r", errors="replace") as f:
        for line in f:
            fields = _dmp_fields(line)
            if len(fields) < 4:
                continue
            try:
                taxid = int(fields[0])
            except ValueError:
                continue
            if taxid in names:
                continue  # first scientific name wins (lastId guard)
            if "scientific" in fields[3]:
                names[taxid] = fields[1]
    return names


def read_merged_taxa(path: str) -> Dict[int, int]:
    merged: Dict[int, int] = {}
    if not os.path.isfile(path):
        return merged
    with open(path, "r", errors="replace") as f:
        for line in f:
            fields = _dmp_fields(line)
            if len(fields) < 2:
                continue
            try:
                merged[int(fields[0])] = int(fields[1])
            except ValueError:
                continue
    return merged


def make_taxonomic_hierarchy(nodes_file: str, names_file: str = "",
                             merged_file: str = "") -> Taxonomy:
    names = read_taxon_names(names_file)
    merged = read_merged_taxa(merged_file)

    tax = Taxonomy()
    # merged old ids resolve to their new id via a rankless alias node
    for old_id, new_id in merged.items():
        tax.emplace(old_id, new_id, "", Rank.NONE)

    if os.path.isfile(nodes_file):
        with open(nodes_file, "r", errors="replace") as f:
            for line in f:
                fields = _dmp_fields(line)
                if len(fields) < 3:
                    continue
                try:
                    taxid = int(fields[0])
                    parent = int(fields[1])
                except ValueError:
                    continue
                name = names.get(taxid, "--")
                if not name:
                    name = f"<{taxid}>"
                taxid = merged.get(taxid, taxid)
                parent = merged.get(parent, parent)
                tax.emplace(taxid, parent, name, rank_from_name(fields[2]))

    # set rank of root (reference: tax.reset_rank(1, rank::root))
    root = tax.taxa.get(1)
    if root is not None:
        root.rank = Rank.ROOT
    return tax


def read_sequence_to_taxon_id_mapping(path: str,
                                      mapping: Dict[str, int]) -> None:
    """Parse one accession2taxid / assembly_summary file into `mapping`.

    Header sniffing (reference: src/taxonomy_io.cpp:204-252): find the header
    row among the first 10 lines (last '#'-prefixed line or the first line),
    locate "taxid" and "accession.version"/"assembly_accession" columns;
    if no taxid column found, fall back to col0=key, col1=taxid.
    """
    if not os.path.isfile(path):
        return
    with open(path, "r", errors="replace") as f:
        lines = f.readlines()
    if not lines:
        return

    header_row = 0
    for i in range(min(10, len(lines))):
        if not lines[i].startswith("#"):
            break
        header_row += 1
    if header_row > 0:
        header_row -= 1

    keycol, taxcol = 0, 0
    header_tokens = lines[header_row].split()
    col = 0
    i = 0
    while i < len(header_tokens):
        tok = header_tokens[i]
        if tok == "#":
            i += 1
            if i >= len(header_tokens):
                break
            tok = header_tokens[i]
        if tok == "taxid":
            taxcol = col
        elif tok in ("accession.version", "assembly_accession"):
            keycol = col
        col += 1
        i += 1

    start = header_row + 1
    if taxcol < 1:
        keycol, taxcol = 0, 1
        start = 0

    for line in lines[start:]:
        fields = line.rstrip("\n").split("\t")
        if len(fields) <= max(keycol, taxcol):
            continue
        key = fields[keycol].split()[0] if fields[keycol] else ""
        if not key:
            continue
        try:
            taxid = int(fields[taxcol].split()[0])
        except (ValueError, IndexError):
            continue
        mapping.setdefault(key, taxid)


def make_sequence_to_taxon_id_map(local_names: Iterable[str],
                                  global_files: Iterable[str],
                                  infiles: Iterable[str]) -> Dict[str, int]:
    """Reference: make_sequence_to_taxon_id_map (src/taxonomy_io.cpp:293-317)."""
    indirs = []
    for f in infiles:
        d = os.path.dirname(os.path.abspath(f))
        if d not in indirs:
            indirs.append(d)
    mapping: Dict[str, int] = {}
    for d in indirs:
        for name in local_names:
            read_sequence_to_taxon_id_mapping(os.path.join(d, name), mapping)
    for f in global_files:
        read_sequence_to_taxon_id_mapping(f, mapping)
    return mapping
