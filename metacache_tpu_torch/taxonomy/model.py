# copied from metacache_tpu/taxonomy/model.py
"""Taxonomy model: ranks, taxa, lineages, LCA.

Mirrors the reference taxonomy semantics (src/taxonomy.hpp:51-736):

- 21 ranks Sequence..root plus `none` (src/taxonomy.hpp:68-91);
- target (reference sequence) taxa get negative ids:
  taxon_id_of_target(tid) = -tid - 1 (src/taxonomy.hpp:919-931);
- ranked lineage = per-rank taxon pointer array built by walking parent links,
  recording only taxa whose rank != none (make_ranks,
  src/taxonomy.hpp:576-597);
- ranked LCA = lowest rank >= `lowest` where both lineages hold the same
  taxon (src/taxonomy.hpp:1290-1301).

For the device path, lineages are flattened to dense int32 arrays
``target_lineages[num_targets, NUM_RANKS]`` of taxon ids (0 = none) — the
same flattening the reference performs for its GPUs
(src/gpu_hashmap.cu:1383-1396).
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Dict, Iterable, Optional

import numpy as np

NONE_ID = 0


class Rank(IntEnum):
    """Reference: taxonomy::rank (src/taxonomy.hpp:68-91)."""
    SEQUENCE = 0
    FORM = 1
    VARIETY = 2
    SUBSPECIES = 3
    SPECIES = 4
    SUBGENUS = 5
    GENUS = 6
    SUBTRIBE = 7
    TRIBE = 8
    SUBFAMILY = 9
    FAMILY = 10
    SUBORDER = 11
    ORDER = 12
    SUBCLASS = 13
    CLASS = 14
    SUBPHYLUM = 15
    PHYLUM = 16
    SUBKINGDOM = 17
    KINGDOM = 18
    DOMAIN = 19
    ROOT = 20
    NONE = 21


NUM_RANKS = int(Rank.NONE)  # 21, reference: taxonomy::num_ranks

_RANK_NAMES = {
    Rank.SEQUENCE: "sequence", Rank.FORM: "form", Rank.VARIETY: "variety",
    Rank.SUBSPECIES: "subspecies", Rank.SPECIES: "species",
    Rank.SUBGENUS: "subgenus", Rank.GENUS: "genus",
    Rank.SUBTRIBE: "subtribe", Rank.TRIBE: "tribe",
    Rank.SUBFAMILY: "subfamily", Rank.FAMILY: "family",
    Rank.SUBORDER: "suborder", Rank.ORDER: "order",
    Rank.SUBCLASS: "subclass", Rank.CLASS: "class",
    Rank.SUBPHYLUM: "subphylum", Rank.PHYLUM: "phylum",
    Rank.SUBKINGDOM: "subkingdom", Rank.KINGDOM: "kingdom",
    Rank.DOMAIN: "domain", Rank.ROOT: "root", Rank.NONE: "none",
}

# Reference: rank_from_name (src/taxonomy.hpp:181-221) — NCBI rank strings.
_NAME_TO_RANK = {
    "sequence": Rank.SEQUENCE, "genome": Rank.SEQUENCE,
    "form": Rank.FORM, "forma": Rank.FORM,
    "variety": Rank.VARIETY, "varietas": Rank.VARIETY,
    "subspecies": Rank.SUBSPECIES,
    "species": Rank.SPECIES,
    "species group": Rank.SUBGENUS, "species subgroup": Rank.SUBGENUS,
    "subgenus": Rank.SUBGENUS,
    "genus": Rank.GENUS,
    "subtribe": Rank.SUBTRIBE, "tribe": Rank.TRIBE,
    "subfamily": Rank.SUBFAMILY, "family": Rank.FAMILY,
    "superfamily": Rank.SUBORDER, "parvorder": Rank.SUBORDER,
    "infraorder": Rank.SUBORDER, "suborder": Rank.SUBORDER,
    "order": Rank.ORDER,
    "superorder": Rank.SUBCLASS, "infraclass": Rank.SUBCLASS,
    "subclass": Rank.SUBCLASS, "class": Rank.CLASS,
    "superclass": Rank.SUBPHYLUM, "subphylum": Rank.SUBPHYLUM,
    "phylum": Rank.PHYLUM, "division": Rank.PHYLUM,
    "superphylum": Rank.SUBKINGDOM, "subkingdom": Rank.SUBKINGDOM,
    "kingdom": Rank.KINGDOM, "subdomain": Rank.KINGDOM,
    "superkingdom": Rank.DOMAIN, "domain": Rank.DOMAIN,
    "root": Rank.ROOT,
}


def rank_name(r: Rank) -> str:
    return _RANK_NAMES[Rank(r)]


def rank_from_name(name: str) -> Rank:
    return _NAME_TO_RANK.get(name.strip().lower(), Rank.NONE)


def next_main_rank(r: Rank) -> Rank:
    """Reference: next_main_rank (src/taxonomy.hpp:106-134)."""
    table = {
        Rank.SEQUENCE: Rank.SPECIES, Rank.FORM: Rank.SPECIES,
        Rank.VARIETY: Rank.SPECIES, Rank.SUBSPECIES: Rank.SPECIES,
        Rank.SPECIES: Rank.GENUS, Rank.SUBGENUS: Rank.GENUS,
        Rank.GENUS: Rank.FAMILY, Rank.SUBTRIBE: Rank.FAMILY,
        Rank.TRIBE: Rank.FAMILY, Rank.SUBFAMILY: Rank.FAMILY,
        Rank.FAMILY: Rank.ORDER, Rank.SUBORDER: Rank.ORDER,
        Rank.ORDER: Rank.CLASS, Rank.SUBCLASS: Rank.CLASS,
        Rank.CLASS: Rank.PHYLUM, Rank.SUBPHYLUM: Rank.PHYLUM,
        Rank.PHYLUM: Rank.KINGDOM, Rank.SUBKINGDOM: Rank.KINGDOM,
        Rank.KINGDOM: Rank.DOMAIN, Rank.DOMAIN: Rank.ROOT,
    }
    return table.get(Rank(r), Rank.NONE)


MAIN_RANKS = (Rank.SEQUENCE, Rank.SPECIES, Rank.GENUS, Rank.FAMILY,
              Rank.ORDER, Rank.CLASS, Rank.PHYLUM, Rank.KINGDOM,
              Rank.DOMAIN, Rank.ROOT)


def taxon_id_of_target(tid: int) -> int:
    """Target taxa get negative ids (src/taxonomy.hpp:919-931)."""
    return -tid - 1


def target_of_taxon_id(taxid: int) -> int:
    return -taxid - 1


def is_target_taxon_id(taxid: int) -> bool:
    return taxid < 0


@dataclasses.dataclass
class FileSource:
    """Reference: taxon::file_source (src/taxonomy.hpp:257-351)."""
    filename: str = ""
    index: int = 0
    windows: int = 0


@dataclasses.dataclass(eq=False)  # identity semantics, like taxon pointers
class Taxon:
    id: int
    parent_id: int = NONE_ID
    name: str = ""
    rank: Rank = Rank.NONE
    source: Optional[FileSource] = None

    def rank_name(self) -> str:
        return rank_name(self.rank)


class Taxonomy:
    """The taxonomy DAG: NCBI taxa (positive ids) + target taxa (negative)."""

    def __init__(self):
        self.taxa: Dict[int, Taxon] = {}      # non-target taxa
        self.targets: Dict[int, Taxon] = {}   # target taxa, keyed by taxon id

    def emplace(self, taxid: int, parent: int, name: str, rank: Rank,
                source: Optional[FileSource] = None) -> Taxon:
        t = Taxon(taxid, parent, name, rank, source)
        if is_target_taxon_id(taxid):
            self.targets[taxid] = t
        else:
            self.taxa[taxid] = t
        return t

    def find(self, taxid: int) -> Optional[Taxon]:
        if is_target_taxon_id(taxid):
            return self.targets.get(taxid)
        return self.taxa.get(taxid)

    def __len__(self):
        return len(self.taxa) + len(self.targets)

    # -- lineage construction (reference: make_ranks, :576-597) ----------
    def make_ranks(self, tax: Taxon) -> list[Optional[Taxon]]:
        lin: list[Optional[Taxon]] = [None] * NUM_RANKS
        if tax.rank != Rank.NONE:
            lin[int(tax.rank)] = tax
        tid = tax.parent_id
        while tid != NONE_ID:
            t = self.taxa.get(tid)
            if t is None:
                break
            if t.rank != Rank.NONE:
                lin[int(t.rank)] = t
            if t.parent_id == tid:
                break  # break cycles
            tid = t.parent_id
        return lin

    # -- full lineage (reference: make_lineage, :620-645) ----------------
    def make_lineage(self, tax: Taxon) -> list[Taxon]:
        lin = [tax]
        tid = tax.parent_id
        while tid != NONE_ID:
            t = self.taxa.get(tid)
            if t is None:
                break
            lin.append(t)
            if t.parent_id == tid:
                break
            tid = t.parent_id
        return lin

    def rank_counts(self) -> Dict[Rank, int]:
        counts: Dict[Rank, int] = {}
        for t in self.taxa.values():
            counts[t.rank] = counts.get(t.rank, 0) + 1
        return counts


def ranked_lca(lina, linb, lowest: Rank = Rank.SEQUENCE):
    """Reference: ranked_lca (src/taxonomy.hpp:1290-1301)."""
    for i in range(int(lowest), int(Rank.ROOT) + 1):
        if lina[i] is not None and lina[i] is linb[i]:
            return lina[i]
    return None


class TaxonomyCache:
    """Taxonomy + dense lineage caches + name lookup.

    Reference: taxonomy_cache (src/taxonomy.hpp:1042-1441). The dense
    ``target_lineages_array`` (int32 taxon ids, 0 = none) is the structure
    shipped to the device for LCA resolution.
    """

    def __init__(self, taxonomy: Optional[Taxonomy] = None):
        self.taxonomy = taxonomy or Taxonomy()
        self.name2tax: Dict[str, Taxon] = {}
        self._sorted_names: Optional[list[str]] = None
        # target_id -> Taxon
        self.target_taxa: list[Taxon] = []
        # dense caches
        self.target_lineages: list[list[Optional[Taxon]]] = []
        self._target_lineages_ids: Optional[np.ndarray] = None
        self._taxon_lineages: Dict[int, list[Optional[Taxon]]] = {}
        self._outdated = True

    # -- target registration (reference: emplace_target_taxon, :1134-1159)
    def emplace_target_taxon(self, tid: int, parent_taxid: int,
                             name: str, source: FileSource) -> Taxon:
        taxid = taxon_id_of_target(tid)
        if name in self.name2tax:
            # duplicate sequence id -> mangle with "!N"
            name = f"{name}!{tid}"
        t = self.taxonomy.emplace(taxid, parent_taxid, name, Rank.SEQUENCE,
                                  source)
        self.name2tax[name] = t
        self._sorted_names = None
        while len(self.target_taxa) <= tid:
            self.target_taxa.append(None)
        self.target_taxa[tid] = t
        self._outdated = True
        return t

    def reset_target_parent(self, tax: Taxon, parent_taxid: int):
        tax.parent_id = parent_taxid
        self._outdated = True

    @property
    def target_count(self) -> int:
        return len(self.target_taxa)

    # -- cache building (reference: initialize_caches, :1391-1402) -------
    def update(self):
        if not self._outdated:
            return
        tx = self.taxonomy
        self.target_lineages = [
            tx.make_ranks(t) if t is not None else [None] * NUM_RANKS
            for t in self.target_taxa]
        ids = np.zeros((max(len(self.target_taxa), 1), NUM_RANKS),
                       dtype=np.int64)
        for i, lin in enumerate(self.target_lineages):
            for r, t in enumerate(lin):
                if t is not None:
                    ids[i, r] = t.id
        self._target_lineages_ids = ids
        self._taxon_lineages = {}
        for t in tx.taxa.values():
            self._taxon_lineages[t.id] = tx.make_ranks(t)
        for t in tx.targets.values():
            self._taxon_lineages[t.id] = tx.make_ranks(t)
        self._outdated = False

    def target_lineages_array(self) -> np.ndarray:
        """Dense [num_targets, NUM_RANKS] int64 taxon-id lineage table."""
        self.update()
        return self._target_lineages_ids

    # -- lookups ---------------------------------------------------------
    def taxon_with_id(self, taxid: int) -> Optional[Taxon]:
        if taxid == NONE_ID:
            return None
        return self.taxonomy.find(taxid)

    def taxon_with_name(self, name: str) -> Optional[Taxon]:
        if not name:
            return None
        return self.name2tax.get(name)

    def taxon_with_similar_name(self, name: str) -> Optional[Taxon]:
        """Prefix lookup (reference: :1119-1127 uses map::lower_bound)."""
        if not name:
            return None
        if self._sorted_names is None:
            self._sorted_names = sorted(self.name2tax)
        import bisect
        i = bisect.bisect_left(self._sorted_names, name)
        if i < len(self._sorted_names) and \
                self._sorted_names[i].startswith(name):
            return self.name2tax[self._sorted_names[i]]
        return None

    def cached_ranks_of_target(self, tid: int) -> list[Optional[Taxon]]:
        self.update()
        return self.target_lineages[tid]

    def cached_ranks(self, tax: Taxon) -> list[Optional[Taxon]]:
        self.update()
        return self._taxon_lineages.get(tax.id, [None] * NUM_RANKS)

    def cached_taxon_of_target(self, tid: int) -> Optional[Taxon]:
        return self.target_taxa[tid] if tid < len(self.target_taxa) else None

    def cached_next_ranked_ancestor(self, tax: Optional[Taxon]):
        """Reference: :1244-1256."""
        if tax is None:
            return None
        if tax.rank != Rank.NONE:
            return tax
        for a in self.cached_ranks(tax):
            if a is not None:
                return a
        return None

    def lowest_ranked_ancestor(self, tid: int, lowest: Rank):
        """Reference: :1259-1267."""
        lin = self.cached_ranks_of_target(tid)
        for r in range(int(lowest), int(Rank.NONE)):
            if lin[r] is not None:
                return lin[r]
        return None

    def ranked_lca(self, lina, linb, lowest: Rank = Rank.SEQUENCE):
        return ranked_lca(lina, linb, lowest)

    def cached_ranked_lca(self, ta: Optional[Taxon], tb: Optional[Taxon]):
        if ta is None or tb is None:
            return None
        return ranked_lca(self.cached_ranks(ta), self.cached_ranks(tb))

    # -- coverage (reference: :1334-1366) --------------------------------
    def covers(self, tax: Optional[Taxon]) -> bool:
        if tax is None:
            return False
        for t in self.taxonomy.targets.values():
            for a in self.taxonomy.make_lineage(t):
                if a is tax:
                    return True
        return False
