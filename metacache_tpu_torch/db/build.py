# copied from metacache_tpu/db/build.py
"""Database build orchestration.

Mirrors the reference build pipeline (src/building.cpp:231-667 and
src/mode_build.cpp:42-107): stream reference sequence files, extract
sequence ids and parent taxids (file-accession -> mapping file -> header
taxid chain, src/building.cpp:281-328), insert targets, apply the NCBI
taxonomy, rank unranked targets via post-mapping files, and post-process
features (overpopulated / ambiguous culls).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional

from ..config import SketchingOptions
from ..seqio import reader as seqio
from ..seqio.ids import (SequenceIdType, extract_accession_string,
                         extract_taxon_id)
from ..taxonomy import ncbi
from ..taxonomy.model import FileSource, Rank, Taxonomy
from .database import Database

#: default per-directory taxonomic mapping file names
#: (reference: build_options defaults, src/options.hpp:95-100)
LOCAL_MAPPING_FILENAMES = ["assembly_summary.txt"]
GLOBAL_MAPPING_FILENAMES: list[str] = []


@dataclasses.dataclass
class BuildOptions:
    infiles: list[str] = dataclasses.field(default_factory=list)
    dbfile: str = ""
    taxonomy_dir: str = ""
    taxpostmap: list[str] = dataclasses.field(default_factory=list)
    sketching: SketchingOptions = dataclasses.field(
        default_factory=SketchingOptions)
    max_locations_per_feature: int = -1
    remove_overpopulated_features: bool = False
    max_ambig_per_feature: int = -1
    ambig_rank: Rank = Rank.SEQUENCE
    parts: int = 1
    max_part_bytes: int = 0    # -max-part-size GB cap per merged part
    reset_parents: bool = False
    seq_id_type: SequenceIdType = SequenceIdType.SMART
    device_tables: bool = False   # build+query fast path: tables stay
                                  # on device (no save/merge/culls)
    num_threads: int = 1          # -threads: parallel file parsing


def find_taxon_id(name2tax: Dict[str, int], name: str) -> int:
    """Exact then prefix match (reference: find_taxon_id,
    src/building.cpp:236-258)."""
    if not name2tax or not name:
        return 0
    if name in name2tax:
        return name2tax[name]
    import bisect
    keys = sorted(name2tax)  # cached by caller for hot paths
    i = bisect.bisect_right(keys, name)
    if i < len(keys) and keys[i].startswith(name):
        return name2tax[keys[i]]
    return 0


class _PrefixMap:
    """Sorted-key accession map with prefix fallback."""

    def __init__(self, mapping: Dict[str, int]):
        self.map = mapping
        self.keys = sorted(mapping)

    def find(self, name: str) -> int:
        if not name or not self.map:
            return 0
        v = self.map.get(name)
        if v is not None:
            return v
        import bisect
        i = bisect.bisect_right(self.keys, name)
        if i < len(self.keys) and self.keys[i].startswith(name):
            return self.map[self.keys[i]]
        return 0


def expand_input_paths(paths: Iterable[str],
                       max_depth: int = 10) -> list[str]:
    """Directories expand recursively (up to 10 levels, like the
    reference, src/filesys_utility.cpp / options docs) to their sorted
    sequence files."""
    out = []
    exts = (".fa", ".fna", ".fasta", ".fq", ".fastq", ".gz")

    def walk(d: str, depth: int):
        try:
            entries = sorted(os.listdir(d))
        except OSError:
            return
        for e in entries:
            full = os.path.join(d, e)
            if os.path.isdir(full):
                if depth < max_depth:
                    walk(full, depth + 1)
            elif e.endswith(exts):
                out.append(full)

    for p in paths:
        if os.path.isdir(p):
            walk(p, 1)
        else:
            out.append(p)
    return out


def add_targets_to_database(db: Database, infiles: list[str],
                            sequ2taxid: Dict[str, int],
                            seq_id_type: SequenceIdType = SequenceIdType.SMART,
                            show_progress=None, num_threads: int = 1):
    """Reference: add_targets_to_database (src/building.cpp:337-461).

    ``num_threads > 1``: up to N files parse ahead on reader threads
    (the reference's producer threads, building.cpp:337-356) while the
    main thread inserts in deterministic file order — target ids never
    depend on thread timing."""
    smap = _PrefixMap(sequ2taxid)
    ex = None
    futs: dict = {}
    if num_threads > 1 and len(infiles) > 1:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(min(num_threads, 8))
        window = min(num_threads + 1, len(infiles))
        for i in range(window):
            futs[i] = ex.submit(
                lambda p: list(seqio.read_sequences(p)), infiles[i])
    for fi, path in enumerate(infiles):
        # taxid from the file name's accession
        file_acc = extract_accession_string(os.path.basename(path),
                                            SequenceIdType.SMART)
        file_taxid = smap.find(file_acc) if file_acc else 0
        if ex is not None:
            recs = futs.pop(fi).result()
            nxt = fi + len(futs) + 1
            if nxt < len(infiles):
                futs[nxt] = ex.submit(
                    lambda p: list(seqio.read_sequences(p)),
                    infiles[nxt])
        else:
            recs = seqio.read_sequences(path)
        for rec in recs:
            if not rec.seq:
                continue
            seqid = extract_accession_string(rec.header, seq_id_type)
            if not seqid:
                seqid = rec.header
            parent = file_taxid
            if parent == 0:
                parent = smap.find(seqid)
            if parent == 0:
                parent = extract_taxon_id(rec.header)
            # distribute targets across build parts round-robin
            # (reference: one inserter consumer per part,
            # src/building.cpp:344-356)
            part = db.target_count % max(len(db._pending), 1)
            db.add_target(rec.seq, seqid, parent,
                          FileSource(path, rec.index), part=part)
        if show_progress:
            show_progress(fi + 1, len(infiles))
    if ex is not None:
        ex.shutdown(wait=False)


def try_to_rank_unranked_targets(db: Database, opt: BuildOptions):
    """Attach still-unranked targets via -taxpostmap accession files
    (reference: src/building.cpp:85-229)."""
    unranked = [t for t in db.taxa.target_taxa
                if t is not None and t.parent_id == 0]
    if not unranked:
        return
    mapping: Dict[str, int] = {}
    for f in opt.taxpostmap:
        ncbi.read_sequence_to_taxon_id_mapping(f, mapping)
    if not mapping:
        return
    smap = _PrefixMap(mapping)
    for t in unranked:
        taxid = smap.find(t.name)
        if taxid > 0:
            db.taxa.reset_target_parent(t, taxid)


def build_database(opt: BuildOptions,
                   db: Optional[Database] = None) -> Database:
    """End-to-end build (reference: add_to_database, building.cpp:603-667)."""
    if db is None:
        db = Database(opt.sketching)
    from ..utils.platform import ensure_feature_width
    ensure_feature_width(db.sketching.kmerlen)
    if (opt.device_tables and opt.parts == 1 and not opt.max_part_bytes
            and not opt.remove_overpopulated_features
            and opt.max_ambig_per_feature <= 0 and not db.parts
            and db.sketching.kmerlen <= 16):
        # the on-device table builder is a 32-bit-feature layout;
        # 64-bit-feature DBs (k > 16) build on host and probe CSR
        db.enable_device_build()
    if opt.max_locations_per_feature > 0:
        db.max_locations_per_feature = min(
            opt.max_locations_per_feature,
            db.max_locations_per_feature)
    infiles = expand_input_paths(opt.infiles)

    import sys as _sys
    from ..utils import info as info_mod
    from ..utils.progress import ProgressBar

    # taxonomy
    if opt.taxonomy_dir:
        info_mod.status(f"Reading taxonomy from {opt.taxonomy_dir} ...")
        tax = ncbi.make_taxonomic_hierarchy(
            os.path.join(opt.taxonomy_dir, "nodes.dmp"),
            os.path.join(opt.taxonomy_dir, "names.dmp"),
            os.path.join(opt.taxonomy_dir, "merged.dmp"))
        db.apply_taxonomy(tax)

    sequ2taxid = ncbi.make_sequence_to_taxon_id_map(
        LOCAL_MAPPING_FILENAMES, opt.taxpostmap, infiles)

    nparts0 = opt.parts
    if opt.max_part_bytes:
        # build more virtual parts so the byte cap can keep them apart
        # (reference: virtual parts then merge_reduce under byte limit,
        # src/building.cpp:603-667)
        nparts0 = max(opt.parts, min(
            16, 1 << max(0, (max(len(infiles), 1) - 1).bit_length())))
    db.initialize_parts(nparts0)
    info_mod.status(f"Processing {len(infiles)} reference sequence "
                    "file(s).")
    bar = ProgressBar()
    add_targets_to_database(
        db, infiles, sequ2taxid, opt.seq_id_type,
        show_progress=bar.update if info_mod.show_info() else None,
        num_threads=opt.num_threads)
    db.finalize()
    db.merge_parts(opt.parts, opt.max_part_bytes)

    try_to_rank_unranked_targets(db, opt)

    # post-process features (reference: post_process_features,
    # building.cpp:527-569)
    if opt.remove_overpopulated_features:
        maxloc = db.max_locations_per_feature
        db.remove_features_with_more_locations_than(maxloc - 1)
    if opt.max_ambig_per_feature > 0:
        db.remove_ambiguous_features(opt.ambig_rank,
                                     opt.max_ambig_per_feature)
    return db
