# copied from metacache_tpu/db/mcformat.py
"""Reader and writer for the reference MetaCache binary database format.

Databases built by the muellan/metacache CPU/GPU binary (.meta +
.cacheN files) load directly into a :class:`Database`, so existing
production databases classify here without a rebuild; databases built
here can be written back in the same format (``build -ref-format``,
save_reference_db) so the reference binary can query them.

Format (all little-endian; reference sources):
  .meta   — database::read_meta (src/database.cpp:87-164):
            u64 db version (20200820, src/version.hpp:29),
            7 x u8 type widths (feature, target, window, bucket-size,
            part id, taxon id, num tax ranks),
            2 x sketching_options (4 x u64 each; written twice,
            src/hash_dna.hpp:118-151),
            u64 max locations per feature, u32 target count,
            u32 part count, then the taxonomy: u64 count + per-taxon
            {i64 id, i64 parent, u8 rank, str name, str source.filename,
            u64 source.index, u64 source.windows} with str = u64 length
            + bytes (src/taxonomy.hpp:322-330, io_serialize.hpp:52-58).
  .cacheN — hash_multimap::serialize (src/hash_multimap.hpp:1037-1082):
            u64 nkeys, u64 nvalues, u64 batchSize, then per batch of
            up to batchSize buckets: [keys][u8 sizes][values], where a
            value is a location {u32 win, u32 tgt}
            (src/database.hpp:140-144). Keys appear in hash-table
            order (unsorted).
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..config import SketchingOptions
from ..taxonomy.model import FileSource, Rank, TaxonomyCache, Taxonomy
from ..ops.table import FeatureTable

MC_DB_VERSION = 20200820


class _Bin:
    def __init__(self, path: str):
        self.f = open(path, "rb")

    def u8(self) -> int:
        return self.f.read(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.f.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.f.read(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.f.read(8))[0]

    def string(self) -> str:
        n = self.u64()
        return self.f.read(n).decode(errors="replace")

    def array(self, dtype, count: int) -> np.ndarray:
        return np.frombuffer(
            self.f.read(int(count) * np.dtype(dtype).itemsize), dtype)

    def close(self):
        self.f.close()


class _BinW:
    def __init__(self, path: str):
        self.f = open(path, "wb")

    def u8(self, v: int):
        self.f.write(bytes([v & 0xFF]))

    def u32(self, v: int):
        self.f.write(struct.pack("<I", v))

    def u64(self, v: int):
        self.f.write(struct.pack("<Q", v))

    def i64(self, v: int):
        self.f.write(struct.pack("<q", v))

    def string(self, s: str):
        data = s.encode()
        self.u64(len(data))
        self.f.write(data)

    def array(self, a: np.ndarray):
        self.f.write(np.ascontiguousarray(a).tobytes())

    def close(self):
        self.f.close()


def save_reference_db(db, path: str):
    """Write `db` as a reference-binary database (.meta + .cacheN) the
    muellan/metacache CPU/GPU binary can read and query.

    Field order mirrors database::write_meta (src/database.cpp:247-291)
    and hash_multimap::serialize (src/hash_multimap.hpp:1037-1082); a
    location serializes as {u32 win, u32 tgt} little-endian
    (src/database.hpp:140-144), which is bit-identical to this package's
    packed (tgt << 32 | win) u64. Values within a bucket are written in
    ascending (tgt, win) order, the sorted-bucket invariant the GPU
    serializer also maintains (src/gpu_hashmap.cu:490-606)."""
    from ..config import feature_bits
    db.export_device_parts()      # tables built on the card (mcformat.py:113-121)
    fbits = feature_bits(db.sketching.kmerlen)
    feature_size = 4 if fbits <= 32 else 8
    b = _BinW(path + ".meta")
    b.u64(MC_DB_VERSION)
    for width in (feature_size, 4, 4, 1, 4, 8, 21):
        b.u8(width)
    sk = db.sketching
    for _ in range(2):                # written twice (db v20200820)
        for v in (sk.kmerlen, sk.sketchlen, sk.winlen, sk.winstride):
            b.u64(int(v))
    b.u64(int(db.max_locations_per_feature))
    b.u32(int(db.target_count))
    b.u32(len(db.parts))

    # taxonomy: u64 total count, then non-target taxa, then targets
    # (src/taxonomy.hpp:719-728)
    tx = db.taxa.taxonomy
    taxa = sorted(tx.taxa.values(), key=lambda t: t.id)
    targets = [t for t in db.taxa.target_taxa if t is not None]
    b.u64(len(taxa) + len(targets))
    for t in taxa + targets:
        b.i64(int(t.id))
        b.i64(int(t.parent_id))
        b.u8(int(t.rank))
        b.string(t.name)
        src = t.source
        b.string(src.filename if src else "")
        b.u64(int(src.index) if src else 0)
        b.u64(int(src.windows) if src else 0)
    b.close()

    fdt = np.uint32 if feature_size == 4 else np.uint64
    for i, p in enumerate(db.parts):
        _write_cache(f"{path}.cache{i}", p, fdt)


def _write_cache(path: str, table, fdt, batch: int = 1 << 20):
    """One .cacheN part from a FeatureTable's CSR arrays."""
    b = _BinW(path)
    sizes = np.diff(table.offsets).astype(np.int64)
    keep = sizes > 0                  # only non-empty buckets serialize
    keys = table.unique_features[keep].astype(fdt)
    sizes = sizes[keep]
    nkeys = len(keys)
    b.u64(nkeys)
    b.u64(int(sizes.sum()))
    b.u64(batch)
    voffs = np.concatenate([[0], np.cumsum(sizes)])
    locs = table.locations            # u64 (tgt << 32 | win) == {win,tgt} LE
    src_off = table.offsets.astype(np.int64)[:-1][keep]
    for k0 in range(0, nkeys, batch):
        k1 = min(k0 + batch, nkeys)
        b.array(keys[k0:k1])
        b.array(sizes[k0:k1].astype(np.uint8))
        # bucket value runs are contiguous in CSR order even after
        # empty-bucket removal (empties contribute no values)
        b.array(locs[src_off[k0]:src_off[k0] + int(voffs[k1] -
                                                   voffs[k0])])
    b.close()


def is_reference_db(path: str) -> bool:
    """True when path.meta is a reference-format binary metadata file."""
    meta = path + ".meta"
    if not os.path.exists(meta):
        return False
    with open(meta, "rb") as f:
        head = f.read(8)
    return len(head) == 8 and \
        struct.unpack("<Q", head)[0] == MC_DB_VERSION


def load_reference_db(path: str, metadata_only: bool = False,
                      part: int | None = None):
    """Load a database written by the reference binary."""
    from .database import Database
    from ..utils import info as info_mod
    from ..utils.platform import ensure_feature_width

    b = _Bin(path + ".meta")
    ver = b.u64()
    if ver != MC_DB_VERSION:
        raise IOError(
            f"incompatible reference database version {ver} "
            f"(expected {MC_DB_VERSION})")
    feature_size = b.u8()
    target_size = b.u8()
    window_size = b.u8()
    bucket_size = b.u8()
    part_size = b.u8()
    taxid_size = b.u8()
    num_ranks = b.u8()
    if (target_size, window_size, bucket_size, part_size, taxid_size,
            num_ranks) != (4, 4, 1, 4, 8, 21):
        raise IOError(
            "reference database uses non-default type widths "
            f"(target {target_size}, window {window_size}, bucket "
            f"{bucket_size}, part {part_size}, taxid {taxid_size}, "
            f"ranks {num_ranks})")
    if feature_size not in (4, 8):
        raise IOError(f"unsupported feature width {feature_size}")

    sk = [b.u64() for _ in range(4)]
    [b.u64() for _ in range(4)]          # duplicated block (db v20200820)
    sketching = SketchingOptions(kmerlen=sk[0], sketchlen=sk[1],
                                 winlen=sk[2], winstride=sk[3])
    ensure_feature_width(sketching.kmerlen)
    max_loc = b.u64()
    target_count = b.u32()
    num_parts = b.u32()

    if not metadata_only:
        info_mod.status(
            f"Reading reference-format database from {path} "
            f"({num_parts} part(s), {target_count} targets) ...")

    db = Database(sketching)
    db.max_locations_per_feature = int(max_loc)

    # --- taxonomy ---------------------------------------------------
    # (build the cache only after tx is populated: TaxonomyCache's
    # `taxonomy or Taxonomy()` default treats an empty Taxonomy as
    # absent)
    tx = Taxonomy()
    ntax = b.u64()
    targets = []
    for _ in range(ntax):
        tid = b.i64()
        parent = b.i64()
        rank = Rank(b.u8())
        name = b.string()
        fname = b.string()
        index = b.u64()
        windows = b.u64()
        t = tx.emplace(tid, parent, name, rank,
                       FileSource(fname, index, windows)
                       if (fname or windows) else None)
        if tid < 0:
            targets.append(t)
    b.close()
    cache = TaxonomyCache(tx)
    for t in targets:
        cache.name2tax[t.name] = t
    # target taxa: taxon_id_of_target(tid) = -tid - 1
    cache.target_taxa = [None] * target_count
    for t in targets:
        tid = -t.id - 1
        if 0 <= tid < target_count:
            cache.target_taxa[tid] = t
    cache._outdated = True
    db.taxa = cache

    if metadata_only:
        return db

    fdt = np.uint32 if feature_size == 4 else np.uint64
    idxs = list(range(num_parts)) if part is None else [part]
    if len(idxs) > 1:
        # concurrent part loading (reference: one reader thread per
        # .cache part, src/database.cpp:204-237)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(len(idxs), 8)) as ex:
            db.parts.extend(ex.map(
                lambda i: _read_cache(f"{path}.cache{i}", fdt, max_loc),
                idxs))
    else:
        for i in idxs:
            db.parts.append(_read_cache(f"{path}.cache{i}", fdt,
                                        max_loc))
    return db


def _read_cache(path: str, fdt, max_loc: int) -> FeatureTable:
    b = _Bin(path)
    nkeys = b.u64()
    nvalues = b.u64()
    batch = b.u64()
    keys = np.empty(nkeys, fdt)
    sizes = np.empty(nkeys, np.uint8)
    vals = np.empty(nvalues, np.uint64)      # (win u32, tgt u32) pairs
    kpos = vpos = 0
    while kpos < nkeys:
        nb = min(batch, nkeys - kpos)
        keys[kpos:kpos + nb] = b.array(fdt, nb)
        sz = b.array(np.uint8, nb)
        sizes[kpos:kpos + nb] = sz
        nv = int(sz.astype(np.int64).sum())
        vals[vpos:vpos + nv] = b.array(np.uint64, nv)
        kpos += nb
        vpos += nv
    b.close()
    if vpos != nvalues:
        raise IOError(f"{path}: value count mismatch "
                      f"({vpos} read, {nvalues} expected)")
    # location struct is {win, tgt} little-endian -> low u32 = win;
    # repack into our (tgt << 32 | win) order
    win = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tgt = (vals >> np.uint64(32)).astype(np.uint32)
    feats = np.repeat(keys, sizes.astype(np.int64))
    from ..ops.table import pack_locations
    return FeatureTable.build(feats, pack_locations(tgt, win),
                              int(max_loc))
