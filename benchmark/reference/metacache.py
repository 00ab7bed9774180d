"""MetaCache's build and query in plain PyTorch: the benchmark's
reference for what `metacache_tpu_torch` returns.

It follows upstream MetaCache's semantics (muellan/metacache), written
straight from them and from nothing of the program:

- sketch: each window of ``winlen`` characters at ``winstride`` (and one
  trailing partial window of at least ``kmerlen`` characters) keeps the
  ``sketchlen`` smallest distinct features of its canonical k-mers,
  feature = Thomas Mueller's 32-bit integer hash of min(k-mer, reverse
  complement); k-mers with an ambiguous character give none;
- table: feature -> its (target, window) locations in insertion order
  (targets in file order, windows ascending), the first
  ``max_locations_per_feature`` kept;
- query: every location of every feature of every window of a read; for
  each target the most of them that fall in a contiguous range of
  2 + len // winstride windows; the ``max_candidates`` targets with the
  most, ties to the lower target id;
- classification: the ranked LCA of the top candidates whose hits pass
  (hits0 - hits_min) * hits_diff_fraction, none below ``hits_min`` hits
  or above ``highest_rank``;
- what users receive: the summary's counts by rank, and the per-read
  mapping lines with ``-tophits``.

Every step is a plain torch operation on whatever device it is given, in
chunks of reads so that it fits beside nothing else on the card.
``feature_bits`` below 32 keeps the high bits of each feature only: the
control, a lower precision of the features than the configuration's.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
SENT = M32                 # an empty sketch slot; no feature takes the value
NUM_RANKS = 21             # sequence .. root
RANK_NONE = NUM_RANKS      # unclassified
RANK_NAMES = ("sequence", "form", "variety", "subspecies", "species",
              "subgenus", "genus", "subtribe", "tribe", "subfamily",
              "family", "suborder", "order", "subclass", "class",
              "subphylum", "phylum", "subkingdom", "kingdom", "domain",
              "root")
#: NCBI rank names of the nodes the benchmark writes -> rank index
NCBI_RANK = {"species": 4, "genus": 6, "family": 10, "order": 12,
             "class": 14, "phylum": 16, "superkingdom": 19}


# ------------------------------------------------------------- sketching
def _hash32(x: torch.Tensor) -> torch.Tensor:
    x = (((x >> 16) ^ x) * 0x45D9F3B) & M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & M32
    return (x >> 16) ^ x


def _revcomp(s: torch.Tensor, k: int) -> torch.Tensor:
    s = ((s >> 2) & 0x33333333) | ((s & 0x33333333) << 2)
    s = ((s >> 4) & 0x0F0F0F0F) | ((s & 0x0F0F0F0F) << 4)
    s = ((s >> 8) & 0x00FF00FF) | ((s & 0x00FF00FF) << 8)
    s = ((s >> 16) & 0x0000FFFF) | ((s & 0x0000FFFF) << 16)
    return (M32 - s) >> (32 - 2 * k)


def kmer_features(codes: torch.Tensor, k: int,
                  feature_bits: int = 32) -> torch.Tensor:
    """(n,) u8 codes -> (n - k + 1,) int64 features of the k-mers starting
    at each position, SENT where a character is ambiguous (code >= 4)."""
    n = codes.shape[0] - k + 1
    two = torch.where(codes >= 4, 0, codes).to(torch.int64)
    amb = codes >= 4
    kmer = torch.zeros(n, dtype=torch.int64, device=codes.device)
    bad = torch.zeros(n, dtype=torch.bool, device=codes.device)
    for j in range(k):
        kmer = (kmer << 2) | two[j:j + n]
        bad |= amb[j:j + n]
    f = _hash32(torch.minimum(kmer, _revcomp(kmer, k))) >> (32 - feature_bits)
    return torch.where(bad, SENT, f)


def windows_of(lengths: np.ndarray, sk: dict):
    """The windows of sequences of ``lengths``: (sequence, window id,
    start, k-mer count), those of fewer than k characters left out."""
    w, st, k = sk["winlen"], sk["winstride"], sk["kmerlen"]
    lengths = np.asarray(lengths, np.int64)
    nfull = np.where(lengths > w, (lengths - w) // st + 1, 0)
    nw = np.where(lengths > w, nfull + (nfull * st < lengths), 1)
    seq = np.repeat(np.arange(len(lengths)), nw)
    wid = np.arange(len(seq)) - np.repeat(np.cumsum(nw) - nw, nw)
    start = wid * st
    nk = np.minimum(lengths[seq] - start, w) - k + 1
    keep = nk >= 1
    return seq[keep], wid[keep], start[keep], nk[keep]


def sketch(codes: torch.Tensor, offs: np.ndarray, sk: dict,
           feature_bits: int = 32):
    """Sequences concatenated in ``codes`` (offsets ``offs``) -> (W, s)
    int64 window sketches, ascending, SENT-padded, with each window's
    (sequence, window id) as numpy arrays."""
    k, s = sk["kmerlen"], sk["sketchlen"]
    seq, wid, start, nk = windows_of(np.diff(offs), sk)
    feats = kmer_features(codes, k, feature_bits)
    kpw = sk["winlen"] - k + 1
    dev = codes.device
    col = torch.arange(kpw, device=dev)[None, :]
    first = torch.from_numpy(offs[seq] + start).to(dev)[:, None]
    valid = col < torch.from_numpy(nk).to(dev)[:, None]
    f = torch.where(valid, feats[torch.clamp(first + col, max=len(feats) - 1)],
                    SENT)
    f = torch.sort(f, dim=1).values
    dup = torch.zeros_like(f, dtype=torch.bool)
    dup[:, 1:] = f[:, 1:] == f[:, :-1]
    f = torch.sort(torch.where(dup, SENT, f), dim=1).values[:, :s]
    return f, seq, wid


# ------------------------------------------------------------------ table
class Table:
    """feature -> (target, window) locations: ``uniq`` ascending,
    ``offs`` into ``tgt`` and ``win``."""

    def __init__(self, uniq, offs, tgt, win, ntargets: int, maxwin: int):
        self.uniq, self.offs, self.tgt, self.win = uniq, offs, tgt, win
        self.ntargets, self.maxwin = ntargets, maxwin


def _chunks(lengths, limit: int):
    """Consecutive index ranges whose lengths sum to about ``limit``."""
    lo, acc = 0, 0
    for i, n in enumerate(lengths):
        if acc and acc + n > limit:
            yield lo, i
            lo, acc = i, 0
        acc += int(n)
    if lo < len(lengths):
        yield lo, len(lengths)


def build_table(genomes, sk: dict, cap: int, device, feature_bits: int = 32,
                chunk_bases: int = 1 << 26) -> Table:
    """The table of ``genomes`` (u8 code arrays, target i = genome i)."""
    lens = np.array([len(g) for g in genomes], np.int64)
    fs, locs, maxwin = [], [], 0
    for lo, hi in _chunks(lens, chunk_bases):
        offs = np.concatenate([[0], np.cumsum(lens[lo:hi])])
        codes = torch.from_numpy(np.concatenate(genomes[lo:hi])).to(device)
        f, seq, wid = sketch(codes, offs, sk, feature_bits)
        s = f.shape[1]
        loc = torch.from_numpy(((seq + lo) << 32) | wid).to(device)
        f, loc = f.reshape(-1), loc[:, None].expand(-1, s).reshape(-1)
        keep = f != SENT
        fs.append(f[keep])
        locs.append(loc[keep])
        maxwin = max(maxwin, int(wid.max()))
        del codes
    f, loc = torch.cat(fs), torch.cat(locs)
    del fs, locs
    # windows were made in (target, window) order: a stable sort by
    # feature leaves each feature's locations in insertion order
    f, order = torch.sort(f, stable=True)
    loc = loc[order]
    del order
    n = f.shape[0]
    idx = torch.arange(n, device=device)
    head = torch.ones(n, dtype=torch.bool, device=device)
    head[1:] = f[1:] != f[:-1]
    first = torch.cummax(torch.where(head, idx, 0), dim=0).values
    keep = idx - first < cap
    f, loc = f[keep], loc[keep]
    uniq, counts = torch.unique_consecutive(f, return_counts=True)
    offs = torch.zeros(len(uniq) + 1, dtype=torch.int64, device=device)
    offs[1:] = torch.cumsum(counts, 0)
    return Table(uniq, offs, loc >> 32, loc & M32, len(genomes), maxwin)


# ------------------------------------------------------------------ query
def _bits(x: int) -> int:
    return max(int(x), 1).bit_length()


def _lookup(table: Table, f: torch.Tensor):
    """Features -> (first location, location count), count 0 if absent."""
    i = torch.searchsorted(table.uniq, f)
    i = torch.clamp(i, max=len(table.uniq) - 1)
    hit = (table.uniq[i] == f) & (f != SENT)
    start = table.offs[i]
    return start, torch.where(hit, table.offs[i + 1] - start, 0)


def candidates(table: Table, codes: torch.Tensor, offs: np.ndarray,
               sk: dict, cl: dict, feature_bits: int = 32,
               chunk_locations: int = 1 << 27):
    """Top candidates of each read -> (R, K) int64 targets (-1: none) and
    hits, per read the locations its features have in the table, and the
    count of features its windows probe."""
    dev = codes.device
    nreads = len(offs) - 1
    kk = cl["max_candidates"]
    f, wseq, _wid = sketch(codes, offs, sk, feature_bits)
    s = f.shape[1]
    start, cnt = _lookup(table, f.reshape(-1))
    slot_read = torch.from_numpy(np.repeat(wseq, s)).to(dev)
    per_read = torch.zeros(nreads, dtype=torch.int64, device=dev)
    per_read.index_add_(0, slot_read, cnt)
    mwir = torch.from_numpy(2 + np.maximum(np.diff(offs),
                                           cl["insert_size_max"]) //
                            sk["winstride"]).to(dev)
    tgt_out = torch.full((nreads, kk), -1, dtype=torch.int64, device=dev)
    hits_out = torch.zeros((nreads, kk), dtype=torch.int64, device=dev)
    T = table.ntargets
    wb = _bits(table.maxwin + int(mwir.max()) + 1)
    slot_bounds = np.searchsorted(np.repeat(wseq, s),
                                  np.arange(nreads + 1))
    for r0, r1 in _chunks(per_read.cpu().numpy(), chunk_locations):
        a, b = int(slot_bounds[r0]), int(slot_bounds[r1])
        c, st, rd = cnt[a:b], start[a:b], slot_read[a:b] - r0
        total = int(c.sum())
        if total == 0:
            continue
        rep = torch.repeat_interleave(torch.arange(b - a, device=dev), c)
        excl = torch.cumsum(c, 0) - c
        pos = st[rep] + torch.arange(total, device=dev) - excl[rep]
        rid = rd[rep]
        if _bits((r1 - r0) * T) + wb > 62:
            raise ValueError("a chunk's keys need more than 62 bits")
        key = torch.sort(((rid * T + table.tgt[pos]) << wb) |
                         table.win[pos]).values
        del rep, excl, pos, rid
        blk = key >> wb
        win = key & ((1 << wb) - 1)
        rid = blk // T
        # hits in the window range ending at each location: those of the
        # same read and target at most mwir - 1 windows before it
        lb = torch.searchsorted(key, key - (mwir[rid + r0] - 1))
        n_in = torch.arange(total, device=dev) - lb + 1
        head = torch.ones(total, dtype=torch.bool, device=dev)
        head[1:] = blk[1:] != blk[:-1]
        bidx = torch.cumsum(head, 0) - 1
        nb = int(bidx[-1]) + 1
        best = torch.zeros(nb, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, bidx, n_in, "amax")
        bkey = blk[head]
        brid, btgt = bkey // T, bkey % T
        del key, blk, win, lb, n_in, head, bidx
        # each read's targets by hits descending, ties to the lower id
        hb, tb = _bits(int(best.max())), _bits(T)
        order = torch.sort((brid << (hb + tb)) |
                           (((1 << hb) - 1 - best) << tb) | btgt).indices
        brid, btgt, best = brid[order], btgt[order], best[order]
        rhead = torch.ones(nb, dtype=torch.bool, device=dev)
        rhead[1:] = brid[1:] != brid[:-1]
        ix = torch.arange(nb, device=dev)
        rank = ix - torch.cummax(torch.where(rhead, ix, 0), 0).values
        top = rank < kk
        tgt_out[brid[top] + r0, rank[top]] = btgt[top]
        hits_out[brid[top] + r0, rank[top]] = best[top]
    return tgt_out, hits_out, per_read, int((f != SENT).sum())


def lineage_table(parents: np.ndarray, nodes: dict) -> np.ndarray:
    """(targets, 21) int64 taxon ids by rank, 0 where none: the target's
    own taxon (-(target + 1)) at rank 0, its parent taxon (``parents``)
    and that one's ancestors at their ranks."""
    lin = np.zeros((len(parents), NUM_RANKS), np.int64)
    lin[:, 0] = -(np.arange(len(parents)) + 1)
    anc = {}
    for sp in np.unique(parents):
        row = np.zeros(NUM_RANKS, np.int64)
        t = int(sp)
        while True:
            parent, rank, _name = nodes[t]
            if rank in NCBI_RANK:
                row[NCBI_RANK[rank]] = t
            if parent == t:
                break
            t = parent
        anc[int(sp)] = row
    for i, sp in enumerate(parents):
        lin[i, 1:] = anc[int(sp)][1:]
    return lin


def resolve_hits_min(cl: dict, sketchlen: int) -> int:
    if cl["hits_min"] >= 1:
        return cl["hits_min"]
    if sketchlen >= 6:
        return int(sketchlen / 3.0)
    return 2 if sketchlen >= 4 else 1


def classify(tgt: torch.Tensor, hits: torch.Tensor, lineages: torch.Tensor,
             cl: dict, sketchlen: int):
    """Ranked LCA of the candidates -> (rank, taxon id) of each read,
    (RANK_NONE, 0) where it stays unclassified."""
    hmin = resolve_hits_min(cl, sketchlen)
    highest = RANK_NAMES.index(cl["highest_rank"])
    exists = tgt >= 0
    h0 = hits[:, 0]
    thr = torch.where(h0 > hmin, (h0 - hmin).double() *
                      cl["hits_diff_fraction"], 0.0)
    inc = (hits.double() > thr[:, None]) & exists
    inc[:, 0] = exists[:, 0]
    inc = torch.cumprod(inc.long(), 1).bool()
    lin = lineages[tgt.clamp(min=0)]                      # (R, K, ranks)
    lin0 = lin[:, 0]
    agree = ((lin == lin0[:, None]) | ~inc[:, :, None]).all(1) & (lin0 != 0)
    has = agree.any(1)
    rank = torch.argmax(agree.to(torch.uint8), 1)
    ok = exists[:, 0] & (h0 >= hmin) & has & (rank <= highest)
    taxon = lin0.gather(1, rank[:, None])[:, 0]
    return torch.where(ok, rank, RANK_NONE), torch.where(ok, taxon, 0)


# ---------------------------------------------------------------- outputs
def rank_counts(ranks: torch.Tensor) -> np.ndarray:
    """The summary's reads by rank, unclassified last (22 counts)."""
    return np.bincount(ranks.cpu().numpy(), minlength=RANK_NONE + 1)


def mapping_lines(tgt, hits, ranks, taxa, names: dict, target_names):
    """The per-read lines of a ``-tophits`` query of reads r0, r1, ...:
    read, top hits (name:hits, comma-separated) and the taxon
    (rank:name, or -- where unclassified), joined by tab-bar-tab."""
    tgt, hits = tgt.cpu().numpy(), hits.cpu().numpy()
    ranks, taxa = ranks.cpu().numpy(), taxa.cpu().numpy()
    out = []
    for i in range(len(tgt)):
        top = ",".join(f"{target_names[t]}:{h}"
                       for t, h in zip(tgt[i], hits[i]) if t >= 0 and h > 0)
        if ranks[i] == RANK_NONE:
            tax = "--"
        elif ranks[i] == 0:
            tax = "sequence:" + target_names[-int(taxa[i]) - 1]
        else:
            tax = f"{RANK_NAMES[ranks[i]]}:{names[int(taxa[i])]}"
        out.append(f"r{i}\t|\t{top}\t|\t{tax}")
    return out
