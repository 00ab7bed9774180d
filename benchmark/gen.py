"""Inputs of the benchmark, made from the run's seed: genomes, their
taxonomy, and the read files of a traffic mix.

The read generators are frozen copies of those that `chip_smoke.py`
uses (sample_reads, long_read_lengths, sample_long_reads, and its FASTA
writers as ``fasta_bytes`` and ``reads_fasta``), so that a later change
to the smoke run or the program cannot move the yardstick. The genome
generator is the benchmark's own: species of skewed sizes and
log-normal lengths, strains by substitutions, and a conserved operon in
several copies a genome (``genome_plan``). The shape of the database
(lengths, strains, rates, copies) and each read's length and genome come
from plans fixed by the configuration and the mix, so that every seed
does the same work; the seed makes the bases, the substitutions and the
order. The taxonomy writer puts strains under their species, species in
genera, and on through family, order, class and phylum to one domain,
so that the ranked LCA has NCBI's main ranks to walk.

Everything here is NumPy on the host; nothing imports the program.
"""
from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
#: codes 0..3 -> ACGT, for bytes.translate
TO_TEXT = bytes(ACGT.tolist()) + bytes(range(4, 256))

#: the ranks the taxonomy writer puts above species, lowest first, with
#: the NCBI rank name each node carries in nodes.dmp
LEVELS = ("genus", "family", "order", "class", "phylum")
ROOT_ID, DOMAIN_ID = 1, 2
SPECIES_BASE = 1_000_000          # species s has the taxid SPECIES_BASE + s
LEVEL_BASE = 1_000_000            # level i's node j: (i + 2) * LEVEL_BASE + j


def genome_plan(spec: dict) -> dict:
    """The database's shape, drawn from the configuration's ``plan_seed``
    alone, so that every run seed builds the same number of genomes of
    the same lengths: species k (1, 2, ...) holds ceil(largest / k **
    exponent) strains of one log-normal length (median, sigma, clipped
    to min..max), each strain after the first its substitution rate
    (uniform in ``strain_substitutions``) from the species' first
    genome, and the species ``operon.copies`` (uniform, inclusive)
    copies of the conserved operon at drawn places; species are added
    until ``total_bases`` is reached.
    -> {"length", "strains", "copies": (species,) ints, "rates": [(s,)
    floats a species], "places": [(c,) ints a species]}."""
    plan = np.random.default_rng(spec["plan_seed"])
    ln, sz, op = spec["lengths"], spec["species_sizes"], spec["operon"]
    lo, hi = spec["strain_substitutions"]
    out = {"length": [], "strains": [], "copies": [], "rates": [],
           "places": []}
    total = 0
    while total < spec["total_bases"]:
        k = len(out["length"]) + 1
        n = int(np.ceil(sz["largest"] / k ** sz["exponent"]))
        glen = int(np.clip(round(ln["median"] *
                                 np.exp(plan.normal(0.0, ln["sigma"]))),
                           ln["min"], ln["max"]))
        c = int(plan.integers(op["copies"][0], op["copies"][1] + 1))
        out["length"].append(glen)
        out["strains"].append(n)
        out["copies"].append(c)
        out["rates"].append(np.concatenate(
            [[0.0], plan.uniform(lo, hi, n - 1)]))
        out["places"].append(plan.integers(0, glen - op["length"] + 1, c))
        total += n * glen
    for key in ("length", "strains", "copies"):
        out[key] = np.asarray(out[key], np.int64)
    return out


def config_genomes(cfg: dict, seed: int):
    """The configuration's genomes from ``seed`` on the shape of
    ``genome_plan``: one random operon, a variant of it a species
    (``operon.species_substitutions`` apart), each species' first genome
    random bases with its variant written over it at its places, and
    each further strain that genome with its substitutions, a fixed
    number at positions that ``seed`` draws.
    -> (list of (L,) u8 code arrays, (n,) species of each)."""
    spec = cfg["genomes"]
    op = spec["operon"]
    plan = genome_plan(spec)
    rng = np.random.default_rng(seed)
    master = rng.integers(0, 4, op["length"], dtype=np.uint8)
    nvar = int(op["length"] * op["species_substitutions"])
    genomes, species = [], []
    for sp, glen in enumerate(plan["length"].tolist()):
        variant = master.copy()
        variant[rng.integers(0, op["length"], nvar)] = \
            rng.integers(0, 4, nvar, dtype=np.uint8)
        base = rng.integers(0, 4, glen, dtype=np.uint8)
        for p in plan["places"][sp].tolist():
            base[p:p + op["length"]] = variant
        for rate in plan["rates"][sp].tolist():
            g = base
            nmut = int(glen * rate)
            if nmut:
                g = base.copy()
                g[rng.integers(0, glen, nmut)] = \
                    rng.integers(0, 4, nmut, dtype=np.uint8)
            genomes.append(g)
            species.append(sp)
    return genomes, np.asarray(species, np.int32)


def target_name(i: int) -> str:
    return "GEN%05d.1" % i


def fasta_bytes(genomes, species) -> bytes:
    """The genomes as FASTA records, one line a sequence, the species'
    taxid in the header (as chip_smoke.py::write_genomes writes them)."""
    parts = []
    for i, g in enumerate(genomes):
        parts.append(b">%s taxid|%d| strain genome\n"
                     % (target_name(i).encode(),
                        SPECIES_BASE + int(species[i])))
        parts.append(g.tobytes().translate(TO_TEXT))
        parts.append(b"\n")
    return b"".join(parts)


def make_taxonomy(nsp: int, branching: int, seed: int) -> dict:
    """An NCBI-style tree over ``nsp`` species: each level of LEVELS has
    ceil(children / branching) nodes, and each child draws its parent
    from them with ``seed``; the phyla hang under one domain
    (superkingdom), the domain under the root.
    -> {taxid: (parent taxid, NCBI rank name, name)}."""
    rng = np.random.default_rng(seed)
    nodes = {ROOT_ID: (ROOT_ID, "no rank", "root"),
             DOMAIN_ID: (ROOT_ID, "superkingdom", "Bacteria")}
    child_ids = [SPECIES_BASE + s for s in range(nsp)]
    child_rank, child_name = "species", "species"
    for i, level in enumerate(LEVELS):
        n = -(-len(child_ids) // branching)
        ids = [(i + 2) * LEVEL_BASE + j for j in range(n)]
        parent = rng.integers(0, n, len(child_ids))
        for c, p in zip(child_ids, parent):
            nodes[c] = (ids[int(p)], child_rank,
                        f"{child_name} {c % LEVEL_BASE}")
        child_ids, child_rank, child_name = ids, level, level
    for c in child_ids:
        nodes[c] = (DOMAIN_ID, child_rank, f"{child_name} {c % LEVEL_BASE}")
    return nodes


def write_taxonomy(tax_dir: str, nodes: dict) -> None:
    """nodes.dmp, names.dmp and an empty merged.dmp."""
    os.makedirs(tax_dir, exist_ok=True)
    with open(os.path.join(tax_dir, "nodes.dmp"), "w") as f:
        for t, (p, rank, _name) in nodes.items():
            f.write(f"{t}\t|\t{p}\t|\t{rank}\t|\n")
    with open(os.path.join(tax_dir, "names.dmp"), "w") as f:
        for t, (_p, _rank, name) in nodes.items():
            f.write(f"{t}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
    open(os.path.join(tax_dir, "merged.dmp"), "w").close()


# copied from chip_smoke.py:478-485
def by_genome(gsel, ngenomes: int):
    """(genome, the indices that drew it, increasing) for each genome
    drawn, from one stable sort of the draws."""
    order = np.argsort(gsel, kind="stable")
    cuts = np.searchsorted(gsel[order], np.arange(ngenomes + 1))
    for g in np.nonzero(cuts[1:] > cuts[:-1])[0]:
        yield g, order[cuts[g]:cuts[g + 1]]


# copied from chip_smoke.py:487-503 (bench.py:149-159), the genome of
# each read drawn by the caller
def sample_reads(rng, genomes, gsel, read_len: int):
    """Reads of read_len from the genomes ``gsel`` at uniformly drawn
    positions, with Poisson(read_len / 100) substitutions, a 1% rate.
    -> (n, read_len) u8 codes."""
    n = len(gsel)
    glen = np.array([len(g) for g in genomes])
    pos = rng.integers(0, glen[gsel] - read_len)
    reads = np.empty((n, read_len), np.uint8)
    for g, sel in by_genome(gsel, len(genomes)):
        reads[sel] = genomes[g][pos[sel, None] + np.arange(read_len)]
    nm = rng.poisson(read_len / 100, n)
    rows = np.repeat(np.arange(n), nm)
    reads[rows, rng.integers(0, read_len, len(rows))] = \
        rng.integers(0, 4, len(rows), dtype=np.uint8)
    return reads


# copied from chip_smoke.py:513-518, its constants made parameters
def long_read_lengths(rng, n: int, sigma: float = 1.0, median: int = 480,
                      lo: int = 200, hi: int = 19000) -> np.ndarray:
    """n log-normal read lengths, median 480 bp, clipped to
    200..19,000 bp (the spread ``sigma`` is assumed)."""
    return np.clip(np.round(median * np.exp(rng.normal(0.0, sigma, n))), lo,
                   hi).astype(np.int64)


# copied from chip_smoke.py:521-539, the lengths and the genome of each
# read drawn by the caller
def sample_long_reads(rng, genomes, gsel, lens: np.ndarray):
    """Reads of the given lengths from the genomes ``gsel`` at uniformly
    drawn positions, with Poisson(length / 100) substitutions, the draw
    of ``sample_reads``. -> (codes of all reads concatenated, offsets)."""
    n = len(lens)
    glen = np.array([len(g) for g in genomes])
    pos = rng.integers(0, glen[gsel] - lens)
    offs = np.concatenate([[0], np.cumsum(lens)])
    codes = np.empty(offs[-1], np.uint8)
    for i in range(n):
        codes[offs[i]:offs[i + 1]] = genomes[gsel[i]][pos[i]:pos[i] + lens[i]]
    nm = rng.poisson(lens / 100)
    rows = np.repeat(np.arange(n), nm)
    codes[offs[rows] + rng.integers(0, lens[rows])] = \
        rng.integers(0, 4, len(rows), dtype=np.uint8)
    return codes, offs


def read_file(traffic: dict, genomes, rng, index: int):
    """File ``index`` of the traffic mix. Its plan, the length and the
    genome of each read, comes from the mix's own ``plan_seed`` and the
    index, so that every run seed reads the same set of lengths from the
    same genomes (whose bases the run seed makes); ``rng`` (the run's
    seed) shuffles the plan and draws the positions and substitutions.
    ``lengths.kind`` "fixed": ``reads_per_file`` reads of
    ``lengths.value`` bp (``sample_reads``); "lognormal":
    ``long_read_lengths`` (``sample_long_reads``).
    -> (codes of all reads concatenated, offsets)."""
    n = traffic["reads_per_file"]
    ln = traffic["lengths"]
    plan = np.random.default_rng([traffic["plan_seed"], index])
    if ln["kind"] == "fixed":
        lens = np.full(n, ln["value"], np.int64)
    elif ln["kind"] == "lognormal":
        lens = long_read_lengths(plan, n, ln["sigma"], ln["median"],
                                 ln["min"], ln["max"])
    else:
        raise ValueError(f"unknown read length kind {ln['kind']!r}")
    gsel = plan.integers(0, len(genomes), n)
    order = rng.permutation(n)
    lens, gsel = lens[order], gsel[order]
    if ln["kind"] == "fixed":
        reads = sample_reads(rng, genomes, gsel, ln["value"])
        return reads.reshape(-1), np.arange(n + 1, dtype=np.int64) * \
            ln["value"]
    return sample_long_reads(rng, genomes, gsel, lens)


def reads_fasta(codes: np.ndarray, offs: np.ndarray) -> bytes:
    """Reads as FASTA records named r0, r1, ... (the records of
    chip_smoke.py's write_reads and write_long_reads)."""
    text = codes.tobytes().translate(TO_TEXT)
    lens = np.diff(offs)
    if len(lens) and (lens == lens[0]).all():
        return _fixed_fasta(text, len(lens), int(lens[0]))
    return b"".join(b">r%d\n%s\n" % (i, text[offs[i]:offs[i + 1]])
                    for i in range(len(offs) - 1))


def _fixed_fasta(text: bytes, n: int, ln: int) -> bytes:
    """``reads_fasta`` of n reads of one length, in one array a run of
    names with the same number of digits."""
    seq = np.frombuffer(text, np.uint8).reshape(n, ln)
    out, lo, digits = [], 0, 1
    while lo < n:
        hi = min(n, 10 ** digits)
        rows = np.empty((hi - lo, 2 + digits + 1 + ln + 1), np.uint8)
        rows[:, :2] = np.frombuffer(b">r", np.uint8)
        ids = np.arange(lo, hi)
        for d in range(digits):
            rows[:, 2 + digits - 1 - d] = 48 + (ids // 10 ** d) % 10
        rows[:, 2 + digits] = 10
        rows[:, 3 + digits:-1] = seq[lo:hi]
        rows[:, -1] = 10
        out.append(rows.tobytes())
        lo, digits = hi, digits + 1
    return b"".join(out)
