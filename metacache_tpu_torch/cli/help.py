# copied from metacache_tpu/cli/help.py:1-352 (the mode texts, under the
# port's name; mode_help is in cli/main.py)
"""Per-mode documentation (reference: mode_help.cpp serves docs/*.txt;
the content here is written for THIS framework — same flag surface, plus
the TPU-specific controls)."""
from __future__ import annotations

_SKETCHING = """\
SKETCHING (database fingerprinting)

    -kmerlen <k>      number of nucleotides per k-mer (default 16).
                      k > 16 is not supported by this build (64-bit
                      features); the command fails with a clear error.
    -sketchlen <s>    number of features (min-hashed k-mers) per
                      window sketch (default 16).
    -winlen <w>       number of nucleotides per window (default 127).
    -winstride <l>    distance between window starts (default w-k+1,
                      i.e. windows overlap by k-1 so every k-mer is
                      covered exactly once).

    These parameters are stored in the database; query-side overrides
    of -sketchlen/-winlen/-winstride are possible (see 'query'), the
    k-mer length is fixed at build time.
"""

MODES = {
    "build": """\
metacache_tpu_torch build — build a new database from reference sequences

SYNOPSIS

    python -m metacache_tpu_torch build <database> <sequence file/dir>... [OPTION]...

DESCRIPTION

    Create a new database of reference sequences (complete genomes,
    scaffolds, contigs, ...) against which reads are classified later.
    Sequences are cut into overlapping windows, each window is reduced
    to a min-hash sketch, and every (feature, target, window) triple is
    inserted into the feature table. Sketching runs on the accelerator
    in large cross-target batches; table construction is a device sort
    + segmented scatter (see 'build+query' for the fully
    device-resident variant).

BASIC PARAMETERS

    <database>        name the database files are written under
                      (<database>.meta + one .npz per part).

    <sequence file/dir>...
                      FASTA/FASTQ files (gzip supported via the native
                      reader). Directories are searched recursively up
                      to 10 levels deep.

TAXONOMY

    -taxonomy <dir>   directory holding an NCBI taxonomy dump
                      (nodes.dmp, names.dmp, merged.dmp). Without it,
                      classification can only name reference sequences
                      themselves, not species/genus/... ranks.
    -taxpostmap <f>   accession -> taxid mapping file(s)
                      (e.g. *.accession2taxid) applied AFTER the build
                      for targets that could not be ranked from their
                      headers; repeatable.
    -sequence-id-format smart|ncbi|ncbi_acc|ncbi_acc_ver|filename|
                      leading_word|genbank
                      how target ids are extracted from FASTA headers
                      (default: smart fallback chain).
    -reset-taxa       clear all existing target taxon assignments
                      before applying mappings.
    -ref-format       save the database in the reference MetaCache
                      binary format (.meta + .cacheN) so the original
                      metacache binary can load and query it; databases
                      in either format load here transparently.

""" + _SKETCHING + """\

PERFORMANCE / MEMORY

    -parts <n>        build and store the feature table in n parts;
                      parts can be queried together, separately
                      (-part, see 'query'), or spread over devices.
    -max-part-size <GB>
                      keep merged parts below this size.
    -max-locations-per-feature <n>
                      cap every feature's location list at n entries,
                      keeping the lowest (target, window) pairs
                      (default 254). Caps memory for features from
                      repetitive sequence.
    -remove-overpopulated-features
                      after the build, drop features whose lists hit
                      the cap entirely (they carry almost no signal).
    -remove-ambig-features / -max-ambig-per-feature <n> / -ambig-rank <r>
                      drop features that map to more than n distinct
                      taxa at rank r (default rank: sequence).
    -silent / -verbose
                      lower / raise status output on stderr.

    Accepted for reference compatibility, not needed here: -threads
    (device batching replaces thread pools), -max-load-fac (the CSR
    table has no load factor).
""",
    "modify": """\
metacache_tpu_torch modify — add reference sequences to an existing database

SYNOPSIS

    python -m metacache_tpu_torch modify <database> <sequence file/dir>... [OPTION]...

DESCRIPTION

    Load an existing database, sketch and insert additional reference
    sequences, and write the result back — an incremental build resume.
    The database's sketching parameters are kept; all other 'build'
    options (taxonomy, culls, parts) apply.
""",
    "query": """\
metacache_tpu_torch query — classify reads against a database

SYNOPSIS

    python -m metacache_tpu_torch query <database>
    python -m metacache_tpu_torch query <database> <reads file/dir>... [OPTION]...

DESCRIPTION

    Assign each input sequence (short read, long read, or genome
    fragment) to the taxon it most plausibly came from. Every read is
    sketched the same
    way the reference windows were; its features are probed against the
    feature table on the accelerator, matches are swept into contiguous
    window ranges per target, and the best candidates classify the read
    (lowest common ancestor when candidates are ambiguous).

    With no input files an interactive session starts: each stdin line
    is parsed as `[options] <files>` and answered with the database
    still loaded. Empty line or EOF quits.

    Saved databases are staged to the accelerator from their compact
    CSR form; the probe layout (dense / two-tier head+overflow /
    packed rows) is chosen automatically against the measured device
    memory budget.

CLASSIFICATION

    -lowest <rank>    do not classify below this rank (default:
                      sequence — i.e. name individual reference
                      sequences).
    -highest <rank>   do not classify above this rank (default:
                      domain).
    -hitmin <t>       minimum number of feature hits a candidate needs
                      (default: derived from the database sketch
                      length).
    -hitdiff <p>      candidates with at least p% of the best
                      candidate's hits take part in the LCA ambiguity
                      resolution (default 100).
    -maxcand <n>      number of candidates kept per query (default 2).
    -insertsize <n>   maximum paired-end insert size to consider when
                      sizing the window range of a candidate.
    -cov-percentile <p>
                      two-pass mode: first estimate per-target window
                      coverage over the whole input, then re-classify
                      ignoring targets below the p-th coverage
                      percentile (filters spurious references).

PAIRED READS

    -pairfiles        every two consecutive input files are mates
                      (file1: mate 1, file2: mate 2, read in
                      lockstep); a pair classifies from the union of
                      both mates' feature hits.
    -pairseq          mates are consecutive records within one file.

OUTPUT FORMAT (per-read mapping lines)

    -no-map           suppress per-read mapping lines (summary only).
    -mapped-only      omit lines for unclassified reads.
    -taxids           append the taxon id to each taxon name.
    -taxids-only      print taxon ids instead of names.
    -omit-ranks       do not print rank names.
    -separate-cols    print rank, name and id in separate columns.
    -lineage          print the whole lineage from the lowest match up.
    -queryids         prefix every line with the query number.
    -separator <s>    column separator (default '\\t|\\t').
    -comment <s>      prefix for non-mapping lines (default '# ').
    -no-summary       suppress the hit statistics block at the end.
    -no-query-params  suppress the parameter echo at the top.

ANALYSIS

    -tophits          show all candidates (target:hits) per read.
    -allhits          show every feature hit (target/window:count).
    -locations        show candidate window ranges.
    -align            semi-global alignment of each classified read to
                      its top candidate target (slow; target sequences
                      are re-read from their source files).
    -hits-per-ref [<file>]
                      after mapping, list every reference sequence
                      with the reads that hit it.
    -abundances [<file>]
                      absolute and relative per-taxon read counts.
    -abundance-per <rank>
                      accumulate those counts at the given rank.

EVALUATION (reads with ground-truth headers)

    -ground-truth     parse and print the true taxon of each read.
    -precision        count correct classifications per rank.
    -taxon-coverage   also track true/false positives per taxon.

PERFORMANCE / DEVICES

    -batch-size <n>   windows per device batch (default 4096).
    -query-limit <n>  classify at most n reads per input source.
    -replicate <n>    data-parallel replication over n devices
                      (0 = all available); every device holds the
                      whole table and answers a slice of each batch.
    -table-shards <n> shard the feature table over n devices by
                      feature range; probes travel via one all-to-all
                      exchange. Combine with -replicate for
                      2-D meshes.
    -threads <n>      number of parallel file-reader threads on the
                      summary path (byte-range partition of each
                      uncompressed input file; classification itself
                      runs on the device, so threads only need to keep
                      the infeed fed). Compressed (.gz) inputs and
                      per-read output modes use one reader.

DATABASE SCOPE

    -part <p>         load only part p of a partitioned database; use
                      'merge' to combine per-part results.
    -max-locations-per-feature <n> / -remove-overpopulated-features
                      shrink/cull the loaded table before querying.

I/O

    -out <file>       write all output to a file.
    -split-out <file> write per-input-file outputs (suffix appended).
    -min-readlen / -max-readlen <n>
                      classify only reads within this length range.
    -silent / -verbose
                      status verbosity on stderr.

ENVIRONMENT

    MC_TORCH_DEVICE=cpu     run on the CPU, every kernel through its
                            plain PyTorch version; without it the port
                            needs a CUDA device.
    MC_SCAN_K=<k>           batches stacked per device dispatch on the
                            summary-only fast path (default 32, fewer
                            when the input holds fewer batches).
    MC_NATIVE=0             disable the native C++ reader fast paths.
    MC_DEVICE_LAYOUT=0      stage probe layouts on the host instead of
                            building them on device.
    MC_HBM_GB=<n>           override the device-memory total used for
                            probe-layout selection.
    MC_DENSE_LIMIT=<bytes>  stage dense rows only when they take at
                            most this many bytes (1 refuses them).
    MC_CLASSED=<0|1>        size-classed head layout: 0 never, 1 always.
                            Unset = auto: uniform two-tier heads when
                            the memory budget allows a full 61-slot
                            head, size-classed cells when the budget
                            would otherwise pinch the head.
    MC_PACK_ROWS=<0|1>      pair-pack 64-lane rows (unset: auto).
    MC_PACK_SLOTS=0         keep (target, window) slots unpacked.
    MC_PACK_STORE=0         with unpacked slots, keep lane rows.
    MC_ESCALATE=0           disable adaptive bucket-depth escalation
                            (every read pays worst-case bucket depth).
    MC_SKETCH_MODE=<sort|extract>
                            the JAX package's choice of sketch
                            selection; both give the same sketches.
                            The port's sketch kernel of windows up to
                            128 characters (B1) always takes s warp
                            minima (extract), which was faster than
                            the sort on an H100, so either value
                            changes nothing; any other value is
                            refused.
    MC_SPLIT_CAND=<0|1>     1: sort the packed match slots with
                            their own kernel, then sweep them; 0
                            (default): the sweep kernel sorts each
                            row itself (one pass less over memory).
    MC_PROBE_PALLAS=<0|1|list>
                            extra probe-decode kernels: 0 or unset
                            none, 1 all, or a comma list of stages from
                            bucket,oidx (the bucket-row probe, B9, and
                            the overflow-row id, B8). The two-tier
                            decodes (B6 head only, B7 full depth)
                            always run.
    MC_BUILD_GBITS=<g>      force 2^g feature-range groups in the
                            bounded-memory device build (default:
                            auto-sized to ~48M elements per group).

    Not read by the port yet (JAX package knobs of modules still to be
    ported; ROADMAP.md queue A):
    MC_PREFETCH=0           the software-pipelined scan (A6, item 2).
    MC_ESC_FUSED=0          the fused escalation dispatch (item 2).
    MC_ESC_B2=<n>           its flagged-read slice width (item 2).
    MC_NATIVE_FMT=0         the native per-read line formatter (the
                            host pipeline, item 2).
    MC_BUILD_DEBUG=1        per-phase device-build progress (the
                            staging split, item 5, A10).
    MC_SHARD_LAYOUT=<auto|dense|two_tier>
                            the -table-shards shard layout (A14, item 7).
""",
    "build+query": """\
metacache_tpu_torch build+query — build a database in memory and query it

SYNOPSIS

    python -m metacache_tpu_torch build+query -targets <seqs>...
        [build options] [-query <reads>... [query options]]

DESCRIPTION

    One-shot mode: build the database and immediately classify reads
    against it, without writing database files. Everything before
    '-query' is parsed as build options, everything after as query
    options (see 'help build' / 'help query').

    Without -save-db the feature table is built fully ON DEVICE
    (sketches feed the device sort/scatter constructor directly and
    never visit the host) — multi-gigabyte databases build in seconds.
    With -save-db <file>, the host retains the table for persistence
    (slower; required for later 'query'/'modify'/'merge' use).

    With no '-query' files an interactive query session starts.
""",
    "merge": """\
metacache_tpu_torch merge — merge per-partition query results

SYNOPSIS

    python -m metacache_tpu_torch merge <results file>... -taxonomy <dir> [OPTION]...

DESCRIPTION

    Combine query outputs produced against different parts of a
    partitioned database into final classifications: per-query
    candidate lists (taxid:hits) are merged across files and each query
    is re-classified against the merged list.

    Result files must have been produced with
    `-tophits -queryids -lowest species` (or any rank above sequence),
    so candidate taxa are meaningful across parts.

    Options: -lowest/-highest/-hitmin/-hitdiff (as in 'query'),
    -abundances / -abundance-per, output-format flags, -out.
""",
    "info": """\
metacache_tpu_torch info — show database information

SYNOPSIS

    python -m metacache_tpu_torch info <database> [WHAT] [OPTION]...

WHAT

    (none) / basic    sketching parameters + content statistics.
    targets           every reference sequence with source and lineage.
    lineages          one lineage table row per target.
    ranks             taxon counts per rank.
    config            build-time type/parameter configuration.
    statistics        feature-table bucket statistics.
    featuremap        dump the feature -> locations map (big!).
    featurecounts     bucket-size histogram.
""",
}
