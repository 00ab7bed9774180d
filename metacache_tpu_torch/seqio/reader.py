# copied from metacache_tpu/seqio/reader.py
"""Streaming FASTA/FASTQ readers with gzip support and pairing modes.

Mirrors the reference reader semantics (src/sequence_io.cpp:160-450,
src/sequence_iostream.hpp):

- per-record format auto-detection: '>' starts a FASTA record, '@' a FASTQ
  record; malformed lines are skipped (resync, not fatal);
- FASTA sequences may span multiple lines; FASTQ records are
  header/sequence/'+'/quality (sequence may span lines until '+');
- gzip-compressed files are transparently decompressed;
- pairing modes: none / files (two files in lockstep) / sequences
  (consecutive records in one file form a pair and share an index).

Indexes are 1-based like the reference's `sequence_reader::index`.
"""
from __future__ import annotations

import dataclasses
import gzip
import io
from enum import Enum
from typing import Iterator, Optional


class PairingMode(Enum):
    NONE = "none"
    FILES = "files"
    SEQUENCES = "sequences"


@dataclasses.dataclass
class SequenceRecord:
    index: int            # 1-based record (or pair) index
    header: str
    seq: bytes
    qual: bytes = b""


@dataclasses.dataclass
class QueryRecord:
    """One query = one read or one read pair."""
    index: int
    header: str
    seq1: bytes
    seq2: bytes = b""


def _open_text(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == b"\x1f\x8b":
        f.seek(0)
        return io.BufferedReader(gzip.GzipFile(fileobj=f))  # type: ignore
    f.seek(0)
    return io.BufferedReader(f)


def read_sequences(path: str, with_quality: bool = False
                   ) -> Iterator[SequenceRecord]:
    """Stream records from one FASTA/FASTQ(.gz) file."""
    index = 0
    with _open_text(path) as f:
        line = f.readline()
        while line:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                header = line[1:].decode(errors="replace")
                chunks = []
                line = f.readline()
                while line and not (line.startswith(b">")
                                    or line.startswith(b"@")):
                    chunks.append(line.strip())
                    line = f.readline()
                index += 1
                yield SequenceRecord(index, header, b"".join(chunks))
            elif line.startswith(b"@"):
                header = line[1:].decode(errors="replace")
                chunks = []
                line = f.readline()
                while line and not line.startswith(b"+"):
                    chunks.append(line.strip())
                    line = f.readline()
                seq = b"".join(chunks)
                qual = b""
                if line:  # '+' separator: read quality of same length
                    qchunks = []
                    qlen = 0
                    while qlen < len(seq):
                        qline = f.readline()
                        if not qline:
                            break
                        q = qline.rstrip(b"\r\n")
                        qchunks.append(q)
                        qlen += len(q)
                    qual = b"".join(qchunks) if with_quality else b""
                    line = f.readline()
                index += 1
                yield SequenceRecord(index, header, seq, qual)
            else:
                # malformed line: resync to next record
                line = f.readline()


def read_queries(files: list[str], mode: PairingMode
                 ) -> Iterator[QueryRecord]:
    """Stream queries honoring the pairing mode.

    - NONE: one query per record, per file, sequentially;
    - SEQUENCES: consecutive records in one file form a pair
      (reference: sequence_pair_reader, src/sequence_io.cpp:246-450);
    - FILES: files[0],files[1] then files[2],files[3], ... read in lockstep.
    """
    if mode == PairingMode.NONE:
        idx = 0
        for path in files:
            for rec in read_sequences(path):
                idx += 1
                yield QueryRecord(idx, rec.header, rec.seq)
    elif mode == PairingMode.SEQUENCES:
        idx = 0
        for path in files:
            it = read_sequences(path)
            for rec in it:
                mate = next(it, None)
                idx += 1
                yield QueryRecord(idx, rec.header, rec.seq,
                                  mate.seq if mate else b"")
    elif mode == PairingMode.FILES:
        idx = 0
        for i in range(0, len(files) - 1, 2):
            it1 = read_sequences(files[i])
            it2 = read_sequences(files[i + 1])
            for rec1 in it1:
                rec2 = next(it2, None)
                idx += 1
                yield QueryRecord(idx, rec1.header, rec1.seq,
                                  rec2.seq if rec2 else b"")
        if len(files) % 2 == 1:
            for rec in read_sequences(files[-1]):
                idx += 1
                yield QueryRecord(idx, rec.header, rec.seq)
    else:  # pragma: no cover
        raise ValueError(f"unknown pairing mode {mode}")


def input_file_stride(mode: PairingMode) -> int:
    """How many input files one query run consumes at a time
    (reference: query_database iterates with pairing-dependent stride,
    src/database_query.hpp:329-366)."""
    return 2 if mode == PairingMode.FILES else 1
