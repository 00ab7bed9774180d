# copied from metacache_tpu/seqio/ids.py
"""Sequence-id / accession / taxid extraction from FASTA/FASTQ headers.

Mirrors the reference extractors (src/sequence_io.cpp:456-673):
accession regex, genbank gi| ids, filename, leading word, taxid|NNN, and the
"smart" fallback chain accession > genbank > filename.
"""
from __future__ import annotations

import os
import re
from enum import Enum

# Reference regex (src/sequence_io.cpp:482-484):
# (^|[^[:alnum:]])(([A-Z][_A-Z]{1,9}[0-9]{5,})(\.[0-9]+)?)
_ACCESSION_RE = re.compile(
    r"(^|[^0-9A-Za-z])(([A-Z][_A-Z]{1,9}[0-9]{5,})(\.[0-9]+)?)")


class SequenceIdType(Enum):
    SMART = "smart"
    NCBI = "ncbi"
    NCBI_ACC = "ncbi_acc"
    NCBI_ACC_VER = "ncbi_acc_ver"
    FILENAME = "filename"
    LEADING_WORD = "leading_word"
    GENBANK = "genbank"


def extract_ncbi_accession_number(
        text: str, idtype: SequenceIdType = SequenceIdType.NCBI) -> str:
    if not text:
        return ""
    m = _ACCESSION_RE.search(text)
    if not m:
        return ""
    if idtype in (SequenceIdType.SMART, SequenceIdType.NCBI):
        return m.group(2)
    if idtype == SequenceIdType.NCBI_ACC:
        return m.group(3)
    if idtype == SequenceIdType.NCBI_ACC_VER:
        return m.group(2) if m.group(4) else ""
    return ""


def extract_genbank_identifier(text: str) -> str:
    if not text:
        return ""
    for sep in ("gi|", "gi:", "gi="):
        i = text.find(sep)
        if i != -1:
            break
    else:
        return ""
    i += 3
    j = text.find("|", i)
    if j == -1:
        j = text.find(" ", i)
        if j == -1:
            j = len(text)
    return text[i:j].strip()


def extract_leading_word(text: str) -> str:
    if not text:
        return text
    stripped = text.lstrip()
    if not stripped:
        return text  # whitespace only -> return as-is (reference behavior)
    return stripped.split(None, 1)[0]


def extract_filename_without_extension(text: str) -> str:
    if not text:
        return text
    base = text.rsplit("/", 1)[-1]
    dot = base.find(".")
    return base if dot == -1 else base[:dot]


def extract_accession_string(
        text: str, idtype: SequenceIdType = SequenceIdType.SMART) -> str:
    if not text:
        return ""
    if idtype in (SequenceIdType.NCBI_ACC, SequenceIdType.NCBI_ACC_VER):
        return extract_ncbi_accession_number(text, idtype)
    if idtype == SequenceIdType.NCBI:
        return extract_ncbi_accession_number(text)
    if idtype == SequenceIdType.GENBANK:
        return extract_genbank_identifier(text)
    if idtype == SequenceIdType.LEADING_WORD:
        return extract_leading_word(text)
    if idtype == SequenceIdType.FILENAME:
        return extract_filename_without_extension(text)
    # smart fallback chain
    s = extract_ncbi_accession_number(text)
    if s:
        return s
    s = extract_genbank_identifier(text)
    if s:
        return s
    s = extract_filename_without_extension(text)
    if s:
        return s
    return text


def extract_taxon_id(text: str) -> int:
    """Extract `taxid|NNN` (reference: src/sequence_io.cpp:649-673)."""
    if not text:
        return 0
    i = text.find("taxid")
    if i == -1:
        return 0
    i += 6  # "taxid" + one separator char
    j = text.find("|", i)
    if j == -1:
        j = text.find(" ", i)
        if j == -1:
            j = len(text)
    try:
        return int(text[i:j])
    except ValueError:
        return 0
