# copied from metacache_tpu/core/encoding.py
"""Bit-exact scalar/NumPy oracle for DNA 2-bit encoding, canonical k-mers
and integer mixing hashes.

This module is the *correctness oracle* for the TPU kernels in
``metacache_tpu.ops``: every device kernel must produce identical integer
results. All functions are vectorized NumPy but keep the exact integer
semantics of the reference:

- ASCII -> 2-bit encoding A=0, C=1, G=2, T/U=3, anything else ambiguous
  (reference: src/dna_encoding.hpp:270-316)
- reverse complement via bit-twiddling (reference: src/dna_encoding.hpp:155-198)
- canonical k-mer = min(kmer, revcomp) (reference: src/dna_encoding.hpp:215-226)
- integer hashes (reference: src/hash_int.hpp:41-142)
"""
from __future__ import annotations

import numpy as np

# --- ASCII -> 2-bit code table -------------------------------------------
# code 0..3 for ACGT/U (case-insensitive); 4 marks an ambiguous character.
AMBIG_CODE = np.uint8(4)

_CODE_TABLE = np.full(256, AMBIG_CODE, dtype=np.uint8)
for _chars, _code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("TtUu", 3)):
    for _c in _chars:
        _CODE_TABLE[ord(_c)] = _code


def encode_ascii(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> u8 codes (0..3, AMBIG_CODE for ambiguous)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(
        seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return _CODE_TABLE[arr]


def kmers_2bit(codes: np.ndarray, k: int):
    """All k-mers of a coded sequence.

    Returns ``(kmers, ambig bool)`` of length ``len(codes) - k + 1``;
    kmers are u32 for k <= 16 (the reference default MC_KMER_TYPE) and
    u64 for 17 <= k <= 32 (the reference's -DMC_KMER_TYPE=uint64_t
    build, src/config.hpp:45-48). ``ambig[i]`` is True if any of the k
    characters at position i is ambiguous. Mirrors for_each_kmer_2bit
    (src/dna_encoding.hpp:270-316).
    """
    if k > 32:
        raise ValueError("kmer oracle supports k <= 32")
    dt = np.uint32 if k <= 16 else np.uint64
    n = len(codes) - k + 1
    if n <= 0:
        return (np.zeros(0, dt), np.zeros(0, bool))
    ambig_char = codes >= 4
    two_bit = np.where(ambig_char, 0, codes).astype(dt)
    kmers = np.zeros(n, dtype=dt)
    ambig = np.zeros(n, dtype=bool)
    for j in range(k):
        kmers = (kmers << dt(2)) | two_bit[j:j + n]
        ambig |= ambig_char[j:j + n]
    return kmers, ambig


def revcomp_2bit_u32(s: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2-bit-packed k-mers (u32, k<=16).

    Reference: make_reverse_complement_2bit (src/dna_encoding.hpp:169-177):
    reverse the 2-bit groups, complement (~s == max - s), shift down.
    """
    s = np.asarray(s, dtype=np.uint32)
    s = ((s >> np.uint32(2)) & np.uint32(0x33333333)) | \
        ((s & np.uint32(0x33333333)) << np.uint32(2))
    s = ((s >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) | \
        ((s & np.uint32(0x0F0F0F0F)) << np.uint32(4))
    s = ((s >> np.uint32(8)) & np.uint32(0x00FF00FF)) | \
        ((s & np.uint32(0x00FF00FF)) << np.uint32(8))
    s = ((s >> np.uint32(16)) & np.uint32(0x0000FFFF)) | \
        ((s & np.uint32(0x0000FFFF)) << np.uint32(16))
    return (np.uint32(0xFFFFFFFF) - s) >> np.uint32(32 - (k << 1))


def canonical_2bit_u32(s: np.ndarray, k: int) -> np.ndarray:
    """min(kmer, revcomp(kmer)) — reference src/dna_encoding.hpp:215-226."""
    rc = revcomp_2bit_u32(s, k)
    return np.minimum(np.asarray(s, dtype=np.uint32), rc)


def revcomp_2bit_u64(s: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2-bit-packed k-mers (u64, k <= 32).

    Reference: make_reverse_complement_2bit<uint64_t>
    (src/dna_encoding.hpp:180-198): reverse 2-bit groups, complement,
    shift down by the unused high bits.
    """
    s = np.asarray(s, dtype=np.uint64)
    s = ((s >> np.uint64(2)) & np.uint64(0x3333333333333333)) | \
        ((s & np.uint64(0x3333333333333333)) << np.uint64(2))
    s = ((s >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F)) | \
        ((s & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4))
    s = ((s >> np.uint64(8)) & np.uint64(0x00FF00FF00FF00FF)) | \
        ((s & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8))
    s = ((s >> np.uint64(16)) & np.uint64(0x0000FFFF0000FFFF)) | \
        ((s & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16))
    s = (s >> np.uint64(32)) | (s << np.uint64(32))
    with np.errstate(over="ignore"):
        return (np.uint64(0xFFFFFFFFFFFFFFFF) - s) >> np.uint64(
            64 - (k << 1))


def canonical_2bit_u64(s: np.ndarray, k: int) -> np.ndarray:
    rc = revcomp_2bit_u64(s, k)
    return np.minimum(np.asarray(s, dtype=np.uint64), rc)


def canonical_2bit(s: np.ndarray, k: int) -> np.ndarray:
    """Width-dispatching canonical k-mer."""
    return canonical_2bit_u32(s, k) if k <= 16 else \
        canonical_2bit_u64(s, k)


# --- integer hashes -------------------------------------------------------

def thomas_mueller_hash(x: np.ndarray) -> np.ndarray:
    """32-bit mixing hash — reference src/hash_int.hpp:41-48.

    This is h1 (kmer -> feature) for the default u32 kmer config
    (same_size_hash<u32>, src/hash_int.hpp:171-177).
    """
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = ((x >> np.uint32(16)) ^ x) * np.uint32(0x45d9f3b)
        x = ((x >> np.uint32(16)) ^ x) * np.uint32(0x45d9f3b)
        x = (x >> np.uint32(16)) ^ x
    return x


def murmur3_fmix64(x: np.ndarray) -> np.ndarray:
    """64-bit murmur3 finalizer — reference src/hash_int.hpp:80-89."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return x


def splitmix64_hash(x: np.ndarray) -> np.ndarray:
    """splitmix64 — reference src/hash_int.hpp:112-120."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def halve_size_hash(x: np.ndarray) -> np.ndarray:
    """64 -> 32 bit hash — reference src/hash_int.hpp:131-142."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (~x) + (x << np.uint64(18))
        x = x ^ (x >> np.uint64(31))
        x = x * np.uint64(21)
        x = x ^ (x >> np.uint64(11))
        x = x + (x << np.uint64(6))
        x = x ^ (x >> np.uint64(22))
    return x.astype(np.uint32)


def feature_hash(kmers: np.ndarray) -> np.ndarray:
    """kmer -> feature: same_size_hash of the kmer width
    (thomas_mueller for u32, murmur3_fmix for u64 —
    src/hash_int.hpp:169-188)."""
    if np.asarray(kmers).dtype == np.uint64:
        return murmur3_fmix64(kmers)
    return thomas_mueller_hash(kmers)
