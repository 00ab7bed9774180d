# copied from metacache_tpu/config.py
"""Configuration for the TPU-native MetaCache framework.

Mirrors the behavioral surface of the reference's compile-time type config
(reference: src/config.hpp:45-157) and sketching options
(reference: src/hash_dna.hpp:99-163), re-expressed as runtime configuration.

The reference binds type widths at compile time; we fix the default widths
(kmer u32, target id u32, window id u32, 8-bit location-list size) and record
them in the database metadata so on-disk compatibility checks work the same
way the reference's `.meta` type-width gate does (src/database.cpp:110-137).
"""
from __future__ import annotations

import dataclasses

# Type widths (bytes) — mirrors reference config.hpp defaults.
KMER_BYTES = 4          # kmer_type = uint32 -> k <= 16
TARGET_ID_BYTES = 4     # target_id = uint32
WINDOW_ID_BYTES = 4     # window_id = uint32
BUCKET_SIZE_BYTES = 1   # loclist_size_t = uint8 -> max 255 locations/feature

#: maximum locations a single feature can map to;
#: reference: host_hashmap::max_supported_locations_per_feature() ==
#: hash_multimap::max_bucket_size() - 1 == 254 (src/host_hashmap.hpp:449-452)
MAX_SUPPORTED_LOCATIONS_PER_FEATURE = 254

#: database format version we write; mirrors MC_DB_VERSION gating semantics
#: (reference: src/version.hpp:27-31, src/database.cpp:99-107)
DB_FORMAT_VERSION = 1

#: sentinel feature value: a window sketch slot that was never filled.
#: The reference initializes sketches with `feature_type(~0)` and trims
#: trailing sentinels (src/hash_dna.hpp:228, 244-251). A genuine hash equal
#: to ~0 can never enter a sketch because insertion requires h < sketch.back()
#: (src/hash_dna.hpp:233).
FEATURE_SENTINEL = 0xFFFFFFFF

#: sentinel for the 64-bit feature config (k = 17..32, the reference's
#: -DMC_KMER_TYPE=uint64_t build: features = murmur3_fmix(kmer),
#: src/config.hpp:45-48 + hash_int.hpp:180-188)
FEATURE_SENTINEL64 = 0xFFFFFFFFFFFFFFFF


def feature_bits(kmerlen: int) -> int:
    """Feature width for a k-mer length (feature_type ==
    same_size_hash<kmer_type> output, src/config.hpp:117-125)."""
    return 32 if kmerlen <= 16 else 64


@dataclasses.dataclass(frozen=True)
class SketchingOptions:
    """Windowed min-hash sketching parameters.

    Reference: `sketching_options` (src/hash_dna.hpp:99-163); build defaults
    {k=16, s=16, w=127, stride=w-k+1=112} (src/options.hpp:102,
    src/options.cpp:625).
    """
    kmerlen: int = 16       # characters per k-mer (<= 16 for u32 kmers)
    sketchlen: int = 16     # features kept per window sketch
    winlen: int = 127       # characters per window
    winstride: int = 0      # 0 -> deduced as winlen - kmerlen + 1

    def resolved(self) -> "SketchingOptions":
        if self.winstride < 1:
            return dataclasses.replace(
                self, winstride=self.winlen - self.kmerlen + 1)
        return self

    def __post_init__(self):
        # 0/negative values are "inherit from database" sentinels
        # (reference: query-side sketching_opt{0,0,0,0}, options.hpp:414)
        if self.kmerlen >= 1 and not (1 <= self.kmerlen <= 32):
            raise ValueError(f"kmerlen must be in [1,32], got {self.kmerlen}")
        if self.winlen >= 1 and self.kmerlen >= 1 and \
                self.winlen < self.kmerlen:
            raise ValueError("winlen must be >= kmerlen")

    @property
    def kmers_per_window(self) -> int:
        return self.winlen - self.kmerlen + 1


@dataclasses.dataclass
class ClassificationOptions:
    """Classification parameters.

    Reference: `classification_options` (src/options.hpp:245-266).
    hitsMin == 0 means "deduce from database sketchlen"
    (src/querying.cpp:256-265): s>=6 -> s/3, s>=4 -> 2, else 1.
    """
    lowest_rank: str = "sequence"
    highest_rank: str = "domain"
    hits_min: int = 0
    hits_diff_fraction: float = 1.0
    insert_size_max: int = 0
    max_candidates: int = 2
    cov_percentile: float = 0.0

    def resolve_hits_min(self, sketchlen: int) -> int:
        if self.hits_min >= 1:
            return self.hits_min
        if sketchlen >= 6:
            return int(sketchlen / 3.0)
        if sketchlen >= 4:
            return 2
        return 1


def max_windows_in_range(query_len: int, insert_size_max: int,
                         target_window_stride: int) -> int:
    """Maximum length of a contiguous window range for candidate generation.

    Reference: make_candidate_generation_rules (src/candidate_structs.hpp:134-151):
    2 + max(len(seq1)+len(seq2), insertSizeMax) / targetWindowStride.
    """
    return 2 + max(query_len, insert_size_max) // target_window_stride
