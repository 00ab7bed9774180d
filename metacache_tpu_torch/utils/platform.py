# copied from metacache_tpu/utils/platform.py:24-34 (ensure_feature_width)
"""Feature-width gate of database builds and loads."""


def ensure_feature_width(kmerlen: int):
    """Check the k-mer length: 32-bit features for k <= 16, 64-bit ones
    (the reference's -DMC_KMER_TYPE=uint64_t, src/config.hpp:45-48) for
    k up to 32. JAX switches its x64 mode here; the port carries 64-bit
    features as int64 bit patterns, so it has nothing to switch."""
    if not 1 <= kmerlen <= 32:
        raise ValueError(f"k-mer length {kmerlen}: expected 1 to 32")
