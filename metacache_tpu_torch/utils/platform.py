# copied from metacache_tpu/utils/platform.py:24-34 (ensure_feature_width)
"""Feature-width gate of database builds and loads."""


def ensure_feature_width(kmerlen: int):
    """Nothing to switch for 32-bit features (k <= 16). The 64-bit
    feature config (k > 16; the reference's -DMC_KMER_TYPE=uint64_t,
    src/config.hpp:45-48) is not ported yet."""
    if kmerlen > 16:
        raise NotImplementedError(
            "k > 16 (64-bit features) is not ported yet (ROADMAP queue A13)")
