"""metacache_tpu_torch: the PyTorch + CUDA port of metacache_tpu.

Single-end short-read ``build`` and ``query`` against a single-part
32-bit-feature database, on one NVIDIA Hopper GPU. The window sketcher,
the per-row slot sort and the candidate sweep + top-k (packed and
two-key slots) run as hand-written CUDA kernels (csrc/); each has a
plain PyTorch version that CPU tensors take. The host code (readers,
taxonomy, database files, output formatting) is the port's own copy of
metacache_tpu's; the port imports nothing of that package.
"""
__version__ = "0.1.0"
