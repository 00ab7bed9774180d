"""Window sketchers: kernels B1 and B2 and their plain PyTorch versions.

Port of metacache_tpu/ops/sketch_jax.py:34-152 (the sort-based
sketcher) and of the Pallas kernels sketch_pallas.sketch_windows_pallas
(B1, windows of at most 128 characters, also read from the runner's
2-bit infeed) and sketch_pallas.sketch_windows_pallas_long (B2, wider
windows: the 255 and 511 presets), both in csrc/sketch.cu. Features
leave as int32 tensors holding the u32 bit patterns; the plain versions
compute in int64, where every u32 value is non-negative, so their sorts
order them as unsigned and the sentinel 0xFFFFFFFF sorts last.

B1 selects its s features by s warp minima, the form JAX's
MC_SKETCH_MODE=extract picks (rows.py:28-50); JAX's other form, "sort",
gives the same sketches and was the slower on the H100 (PERF.md §6), so
the port has one form. It accepts the variable's two values, which
change nothing, and refuses any other.
"""
from __future__ import annotations

import os

import torch

from .. import kernels

LANES = 128
PAD_CODE = 4
SENTINEL = 0xFFFFFFFF
_M32 = 0xFFFFFFFF
SKETCH_MODES = ("sort", "extract")


def check_sketch_mode():
    """Refuse an MC_SKETCH_MODE other than JAX's two forms, unset,
    "sort" or "extract"; B1 gives the same sketches under each."""
    mode = os.environ.get("MC_SKETCH_MODE")
    if mode and mode not in SKETCH_MODES:
        raise ValueError(f"sketch mode {mode!r} (MC_SKETCH_MODE): expected "
                         f"one of {SKETCH_MODES}")


def thomas_mueller_hash(x: torch.Tensor) -> torch.Tensor:
    """u32 mixing hash on int64 values in [0, 2^32)
    (metacache_tpu/ops/sketch_jax.py:34)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def revcomp_2bit(s: torch.Tensor, k: int) -> torch.Tensor:
    """Bit-twiddled reverse complement (sketch_jax.py:43)."""
    s = ((s >> 2) & 0x33333333) | ((s & 0x33333333) << 2)
    s = ((s >> 4) & 0x0F0F0F0F) | ((s & 0x0F0F0F0F) << 4)
    s = ((s >> 8) & 0x00FF00FF) | ((s & 0x00FF00FF) << 8)
    s = ((s >> 16) & 0x0000FFFF) | ((s & 0x0000FFFF) << 16)
    return (_M32 - s) >> (32 - (k << 1))


def window_kmers(codes: torch.Tensor, k: int):
    """(N, W) u8 codes -> ((N, P) int64 k-mers, (N, P) bool ambiguous),
    P = W - k + 1 (sketch_jax.py:84)."""
    p = codes.shape[1] - k + 1
    ambig_char = codes >= 4
    two_bit = torch.where(ambig_char, 0, codes).to(torch.int64)
    kmers = torch.zeros((codes.shape[0], p), dtype=torch.int64,
                        device=codes.device)
    ambig = torch.zeros((codes.shape[0], p), dtype=torch.bool,
                        device=codes.device)
    for j in range(k):
        kmers = (kmers << 2) | two_bit[:, j:j + p]
        ambig = ambig | ambig_char[:, j:j + p]
    return kmers, ambig


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same u32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _sort_dedup_take(feats: torch.Tensor, sketchlen: int) -> torch.Tensor:
    """(N, M) int64 u32 values -> the ``sketchlen`` smallest distinct
    ones, ascending, duplicates and missing values as the sentinel."""
    feats = torch.sort(feats, dim=1).values
    dup = torch.zeros_like(feats, dtype=torch.bool)
    dup[:, 1:] = feats[:, 1:] == feats[:, :-1]
    feats = torch.sort(torch.where(dup, SENTINEL, feats), dim=1).values
    feats = feats[:, :sketchlen]
    if feats.shape[1] < sketchlen:
        pad = torch.full((feats.shape[0], sketchlen - feats.shape[1]),
                         SENTINEL, dtype=torch.int64, device=feats.device)
        feats = torch.cat([feats, pad], dim=1)
    return feats


def sketch_windows_plain(codes: torch.Tensor, valid: torch.Tensor,
                         k: int, sketchlen: int) -> torch.Tensor:
    """Plain version of B1 (sketch_jax.sketch_windows): (N, W) u8 codes,
    (N,) valid lengths -> (N, sketchlen) int32 u32-bit features,
    ascending, deduplicated, sentinel padded."""
    p = codes.shape[1] - k + 1
    kmers, ambig = window_kmers(codes, k)
    pos = torch.arange(p, device=codes.device)[None, :]
    nvalid = torch.clamp(valid.to(torch.int64) - (k - 1), min=0)[:, None]
    invalid = ambig | (pos >= nvalid)
    canon = torch.minimum(kmers, revcomp_2bit(kmers, k))
    feats = torch.where(invalid, SENTINEL, thomas_mueller_hash(canon))
    feats = _sort_dedup_take(feats, sketchlen)
    out_pos = torch.arange(sketchlen, device=codes.device)[None, :]
    feats = torch.where(out_pos >= nvalid, SENTINEL, feats)
    return to_i32_bits(feats)


def sketch_windows_long_plain(codes: torch.Tensor, valid: torch.Tensor,
                              k: int, sketchlen: int) -> torch.Tensor:
    """Plain version of B2 (sketch_pallas.sketch_windows_pallas_long,
    sketch_pallas.py:219-242): (N, W > 128) u8 codes, (N,) valid lengths
    -> (N, sketchlen) int32 u32-bit features. Each 128-char chunk, the
    last padded with code 4 and each with its valid length clipped to
    [0, 128], is sketched by B1's plain version; the chunk sketches merge
    by sort + dedup + take s, which equals the sketch of the whole
    window (a value among the s smallest distinct of the window is among
    the s smallest distinct of its own chunk)."""
    n, w = codes.shape
    # chunks at this stride partition the window's k-mer starts
    stride = LANES - (k - 1)
    nch = max(1, -(-max(w - (k - 1), 1) // stride))
    chunks, vals = [], []
    valid = valid.to(torch.int64)
    for c in range(nch):
        lo = c * stride
        sl = codes[:, lo:lo + LANES]
        if sl.shape[1] < LANES:
            sl = torch.cat([sl, torch.full((n, LANES - sl.shape[1]),
                                           PAD_CODE, dtype=torch.uint8,
                                           device=codes.device)], dim=1)
        chunks.append(sl)
        vals.append(torch.clamp(valid - lo, 0, LANES))
    big = torch.stack(chunks, 1).reshape(n * nch, LANES)
    bval = torch.stack(vals, 1).reshape(n * nch)
    sk = sketch_windows_plain(big, bval, k, sketchlen).reshape(
        n, nch * sketchlen).to(torch.int64) & _M32
    return to_i32_bits(_sort_dedup_take(sk, sketchlen))


def pad_windows(codes: torch.Tensor) -> torch.Tensor:
    """Pad windows narrower than 128 lanes with the ambiguous code 4
    (metacache_tpu/ops/rows.py:45-47)."""
    w = codes.shape[1]
    if w >= LANES:
        return codes
    pad = torch.full((codes.shape[0], LANES - w), PAD_CODE,
                     dtype=torch.uint8, device=codes.device)
    return torch.cat([codes, pad], dim=1)


def unpack_2bit(packed: torch.Tensor) -> torch.Tensor:
    """(N, W / 4) bytes of 2-bit codes, four a byte, low bits first (the
    runner's infeed) -> (N, W) u8 codes."""
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    return ((packed[..., None] >> shifts) & 3).reshape(
        packed.shape[0], packed.shape[1] * 4)


def _check_launch(codes: torch.Tensor, valid: torch.Tensor):
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a (N, W) uint8 tensor")
    valid = valid.to(device=codes.device, dtype=torch.int32).contiguous()
    if valid.shape != (codes.shape[0],):
        raise ValueError("valid must have shape (N,)")
    return valid


def _launch_b1(codes: torch.Tensor, valid: torch.Tensor, k: int,
               sketchlen: int, packed: bool):
    """Kernel B1 on (N, 128) codes or (N, W / 4 <= 32) packed bytes,
    rows contiguous from a 4-byte aligned start."""
    valid = _check_launch(codes, valid)
    codes = codes.contiguous()
    if codes.data_ptr() % 4:            # the kernel loads 4 codes a lane
        codes = codes.clone()
    n = codes.shape[0]
    out = torch.empty((n, sketchlen), dtype=torch.int32, device=codes.device)
    if n:
        kernels.SKETCH(codes.data_ptr(), valid.data_ptr(), out.data_ptr(),
                       n, codes.shape[1], k, sketchlen, int(packed))
    return out


def _check_k(k: int):
    if k > 16:
        raise NotImplementedError(
            "k > 16 needs the 64-bit feature sketch (ROADMAP queue A, "
            "u64 features)")


def sketch_windows(codes: torch.Tensor, valid: torch.Tensor, k: int,
                   sketchlen: int) -> torch.Tensor:
    """(N, W) u8 windows + (N,) valid lengths -> (N, sketchlen) int32
    (u32 bits), the dispatch of metacache_tpu/ops/rows.py:28-50. Windows
    of at most 128 characters are padded to 128 and go to kernel B1,
    wider ones to kernel B2, on a CUDA tensor; a CPU tensor takes the
    kernel's plain version."""
    _check_k(k)
    if codes.shape[1] > LANES:
        return _sketch_long(codes, valid, k, sketchlen)
    check_sketch_mode()
    codes = pad_windows(codes)
    if not codes.is_cuda:
        return sketch_windows_plain(codes, valid, k, sketchlen)
    return _launch_b1(codes, valid, k, sketchlen, False)


def sketch_windows_packed(packed: torch.Tensor, valid: torch.Tensor,
                          k: int, sketchlen: int) -> torch.Tensor:
    """(N, W / 4) bytes of W <= 128 2-bit codes a window, four a byte,
    low bits first (the runner's infeed, cropped to a stack's longest
    read; no ambiguous code), + (N,) valid lengths -> (N, sketchlen)
    int32, what ``sketch_windows`` gives on the unpacked (N, W) codes:
    kernel B1 reading the packed rows itself on a CUDA tensor; on a CPU
    tensor the unpack and B1's plain version."""
    _check_k(k)
    if packed.dtype != torch.uint8 or packed.dim() != 2 or \
            not 1 <= packed.shape[1] * 4 <= LANES:
        raise ValueError("packed must be a (N, W / 4) uint8 tensor, "
                         "W <= 128")
    check_sketch_mode()
    if not packed.is_cuda:
        return sketch_windows_plain(pad_windows(unpack_2bit(packed)), valid,
                                    k, sketchlen)
    return _launch_b1(packed, valid, k, sketchlen, True)


def _sketch_long(codes: torch.Tensor, valid: torch.Tensor, k: int,
                 sketchlen: int) -> torch.Tensor:
    """W > 128: kernel B2 on a CUDA tensor, its plain version on a CPU
    tensor. B2 loads codes a byte at a time with the row stride it is
    given, so rows of any width and alignment go in uncopied."""
    if not codes.is_cuda:
        return sketch_windows_long_plain(codes, valid, k, sketchlen)
    valid = _check_launch(codes, valid)
    n, w = codes.shape
    if codes.stride(1) != 1:
        codes = codes.contiguous()
    out = torch.empty((n, sketchlen), dtype=torch.int32, device=codes.device)
    if n:
        kernels.SKETCH_LONG(codes.data_ptr(), valid.data_ptr(),
                            out.data_ptr(), n, w, codes.stride(0), k,
                            sketchlen)
    return out
