# copied from metacache_tpu/classify/alignment.py
"""Semi-global alignment for the optional `-align` display.

Mirrors the reference scheme (src/alignment.hpp:88-293 and
make_semi_global_alignment, src/classification.cpp:74-100): match +2,
mismatch -1, gap -1; free end gaps on the subject; both the query and its
reverse complement are aligned and the better score wins. The subject
window is re-read from the target's source FASTA at query time
(src/classification.cpp:384-426) — alignment is a display feature, not a
classification input.
"""
from __future__ import annotations

import numpy as np

MATCH = 2
MISMATCH = -1
GAP = -1

_COMP = bytes.maketrans(b"ACGTacgtUu", b"TGCAtgcaAa")


def reverse_complement(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


def align_semi_global_score(query: bytes, subject: bytes) -> int:
    """Score-only semi-global alignment (free leading/trailing subject
    gaps). Vectorized anti-diagonal-free DP over subject columns."""
    q = np.frombuffer(query, dtype=np.uint8)
    s = np.frombuffer(subject, dtype=np.uint8)
    if len(q) == 0 or len(s) == 0:
        return 0
    # DP row over subject; free gaps along subject (row 0 = 0)
    prev = np.zeros(len(s) + 1, dtype=np.int32)
    for i in range(len(q)):
        cur = np.empty_like(prev)
        cur[0] = (i + 1) * GAP  # leading gaps in subject cost on query
        sub = np.where(s == q[i], MATCH, MISMATCH).astype(np.int32)
        diag = prev[:-1] + sub
        up = prev[1:] + GAP
        # left dependency is sequential: use running max via scan
        best = np.maximum(diag, up)
        cur[1:] = best
        np.maximum.accumulate(cur + np.arange(len(s) + 1, dtype=np.int32)
                              * (-GAP), out=cur)  # prefix trick for gaps
        cur -= np.arange(len(s) + 1, dtype=np.int32) * (-GAP)
        prev = cur
    return int(prev.max())


def align_semi_global(query: bytes, subject: bytes):
    """Full DP with backtrace -> (score, aligned_query, aligned_subject).

    O(len(q)*len(s)) memory; intended for the -align display of single
    top hits only (the reference warns it is slow too,
    src/printing.cpp:105: '=> SLOW!')."""
    q = np.frombuffer(query, dtype=np.uint8)
    s = np.frombuffer(subject, dtype=np.uint8)
    nq, ns = len(q), len(s)
    score = np.zeros((nq + 1, ns + 1), dtype=np.int32)
    move = np.zeros((nq + 1, ns + 1), dtype=np.uint8)  # 0 diag 1 up 2 left
    score[:, 0] = np.arange(nq + 1) * GAP
    move[1:, 0] = 1
    for i in range(1, nq + 1):
        sub = np.where(s == q[i - 1], MATCH, MISMATCH).astype(np.int32)
        diag = score[i - 1, :-1] + sub
        up = score[i - 1, 1:] + GAP
        row = np.maximum(diag, up)
        mv = np.where(diag >= up, 0, 1).astype(np.uint8)
        # left moves: sequential prefix-max trick
        adj = row + np.arange(1, ns + 1, dtype=np.int32) * (-GAP)
        run = np.maximum.accumulate(adj)
        left_better = run > adj
        row = run - np.arange(1, ns + 1, dtype=np.int32) * (-GAP)
        mv = np.where(left_better, 2, mv).astype(np.uint8)
        score[i, 1:] = row
        move[i, 1:] = mv
    j = int(np.argmax(score[nq, :]))
    best = int(score[nq, j])
    i = nq
    aq, asub = [], []
    while i > 0:
        m = move[i, j]
        if m == 0 and j > 0:
            aq.append(q[i - 1])
            asub.append(s[j - 1])
            i -= 1
            j -= 1
        elif m == 1 or j == 0:
            aq.append(q[i - 1])
            asub.append(ord("-"))
            i -= 1
        else:
            aq.append(ord("-"))
            asub.append(s[j - 1])
            j -= 1
    return best, bytes(reversed(aq)), bytes(reversed(asub))


def make_semi_global_alignment(query1: bytes, query2: bytes,
                               subject: bytes):
    """Align query (and mate) forward + reverse complement, keep the
    better orientation (reference: src/classification.cpp:74-100)."""
    fwd = align_semi_global(query1, subject)
    rev = align_semi_global(reverse_complement(query1), subject)
    score_f, score_r = fwd[0], rev[0]
    if query2:
        score_f += align_semi_global_score(query2, subject)
        score_r += align_semi_global_score(reverse_complement(query2),
                                           subject)
    return (fwd if score_f > score_r else rev), max(score_f, score_r)
