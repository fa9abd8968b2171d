"""Nucleotide codec: 4-bit one-hot IUPAC encoding.

Mirrors the reference encoding (pandaseq-nt.h:35-59, nt.c:25-114):
  Z (invalid) = 0, A = 1, C = 2, G = 4, T = 8; IUPAC ambiguity codes are the
  bitwise OR of their members; N = 0x0F. Two ASCII decode tables exist, one
  plain and one complementing (used to load the reverse read already
  complemented, fastq.c:149,154). Match of two bases is (f & r) != 0; a base
  is "N" iff its code is exactly 0x0F (pandaseq-nt.h:59); a base is degenerate
  iff its popcount != 1 (pandaseq-nt.h:55).

Tables are numpy int8 arrays indexed by `ascii_byte & 0x1F`, exactly the
indexing the reference uses (nt.c:152-160).

The benchmark's frozen copy of ``pandaseq_tpu_torch/nt.py``, unchanged;
it imports nothing of the port, of ``pandaseq_tpu`` or of JAX.
"""

from __future__ import annotations

import numpy as np

from .tables import QUAL_SCORE, PHREDMAX

NT_Z = 0
NT_A = 1
NT_C = 2
NT_G = 4
NT_T = 8
NT_N = 0x0F

# IUPAC code -> ASCII, indexed by the 4-bit code (nt.c:25).
NT_TO_ASCII = np.frombuffer(b"NACMGRSVTWYHKDBN", dtype=np.uint8).copy()

# Complement per 4-bit code (nt.c:27-44).
COMPLEMENT = np.array(
    [0,  # Z
     NT_T,  # A -> T
     NT_G,  # C -> G
     NT_G | NT_T,  # M -> K
     NT_C,  # G -> C
     NT_C | NT_T,  # R -> Y
     NT_C | NT_G,  # S -> S
     NT_A | NT_C | NT_G,  # V (as in nt.c:35)
     NT_A,  # T -> A
     NT_A | NT_T,  # W -> W
     NT_A | NT_G,  # Y -> R
     NT_A | NT_C | NT_G,  # H (as in nt.c:39)
     NT_A | NT_C,  # K -> M
     NT_A | NT_C | NT_T,  # D (as in nt.c:41)
     NT_A | NT_C | NT_G,  # B (as in nt.c:42)
     NT_A | NT_C | NT_G | NT_T],  # N -> N
    dtype=np.int8)


def _letters(**kv) -> np.ndarray:
    """Build a 32-entry ascii&0x1F-indexed table from letter->code pairs."""
    t = np.zeros(32, dtype=np.int8)
    for ch, code in kv.items():
        t[ord(ch) & 0x1F] = code
    return t


# nt.c:46-79 (iupac_forward).
IUPAC_FORWARD = _letters(
    A=NT_A, B=NT_C | NT_G | NT_T, C=NT_C, D=NT_A | NT_G | NT_T,
    G=NT_G, H=NT_A | NT_C | NT_T, K=NT_G | NT_T, M=NT_A | NT_C,
    N=NT_N, R=NT_A | NT_G, S=NT_C | NT_G, T=NT_T, U=NT_T,
    V=NT_A | NT_C | NT_G, W=NT_A | NT_T, X=NT_N, Y=NT_C | NT_T)

# nt.c:81-114 (iupac_reverse): decode-and-complement in one step.
IUPAC_REVERSE = _letters(
    A=NT_T, B=NT_G | NT_C | NT_A, C=NT_G, D=NT_T | NT_C | NT_A,
    G=NT_C, H=NT_T | NT_G | NT_A, K=NT_C | NT_A, M=NT_T | NT_G,
    N=NT_N, R=NT_T | NT_C, S=NT_G | NT_C, T=NT_A, U=NT_A,
    V=NT_T | NT_G | NT_C, W=NT_T | NT_A, X=NT_N, Y=NT_G | NT_A)

_POPCOUNT4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.int8)


def nt_from_ascii(data) -> np.ndarray:
    """Vectorized panda_nt_from_ascii over a byte array."""
    return IUPAC_FORWARD[np.asarray(data, dtype=np.uint8) & 0x1F]


def nt_from_ascii_complement(data) -> np.ndarray:
    """Vectorized panda_nt_from_ascii_complement over a byte array."""
    return IUPAC_REVERSE[np.asarray(data, dtype=np.uint8) & 0x1F]


def nt_to_ascii(codes) -> np.ndarray:
    """Vectorized panda_nt_to_ascii (nt.c:167-173)."""
    return NT_TO_ASCII[np.asarray(codes, dtype=np.int8) & 0x0F]


def is_degenerate(codes) -> np.ndarray:
    """PANDA_NT_IS_DEGN: popcount != 1 (pandaseq-nt.h:55)."""
    return _POPCOUNT4[np.asarray(codes) & 0x0F] != 1


def is_n(codes) -> np.ndarray:
    """PANDA_NT_IS_N: code == 0x0F exactly (pandaseq-nt.h:59)."""
    return (np.asarray(codes) & 0x0F) == NT_N


def _result_phred_scalar(p: float) -> int:
    """Literal port of the panda_result_phred binary search (nt.c:126-150)."""
    lower, upper = 0, PHREDMAX
    if p <= QUAL_SCORE[0]:
        return 1
    while lower < upper:
        mid = lower + (upper - lower) // 2
        if QUAL_SCORE[mid] == p:
            return mid
        if mid == lower:
            return lower
        elif QUAL_SCORE[mid] > p:
            upper = mid
        else:
            lower = mid + 1
    return lower


def _build_phred_intervals():
    """Tabulate the C search's answer for every exact table value and every
    open interval between consecutive table values, so the vectorized version
    reproduces it bit-for-bit (including its quirky no-final-compare exit)."""
    exact = np.array([_result_phred_scalar(v) for v in QUAL_SCORE],
                     dtype=np.int8)
    # Interval k = (QUAL_SCORE[k-1], QUAL_SCORE[k]) for k in 1..46, plus
    # below-table (handled by the p <= qual_score[0] early-out) and
    # above-table (k = 47).
    reps = []
    for k in range(1, PHREDMAX + 1):
        reps.append((QUAL_SCORE[k - 1] + QUAL_SCORE[k]) / 2.0)
    reps.append(QUAL_SCORE[PHREDMAX] + 1.0)
    interval = np.array([_result_phred_scalar(r) for r in reps], dtype=np.int8)
    return exact, interval


_PHRED_EXACT, _PHRED_INTERVAL = _build_phred_intervals()


def result_phred(p) -> np.ndarray:
    """Vectorized panda_result_phred (nt.c:126-150): re-quantize a log
    probability onto the PHRED scale, bit-identical to the C binary search."""
    p = np.asarray(p, dtype=np.float64)
    idx = np.searchsorted(QUAL_SCORE, p, side="left")
    hit = (idx <= PHREDMAX) & (QUAL_SCORE[np.minimum(idx, PHREDMAX)] == p)
    out = np.where(hit, _PHRED_EXACT[np.minimum(idx, PHREDMAX)],
                   _PHRED_INTERVAL[np.maximum(idx, 1) - 1])
    out = np.where(p <= QUAL_SCORE[0], np.int8(1), out)
    return out.astype(np.int8)
