"""Public k-mer iteration utilities (iter.c / pandaseq-iter.h).

The port's own copy of ``pandaseq_tpu/kmer_iter.py``, over the port's
oracle (``oracle.kmer_emissions``, ``oracle.KMER_LEN``).

The reference exposes a reusable iterator over the k-mers of a
sequence, forward or reverse, with configurable k (clamped to 1..32,
iter.c:137-148), skipping degenerate bases (an N resets the window,
misc.h:41-43). The three constructors panda_iterate_nt / _qual /
_result differ only in the element type they read nucleotides from;
here the nt-code array is the common currency, so ``iterate_qual`` /
``iterate_result`` accept the (nt, qual) / result records' nt arrays
directly. This wraps the oracle's verified FOREACH_KMER
reimplementation with the panda_iterate_* / panda_iter_next surface.
"""

from __future__ import annotations

import numpy as np

from .oracle import KMER_LEN, kmer_emissions

__all__ = ["KMER_LEN", "kmers_of", "iterate", "iterate_qual",
           "iterate_result"]


def _clamp_k(k: int | None) -> int:
    """iter_new's clamp (iter.c:144-148): k < 1 -> KMER_LEN; cap at 32
    (sizeof(size_t) * 4 on LP64)."""
    if k is None or k < 1:
        return KMER_LEN
    return min(int(k), 32)


def kmers_of(nt, length: int | None = None, reverse: bool = False,
             k: int | None = None):
    """All emitted (kmer, position) pairs of a 4-bit-coded sequence as
    (values int64[], positions int64[]) arrays."""
    nt = np.asarray(nt)
    n = len(nt) if length is None else int(length)
    pairs = kmer_emissions(nt, n, reverse, _clamp_k(k))
    if not pairs:
        return (np.empty(0, dtype=np.int64),) * 2
    vals, poss = zip(*pairs)
    return np.asarray(vals, dtype=np.int64), np.asarray(poss,
                                                        dtype=np.int64)


def iterate(nt, length: int | None = None, reverse: bool = False,
            k: int | None = None):
    """panda_iterate_nt / panda_iter_next as a generator of
    (kmer, posn) tuples (pandaseq-iter.h)."""
    nt = np.asarray(nt)
    n = len(nt) if length is None else int(length)
    yield from kmer_emissions(nt, n, reverse, _clamp_k(k))


def iterate_qual(nt, length: int | None = None, reverse: bool = False,
                 k: int | None = None):
    """panda_iterate_qual (iter.c:152): iterate the nt codes of a
    panda_qual sequence (the qual bytes do not affect emission)."""
    yield from iterate(nt, length, reverse, k)


def iterate_result(result_nt, length: int | None = None,
                   reverse: bool = False, k: int | None = None):
    """panda_iterate_result (iter.c:176): iterate a merged result's nt
    codes (e.g. OracleResult.sequence_nt[:sequence_length])."""
    yield from iterate(result_nt, length, reverse, k)
