"""Edge rows for the per-diagonal LUT sums of pear / rdp_mle (K7): the
inputs a table-gather design gets wrong first. Shared by the CPU tests
(the plain version against the JAX package, tests/test_torch_lut.py) and
the card tests and smoke (the lut_sums kernel against its plain
version)."""

import numpy as np

# one-hot bases, repeated so that they dominate, and a few degenerate codes
_CODES = np.array([1, 2, 4, 8] * 3 + [5, 10, 3], np.uint8)
KINDS = ("interior pads", "forward N run", "reverse N run",
         "quals outside [0, 46]", "all pads", "flen 0", "rlen 0",
         "stale forward tail")


def lut_edge_rows(rng, B, L):
    """(fwd, rev, fr_q, rr_q, flen, rlen): forward / reverse nibbles
    [B, L] uint8 (0 a pad, 0x0F N), qual planes [B, L] int8 and lengths
    [B] int32; row b is of kind ``KINDS[b % 8]``:

    0. pads (nibble 0) inside both reads, not only past their ends;
    1. / 2. a run of N in the forward / the reverse read;
    3. quals over the whole int8 range on both sides (clipped to
       [0, 46]);
    4. no bases at all (flen = rlen = 0, every nibble a pad), with
       stale quals;
    5. / 6. flen = 0 / rlen = 0 with the other read full;
    7. flen < rlen with nonzero quals past flen: pear reads the stale
       forward tail.

    Outside kind 3 the quals are mostly the common 2 and 11-41, with a
    few 0-46 others."""
    fwd = _CODES[rng.integers(0, len(_CODES), (B, L))]
    rev = _CODES[rng.integers(0, len(_CODES), (B, L))]
    common = np.r_[2, 11:42]
    fr_q = common[rng.integers(0, len(common), (B, L))].astype(np.int8)
    rr_q = common[rng.integers(0, len(common), (B, L))].astype(np.int8)
    few = rng.random((2, B, L)) < 0.1
    fr_q[few[0]] = rng.integers(0, 47, int(few[0].sum()))
    rr_q[few[1]] = rng.integers(0, 47, int(few[1].sum()))
    flen = rng.integers(L // 2, L + 1, B).astype(np.int32)
    rlen = rng.integers(L // 2, L + 1, B).astype(np.int32)
    pos = np.arange(L)
    for b in range(B):
        kind = b % 8
        if kind == 0:
            fwd[b, rng.random(L) < 0.1] = 0
            rev[b, rng.random(L) < 0.1] = 0
        elif kind in (1, 2):
            lo = int(rng.integers(0, L // 2))
            (fwd if kind == 1 else rev)[b, lo:lo + int(
                rng.integers(3, L // 4))] = 15
        elif kind == 3:
            fr_q[b] = rng.integers(-128, 128, L)
            rr_q[b] = rng.integers(-128, 128, L)
        elif kind == 4:
            flen[b] = rlen[b] = 0
        elif kind == 5:
            flen[b], rlen[b] = 0, L
        elif kind == 6:
            flen[b], rlen[b] = L, 0
        else:
            flen[b] = int(rng.integers(1, L // 2))
            rlen[b] = int(rng.integers(flen[b] + 1, L + 1))
            fr_q[b, flen[b]:] = rng.integers(30, 47, L - flen[b])
    fwd[pos[None, :] >= flen[:, None]] = 0
    rev[pos[None, :] >= rlen[:, None]] = 0
    return fwd, rev, fr_q, rr_q, flen, rlen
