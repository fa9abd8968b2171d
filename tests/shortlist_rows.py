"""Count sums whose rows hold the shortlist's edge cases: the rows that a
warp-per-pair shortlist gets wrong first. Plain numpy, no JAX, so the
card tests import it too.

``edge_rows(rng, O)`` returns the dict of [B, O] m, unk, candc (int32)
and lutsum (float32), and [B] flen, rlen, fo, ro (int32), for
``minoverlap = 3``, ``SL <= 8`` and ``O >= 128``. Rows:

0. an empty range (flen = rlen = 1): every score -inf, nothing examined;
1. every candidate -inf but the range examined: m = nvalid and unk = 0
   (flash's ratio is 0) and lutsum -inf;
2. stitch wraps at two offsets (m = 0, unk = 0: mm - m > 0);
3. LUT sums -1 but for five zeros, -0.0 and +0.0 mixed (ZERO_TIE_ROW);
4. LUT sums -1 but for ten equal values 2.5 in neighbouring lanes and in
   four different 32-offset words (more ties than SL);
5. k-mer hits at three offsets only: fewer finite scores than SL;
6. k-mer hits only below minoverlap: the whole range is examined;
7. random counts.
"""

import numpy as np

ZERO_TIE_ROW = 3
ZEROS = {3: -0.0, 7: 0.0, 40: -0.0, 41: 0.0, 70: -0.0}  # row 3: x -> zero
TIES = (5, 6, 37, 38, 69, 100, 101, 110, 111, 127)  # row 4: x of 2.5


def _nvalid(O, flen, rlen):
    o2 = np.arange(1, O + 1)[None, :]
    return np.maximum(0, np.minimum(o2, rlen[:, None])
                      - np.maximum(0, o2 - flen[:, None]))


def edge_rows(rng, O):
    B = 8
    flen = np.full(B, O, np.int32)
    rlen = np.full(B, O, np.int32)
    flen[0] = rlen[0] = 1
    flen[7] = rng.integers(O // 2, O + 1)
    rlen[7] = rng.integers(O // 2, O + 1)
    fo = np.zeros(B, np.int32)
    ro = np.zeros(B, np.int32)
    nvalid = _nvalid(O, flen, rlen)
    m = (rng.random((B, O)) * (nvalid + 1)).astype(np.int32)
    unk = (rng.random((B, O)) * (nvalid - m + 1)).astype(np.int32)
    candc = np.zeros((B, O), np.int32)
    lutsum = rng.normal(0.0, 20.0, (B, O)).astype(np.float32)

    m[0] = unk[0] = 0
    m[1], unk[1] = nvalid[1], 0
    lutsum[1] = -np.inf
    # row 2: m - mm = nvalid - 2 > 0 but for two wrapped offsets
    m[2], unk[2] = np.maximum(nvalid[2] - 1, 0), 0
    m[2, [50, 90]] = 0
    lutsum[3] = -1.0
    for x, z in ZEROS.items():
        lutsum[3, x] = z
    lutsum[4] = -1.0
    lutsum[4, list(TIES)] = 2.5
    candc[5, [10, 20, 64]] = [1, 2, 1]
    candc[6, [0, 1]] = 3
    candc[7] = (rng.random(O) < 0.05) * rng.integers(1, 4, O)
    return dict(m=m, unk=unk, candc=candc, lutsum=lutsum, flen=flen,
                rlen=rlen, fo=fo, ro=ro)
