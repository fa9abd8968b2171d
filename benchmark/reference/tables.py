"""PHRED probability lookup tables.

The reference generates these tables at build time (mktable.c, tablebuilder.c)
into a C source file. Two details of that generation pipeline are load-bearing
for bit-identical output:

1. PROBABILITY(score) = 10**(-score/10), PHRED scores clamped to 0..46
   (prob.h:21-23, PHREDMAX=46).
2. Every emitted value -- array entries and the qual_nn constant -- is printed
   with printf "%g", i.e. rounded to SIX significant decimal digits
   (tablebuilder.c:86,147 and panda_tbld_constant at tablebuilder.c:124).
   The reference binary therefore computes with 6-sig-digit constants, and so
   do we.

Formulas (mktable.c):
  qual_score[i]            = log(1 - p), but -2 when p == 1   (mktable.c:63-73)
  qual_score_err[i]        = log(p)                            (mktable.c:75-82)
  match_simple_bayesian    = (1-p)(1-q) + pq/3                 (mktable.c:23-31)
  mismatch_simple_bayesian = (1-p)q/3 + (1-q)p/3 + 2pq/9       (mktable.c:33-41)
  qual_nn_simple_bayesian  = log(0.25)                         (mktable.c:141)
All matrices are emitted as log(formula) over PHRED 0..46 in both axes.

The benchmark's frozen copy of ``pandaseq_tpu_torch/tables.py``, cut to
the tables the simple_bayesian scorer reads; it imports nothing of the
port, of ``pandaseq_tpu`` or of JAX. The formulas and their %g rounding
are the port's own transcription of mktable.c: a fault in them is on
both sides of the check, which cannot see it.
"""

from __future__ import annotations

import math

import numpy as np

PHREDMAX = 46  # prob.h:22
N_PHRED = PHREDMAX + 1


def _g(x: float) -> float:
    """Round a double through printf '%g' (6 significant digits), as the
    reference's table generator does when emitting C source."""
    return float("%g" % x)


def probability(score: int) -> float:
    """PROBABILITY(score) from prob.h:21."""
    return 10.0 ** (-float(score) / 10.0)


def _array_prob(formula, log_output: bool) -> np.ndarray:
    out = np.empty(N_PHRED, dtype=np.float64)
    for i in range(N_PHRED):
        v = formula(probability(i))
        out[i] = _g(math.log(v) if log_output else v)
    return out


def _matrix_prob(formula, log_output: bool = True) -> np.ndarray:
    out = np.empty((N_PHRED, N_PHRED), dtype=np.float64)
    for i in range(N_PHRED):
        p = probability(i)
        for j in range(N_PHRED):
            q = probability(j)
            v = formula(p, q)
            out[i, j] = _g(math.log(v) if log_output else v)
    return out


def _score(p):  # mktable.c:63-73
    if p == 1.0:
        return -2.0
    return math.log(1.0 - p)


def _match_sb(p, q):  # mktable.c:23-31
    return (1 - p) * (1 - q) + p * q / 3


def _mismatch_sb(p, q):  # mktable.c:33-41
    return (1 - p) * q / 3 + (1 - q) * p / 3 + 2 * p * q / 9


# The constant is emitted as a "#define ... %g" (tablebuilder.c:124), so the
# reference compiles against the 6-significant-digit value -1.38629.
QUAL_NN_SIMPLE_BAYESIAN = _g(math.log(0.25))

# log(1-p) per PHRED, rounded; qual_score[0] == -2 by the p==1 special case.
QUAL_SCORE = _array_prob(_score, log_output=False)
# log(p) per PHRED.
QUAL_SCORE_ERR = _array_prob(lambda p: math.log(p), log_output=False)

QUAL_MATCH_SIMPLE_BAYESIAN = _matrix_prob(_match_sb)
QUAL_MISMATCH_SIMPLE_BAYESIAN = _matrix_prob(_mismatch_sb)

