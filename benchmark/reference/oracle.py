"""Reference-semantics oracle: exact f64 reimplementation of the assembly
math, one pair at a time.

This module is the ground-truth anchor between the C reference and the TPU
pipeline: it reproduces assembler.c's align()/assemble_seq() decision-for-
decision (k-mer candidate seeding, per-algorithm overlap scoring with the
original summation order, reconstruction with B-cliff masking, the
divide-by-len+1 quality) so its FASTA/FASTQ output is byte-identical to the
reference binary. The production TPU path is tested against it, and its
per-algorithm f64 formulas are reused by the host finalization stage.

Cited reference behavior:
  k-mer seeding      assembler.c:91-118, misc.h:32-45
  candidate scoring  assembler.c:120-143
  reconstruction     assembler.c:145-248
  pipeline           assembler.c:252-348
  algorithms         algo_*.c (see each scorer)
  primer location    offset.c:47-133

The benchmark's frozen copy of ``pandaseq_tpu_torch/oracle.py``; it
imports nothing of the port, of ``pandaseq_tpu`` or of JAX. One change:
every floating-point result of the simple_bayesian scorer, the
reconstruction and the primer scan passes through ``fp`` (the
``OracleConfig`` field, and ``SimpleBayes``'s argument). ``float``, the
default, keeps IEEE double, as PANDAseq computes; the benchmark's control
passes a rounding to float32 (``reference.merge.PRECISIONS``) to compute
the same steps one precision lower. Only the simple_bayesian scorer, the
one the configurations run, is kept.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import tables
from .nt import NT_TO_ASCII, is_degenerate, is_n
from .tables import (QUAL_MATCH_SIMPLE_BAYESIAN,
                     QUAL_MISMATCH_SIMPLE_BAYESIAN, QUAL_NN_SIMPLE_BAYESIAN,
                     QUAL_SCORE, QUAL_SCORE_ERR)

MAX_LEN = 450  # configure.ac:8; used for the 2*MAX_LEN result bound
KMER_LEN = 8  # misc.h:33
_KMER_MASK = (1 << (2 * KMER_LEN)) - 1

# 2-bit packing: T=3, G=2, C=1, everything else (incl. degenerate) = 0
# (misc.h:41). N (code 15) additionally resets the window.
_KMER_CODE = np.zeros(16, dtype=np.int64)
_KMER_CODE[8] = 3  # T
_KMER_CODE[4] = 2  # G
_KMER_CODE[2] = 1  # C


def _clamp(q: int) -> int:
    return 0 if q < 0 else (46 if q > 46 else int(q))


# --------------------------------------------------------------------------
# Algorithms (L4). Each provides overlap_probability (exact C summation
# order) and match_probability, both in f64.
# --------------------------------------------------------------------------

class Algorithm:
    name = "?"
    prob_unpaired = QUAL_NN_SIMPLE_BAYESIAN  # all classes use this constant

    def overlap_probability(self, fwd_nt, fwd_q, flen, rev_nt, rev_q, rlen,
                            overlap) -> float:
        raise NotImplementedError

    def match_probability(self, match: bool, a: int, b: int) -> float:
        raise NotImplementedError


def _iter_overlap(flen, rlen, overlap):
    """Yield (findex, rindex) for valid positions (the shared index-guard
    loop in every algo_*.c overlap_probability)."""
    for i in range(overlap):
        findex = flen + i - overlap
        rindex = rlen - i - 1
        if findex < 0 or rindex < 0 or findex >= flen or rindex >= rlen:
            continue
        yield findex, rindex


def _count_overlap(fwd_nt, flen, rev_nt, rlen, overlap):
    """Shared match/mismatch/unknown counting (algo_simple_bayes.c:45-59)."""
    matches = mismatches = unknowns = 0
    for findex, rindex in _iter_overlap(flen, rlen, overlap):
        f = int(fwd_nt[findex])
        r = int(rev_nt[rindex])
        if f == 0x0F or r == 0x0F:
            unknowns += 1
        elif (f & r) != 0:
            matches += 1
        else:
            mismatches += 1
    return matches, mismatches, unknowns


class SimpleBayes(Algorithm):
    """algo_simple_bayes.c; default error estimation 0.36 (line 113)."""

    name = "simple_bayesian"

    def __init__(self, q: float = 0.36, fp=float):
        self.q = q
        self.fp = fp
        # set_error_estimation (algo_simple_bayes.c:126-135): computed at
        # runtime in full double precision (NOT %g-rounded).
        self.pmatch = fp(math.log(0.25 * (1 - 2 * q + q * q)))
        self.pmismatch = fp(math.log((3 * q - 2 * q * q) / 18.0))

    def overlap_probability(self, fwd_nt, fwd_q, flen, rev_nt, rev_q, rlen,
                            overlap):
        fp = self.fp
        m, mm, unk = _count_overlap(fwd_nt, flen, rev_nt, rlen, overlap)
        if overlap >= flen and overlap >= rlen:
            unpaired = unk
        else:
            unpaired = flen + rlen - 2 * overlap + unk
        return fp(fp(fp(fp(QUAL_NN_SIMPLE_BAYESIAN) * unpaired)
                     + fp(m * self.pmatch)) + fp(mm * self.pmismatch))

    def match_probability(self, match, a, b):
        t = QUAL_MATCH_SIMPLE_BAYESIAN if match \
            else QUAL_MISMATCH_SIMPLE_BAYESIAN
        return self.fp(t[_clamp(a), _clamp(b)])


# --------------------------------------------------------------------------
# K-mer candidate seeding (assembler.c:91-118)
# --------------------------------------------------------------------------

def kmer_emissions(nt: np.ndarray, length: int, reverse: bool,
                   k: int = KMER_LEN):
    """Positions at which FOREACH_KMER emits, with their k-mer values
    (misc.h:41-43). The window emits only once `bad` reaches zero, i.e.
    the first emission happens at the (k+1)-th base examined; an N
    resets the counter. ``k`` defaults to the assembler's KMER_LEN; the
    public iterator (iter.c:137-148) allows 1..32."""
    out = []
    kmer = 0
    bad = k
    mask = (1 << (2 * k)) - 1
    rng = range(length - 1, -1, -1) if reverse else range(length)
    for p in rng:
        code = int(_KMER_CODE[int(nt[p]) & 0x0F])
        kmer = ((kmer << 2) | code) & mask
        if (int(nt[p]) & 0x0F) == 0x0F:
            bad = k
        elif bad > 0:
            bad -= 1
        else:
            out.append((kmer, p))
    return out


def candidate_mask(fwd_nt, flen, rev_nt, rlen, minoverlap, maxoverlap,
                   num_kmers=2, dbg=None):
    """Build the candidate-overlap bit list (assembler.c:84-118). Returns a
    bool array indexed by counter = overlap - minoverlap."""
    bits_size = (maxoverlap - minoverlap + 1) if minoverlap <= maxoverlap \
        else 1
    bits = np.zeros(bits_size, dtype=bool)
    if num_kmers >= 3:
        # FAITHFUL kmerseen simulation: the reference's occupancy
        # check indexes kmerseen[(KMER << 1) + j] (hardcoded for
        # num_kmers == 2) while stores go to kmerseen[KMER*num_kmers+j]
        # (assembler.c:94-99), so for -k >= 3 k-mers are dropped /
        # overwritten through other k-mers' slots — deterministic and
        # reproduced literally here. (-k 1 makes the same check read
        # past the table: real UB, not reproducible; PARITY.md.)
        tab = np.zeros((1 << 16) * num_kmers + 131072, dtype=np.uint16)
        for kmer, p in kmer_emissions(fwd_nt, flen, reverse=False):
            if dbg is not None:  # assembler.c:93
                dbg(8, "FMER", "%d@%d" % (kmer, p))
            j = 0
            while j < num_kmers and tab[(kmer << 1) + j] != 0:
                j += 1
            if j < num_kmers:
                tab[kmer * num_kmers + j] = p  # KMER_POSITION >= 8
            elif dbg is not None:  # assembler.c:97
                dbg(1, "LOST_KMER", "%d@%d" % (kmer, p))
        for kmer, p in kmer_emissions(rev_nt, rlen, reverse=True):
            if dbg is not None:  # assembler.c:105
                dbg(8, "RMER", "%d@%d" % (kmer, p))
            for j in range(num_kmers):
                fp = int(tab[kmer * num_kmers + j])
                if fp == 0:
                    break
                index = flen + rlen - p - fp - minoverlap - 1
                if 0 <= index < bits_size:
                    bits[index] = True
        if not bits.any():
            bits[:] = True  # ALL_BITS_IF_NONE (assembler.c:42,118)
        return bits
    seen: dict[int, list[int]] = {}
    for kmer, p in kmer_emissions(fwd_nt, flen, reverse=False):
        if dbg is not None:  # assembler.c:93
            dbg(8, "FMER", "%d@%d" % (kmer, p))
        slots = seen.setdefault(kmer, [])
        if len(slots) < num_kmers:
            slots.append(p)
        elif dbg is not None:  # assembler.c:97
            dbg(1, "LOST_KMER", "%d@%d" % (kmer, p))
    for kmer, p in kmer_emissions(rev_nt, rlen, reverse=True):
        if dbg is not None:  # assembler.c:105
            dbg(8, "RMER", "%d@%d" % (kmer, p))
        for fp in seen.get(kmer, ()):
            index = flen + rlen - p - fp - minoverlap - 1
            if 0 <= index < bits_size:
                bits[index] = True
    if not bits.any():
        bits[:] = True  # ALL_BITS_IF_NONE (assembler.c:42,118)
    return bits


# --------------------------------------------------------------------------
# Alignment + reconstruction (assembler.c:48-250)
# --------------------------------------------------------------------------

@dataclass(slots=True)
class OracleResult:
    sid: object = None
    sequence_length: int = 0
    quality: float = 0.0
    overlap: int = 0
    overlaps_examined: int = 0
    overlap_mismatches: int = 0
    degenerates: int = 0
    estimated_overlap_probability: float = 0.0
    forward_offset: int = 0
    reverse_offset: int = 0
    slow: bool = False
    forward_length: int = 0  # panda_result_seq.forward_length
    reverse_length: int = 0
    sequence_ascii: np.ndarray = None  # device-encoded ascii (fast path)
    sequence: str = None  # ascii string set by api.Assembler.assemble
    # lazy backing for sequence_nt / sequence_p: the batched native
    # path hands out B results per batch and most consumers touch only
    # a few fields, so the two table gathers are deferred to first use
    _nt: np.ndarray = field(default=None, repr=False)
    _p: np.ndarray = field(default=None, repr=False)
    _pidx: np.ndarray = field(default=None, repr=False)
    _ptbl: np.ndarray = field(default=None, repr=False)

    @property
    def sequence_nt(self) -> np.ndarray:  # [len] int8
        nt_ = self._nt
        if nt_ is None and self.sequence_ascii is not None:
            from .nt import IUPAC_FORWARD
            nt_ = self._nt = IUPAC_FORWARD[self.sequence_ascii & 0x1F]
        return nt_

    @sequence_nt.setter
    def sequence_nt(self, v):
        self._nt = v

    @property
    def sequence_p(self) -> np.ndarray:  # [len] f64 log-probabilities
        p = self._p
        if p is None and self._pidx is not None:
            p = self._p = self._ptbl[self._pidx]
        return p

    @sequence_p.setter
    def sequence_p(self, v):
        self._p = v


@dataclass
class OracleConfig:
    algorithm: Algorithm = field(default_factory=SimpleBayes)
    minoverlap: int = 2  # assembler_support.c:96
    maxoverlap: int = 0  # 0 => read length (assembler.c:78-79)
    threshold: float = math.log(0.6)  # assembler_support.c:76
    forward_primer: np.ndarray | None = None  # int8 nt codes
    reverse_primer: np.ndarray | None = None
    forward_trim: int = 0
    reverse_trim: int = 0
    primer_penalty: float = 0.0
    post_primers: bool = False
    num_kmers: int = 2
    fp: object = float  # rounding of each floating-point result


def align(cfg: OracleConfig, fwd_nt, fwd_q, flen, rev_nt, rev_q, rlen,
          forward_offset: int, reverse_offset: int, dbg=None):
    """align() from assembler.c:48-250. Returns (OracleResult|None, code).

    ``dbg(flag_bit, code, message)`` receives the reference's per-stage
    debug lines (assembler.c LOG/LOGV call sites) when given; the hot
    batched path never passes it (debug mode routes through this exact
    per-pair implementation)."""
    algo = cfg.algorithm
    fp = cfg.fp
    qual_nn = fp(algo.prob_unpaired)
    fo, ro = forward_offset, reverse_offset

    maxoverlap = flen + rlen - cfg.minoverlap - fo - ro - 1
    bestprobability = fp(qual_nn * (flen + rlen))
    bestoverlap = -1

    if cfg.minoverlap + fo >= flen or cfg.minoverlap + ro >= rlen:
        return None, "NEGS"
    if cfg.maxoverlap == 0:
        maxoverlap = min(flen, rlen)
    elif maxoverlap > cfg.maxoverlap:
        maxoverlap = cfg.maxoverlap

    bits = candidate_mask(fwd_nt, flen, rev_nt, rlen, cfg.minoverlap,
                          maxoverlap, cfg.num_kmers, dbg=dbg)

    res = OracleResult()
    res.overlaps_examined = 0
    for counter in np.flatnonzero(bits):
        overlap = int(counter) + cfg.minoverlap
        probability = algo.overlap_probability(
            fwd_nt, fwd_q, flen, rev_nt, rev_q, rlen, overlap)
        if dbg is not None:  # assembler.c:127
            dbg(16, "OLD", "overlap = %d probability = %f"
                % (overlap, probability))
        if probability > bestprobability and overlap >= cfg.minoverlap:
            bestprobability = probability
            bestoverlap = overlap
        res.overlaps_examined += 1

    res.slow = res.overlaps_examined == maxoverlap - cfg.minoverlap + 1
    if dbg is not None:  # assembler.c:139
        dbg(1, "BESTOLP", "%d" % bestoverlap)
    # BESTOLP is logged for every aligned-attempted pair, including
    # bestoverlap == -1 (assembler.c:139 runs before the -1 return);
    # expose the value so batch BESTOLP emission matches
    res.overlap = bestoverlap

    if bestoverlap == -1:
        return res, "NOALGN"

    length = flen - fo - bestoverlap + rlen - ro + 1
    if length <= 0:
        return res, "NEGS"
    if length > 2 * MAX_LEN:
        return res, "OOM"
    res.sequence_length = length - 1
    res.degenerates = 0

    df = flen - fo - bestoverlap
    dr = rlen - ro - bestoverlap
    veez_df = max(df, 0)
    wedge_df = min(df, 0)
    wedge_dr = min(dr, 0)

    if dbg is not None:  # assembler.c:161
        dbg(16, "RECR", "bestoverlap = %d, dforward = %d, dreverse = %d, "
            "len = %d" % (bestoverlap, df, dr, length))
    seq_nt = np.zeros(2 * MAX_LEN, dtype=np.int8)
    seq_p = np.zeros(2 * MAX_LEN, dtype=np.float64)
    fquality = 0.0
    oquality = 0.0
    rquality = 0.0

    # Unpaired forward copy (assembler.c:162-173)
    for i in range(veez_df):
        findex = i + fo
        fbits = int(fwd_nt[findex])
        q = fp(QUAL_SCORE[_clamp(fwd_q[findex])])
        seq_nt[i] = fbits
        seq_p[i] = q
        if is_degenerate(fbits):
            res.degenerates += 1
        fquality = fp(fquality + q)
        if dbg is not None:  # assembler.c:172
            dbg(16, "BUILD", "S[%d] = F[%d] = %c"
                % (i, findex, NT_TO_ASCII[fbits]))

    # B-cliff masking (assembler.c:176-177)
    uf = flen
    while uf > 0 and fwd_q[uf - 1] == 2:
        uf -= 1
    ur = rlen
    while ur > 0 and rev_q[ur - 1] == 2:
        ur -= 1

    # Overlap merge (assembler.c:180-228)
    res.overlap_mismatches = 0
    for i in range(bestoverlap + wedge_df + wedge_dr):
        index = veez_df + i
        findex = fo + veez_df + i
        rindex = rlen - i - 1 + wedge_df
        if (index < 0 or findex < 0 or rindex < 0 or findex >= flen
                or rindex >= rlen):
            continue
        f = int(fwd_nt[findex])
        r = int(rev_nt[rindex])
        ismatch = (r & f) != 0
        fpr = qual_nn if findex >= uf \
            else fp(QUAL_SCORE[_clamp(fwd_q[findex])])
        rpr = qual_nn if rindex >= ur \
            else fp(QUAL_SCORE[_clamp(rev_q[rindex])])
        if not ismatch:
            if dbg is not None:  # assembler.c:198
                dbg(32, "MISM", "(F[%d] = %c) != (R[%d] = %c)"
                    % (findex, NT_TO_ASCII[f], rindex, NT_TO_ASCII[r]))
            res.overlap_mismatches += 1
        if findex >= uf and rindex >= ur:
            q = qual_nn
        elif findex >= uf:
            q = rpr
        elif rindex >= ur:
            q = fpr
        else:
            q = algo.match_probability(ismatch, int(fwd_q[findex]),
                                       int(rev_q[rindex]))
        if ismatch:
            nt = r & f
        else:
            nt = r if fwd_q[findex] < rev_q[rindex] else f
        seq_nt[index] = nt
        seq_p[index] = q
        if is_degenerate(nt):
            res.degenerates += 1
        oquality = fp(oquality + q)
        if dbg is not None:  # assembler.c:227
            dbg(16, "BUILD", "S[%d] = %c, F[%d] = %c, R[%d] = %c"
                % (index, NT_TO_ASCII[nt], findex, NT_TO_ASCII[f],
                   rindex, NT_TO_ASCII[r]))

    # Unpaired reverse copy (assembler.c:231-243)
    for i in range(max(dr, 0)):
        index = df + bestoverlap + i
        rindex = rlen - bestoverlap - i - 1
        rbits = int(rev_nt[rindex])
        q = fp(QUAL_SCORE[_clamp(rev_q[rindex])])
        rquality = fp(rquality + q)
        seq_nt[index] = rbits
        seq_p[index] = q
        if is_degenerate(rbits):
            res.degenerates += 1
        if dbg is not None:  # assembler.c:242
            dbg(16, "BUILD", "S[%d] = R[%d] = %c"
                % (index, rindex, NT_TO_ASCII[rbits]))

    res.quality = fp(fp(fp(fquality + rquality) + oquality) / length)
    res.overlap = bestoverlap
    res.estimated_overlap_probability = bestprobability
    res.sequence_nt = seq_nt
    res.sequence_p = seq_p
    return res, "OK"


def log1mexp(p: float) -> float:
    """panda_log1mexp (offset.c:35-38).

    FAITHFUL QUIRK: the reference calls this with NEGATIVE log
    probabilities (result_base_score, offset.c:114-122), for which
    log(-expm1(-p)) is the log of a negative number == NaN in C. The NaN
    propagates through the alignment sum, so post-assembly primer location
    (-a) only ever accepts alignments where every non-N primer base
    matches. We reproduce the NaN rather than 'fixing' the math.
    """
    with np.errstate(invalid="ignore", divide="ignore"):
        if p > math.log(2):
            return float(np.log1p(-np.exp(-p)))
        return float(np.log(-np.expm1(-p)))


def compute_offset(threshold, penalty, reverse, bases_nt, probs, notprobs,
                   seq_length, primer, fp=float):
    """computeoffset (offset.c:47-90), reformulated: the circular-buffer
    recurrence only ever surfaces complete alignments, checked at
    index = start + primerlen, so alignments that would end exactly at the
    last base are never checked (a faithful quirk).

    probs/notprobs are the per-position match / mismatch log scores
    already derived from the sequence (qual or result mode).
    """
    primerlen = len(primer)
    if primerlen > seq_length:
        return 0
    bestpr = fp(math.exp(fp(primerlen * threshold)))
    bestindex = 0
    for index in range(seq_length):
        start = index - primerlen
        if start < 0:
            # the circular-buffer slot is still -INFINITY at this point:
            # exp(-inf/(index+1)) == 0, so only the penalty term remains
            last_pr = fp(0.0 - fp(index * penalty))
        else:
            total = 0.0
            for x in range(primerlen):
                px = int(primer[x])
                if px == 0x0F:
                    continue
                spos = (seq_length - (start + x) - 1) if reverse \
                    else (start + x)
                nt = int(bases_nt[spos])
                total = fp(total + fp(probs[spos] if (nt & px) != 0
                                      else notprobs[spos]))
            last_pr = fp(fp(math.exp(fp(total / (index + 1))))
                         - fp(index * penalty))
        if last_pr > bestpr:
            bestpr = last_pr
            bestindex = index + 1
    return bestindex


def compute_offset_qual(threshold, penalty, reverse, nt, q, seq_length,
                        primer, fp=float):
    """panda_compute_offset_qual (offset.c:103-112)."""
    probs = QUAL_SCORE[np.clip(q[:seq_length], 0, 46)]
    notprobs = QUAL_SCORE_ERR[np.clip(q[:seq_length], 0, 46)]
    return compute_offset(threshold, penalty, reverse, nt, probs, notprobs,
                          seq_length, primer, fp)


def compute_offset_result(threshold, penalty, reverse, nt, p, seq_length,
                          primer):
    """panda_compute_offset_result (offset.c:124-133)."""
    probs = p[:seq_length]
    notprobs = np.array([log1mexp(float(v)) for v in probs])
    return compute_offset(threshold, penalty, reverse, nt, probs, notprobs,
                          seq_length, primer)


# --------------------------------------------------------------------------
# Full per-pair pipeline (assemble_seq, assembler.c:252-348)
# --------------------------------------------------------------------------

def assemble(cfg: OracleConfig, pair, dbg=None):
    """Returns (OracleResult|None, code); code is "OK" on success and the
    reject-stage name otherwise (count bookkeeping is the caller's job).
    ``dbg`` forwards the reference's per-stage debug lines (see align)."""
    fwd_nt, fwd_q, flen = pair.fwd_nt, pair.fwd_q, pair.flen
    rev_nt, rev_q, rlen = pair.rev_nt, pair.rev_q, pair.rlen

    if flen < 2 or rlen < 2:
        return None, "BADR"

    fo = ro = 0
    if not cfg.post_primers:
        if cfg.forward_primer is not None and len(cfg.forward_primer) > 0:
            off = compute_offset_qual(cfg.fp(cfg.threshold),
                                      cfg.primer_penalty, False, fwd_nt,
                                      fwd_q, flen, cfg.forward_primer,
                                      cfg.fp)
            if off == 0:
                return None, "NOFP"
            fo = off - 1
        else:
            fo = cfg.forward_trim
        if cfg.reverse_primer is not None and len(cfg.reverse_primer) > 0:
            off = compute_offset_qual(cfg.fp(cfg.threshold),
                                      cfg.primer_penalty, False, rev_nt,
                                      rev_q, rlen, cfg.reverse_primer,
                                      cfg.fp)
            if off == 0:
                return None, "NORP"
            ro = off - 1
        else:
            ro = cfg.reverse_trim

    if min(flen, rlen) < cfg.minoverlap:
        return None, "BADR"

    res, code = align(cfg, fwd_nt, fwd_q, flen, rev_nt, rev_q, rlen, fo,
                      ro, dbg=dbg)
    if code != "OK":
        # every align() failure counts as NOALGN (assembler.c:293-299)
        return res, "NOALGN"
    res.forward_offset = fo
    res.reverse_offset = ro
    res.sid = pair.sid
    res.forward_length = flen
    res.reverse_length = rlen

    if cfg.post_primers:
        if cfg.forward_primer is not None and len(cfg.forward_primer) > 0:
            off = compute_offset_result(cfg.threshold, cfg.primer_penalty,
                                        False, res.sequence_nt,
                                        res.sequence_p, res.sequence_length,
                                        cfg.forward_primer)
            if off == 0:
                return res, "NOFP"
            res.forward_offset = off - 1
        else:
            res.forward_offset = cfg.forward_trim
        if cfg.reverse_primer is not None and len(cfg.reverse_primer) > 0:
            off = compute_offset_result(cfg.threshold, cfg.primer_penalty,
                                        True, res.sequence_nt,
                                        res.sequence_p, res.sequence_length,
                                        cfg.reverse_primer)
            if off == 0:
                return res, "NORP"
            res.reverse_offset = off - 1
        else:
            res.reverse_offset = cfg.reverse_trim
        if res.sequence_length <= res.forward_offset + res.reverse_offset:
            return res, "NOFP"
        res.sequence_length -= res.forward_offset + res.reverse_offset
        # in-place shift (assembler.c:330-332)
        fo2 = res.forward_offset
        res.sequence_nt[:res.sequence_length] = \
            res.sequence_nt[fo2:fo2 + res.sequence_length].copy()
        res.sequence_p[:res.sequence_length] = \
            res.sequence_p[fo2:fo2 + res.sequence_length].copy()

    if res.quality < cfg.fp(cfg.threshold):
        return res, "LOWQ"
    return res, "OK"
