"""One pair through the plain reference, and what the CLI prints for it.

``merge_records`` reads the pairs at given byte offsets of a FASTQ pair
with its own reader, merges each with the frozen oracle at the CLI flags
of a configuration, and returns, per pair, what ``pandaseq`` prints for
it: the FASTA record of a merged pair (``>id;quality`` and the
sequence), the LOWQ line's text, the overlap of its BESTOLP line, and
the reject code (OK, LOWQ, NOALGN, NOFP, NORP, BADR). It runs in worker
processes, so it takes and returns only plain values.
"""

from __future__ import annotations

import math
import re
from types import SimpleNamespace

import numpy as np

from . import oracle
from .nt import IUPAC_FORWARD, IUPAC_REVERSE, nt_from_ascii, \
    nt_from_ascii_complement
from .tables import PHREDMAX

MAX_LEN = 450
QUALMIN = 33  # PHRED+33, as CASAVA 1.7+ headers imply (fastq.c:145-148)

# CASAVA 1.7+: instrument:run:flowcell:lane:tile:x:y dir:filter:control:tag
_CASAVA_17 = re.compile(
    rb"^@([^:]+):([^:]+):([^:]+):(\d+):(\d+):(\d+):(\d+) "
    rb"([12]):[YN]:\d+:([A-Za-z]*)$")


def _to_float32(x):
    return float(np.float32(x))


# the arithmetic a configuration states (IEEE double, as PANDAseq), and
# the control's one precision below it
PRECISIONS = {"float64": float, "float32": _to_float32}


def parse_flags(flags, precision="float64") -> oracle.OracleConfig:
    """An OracleConfig from the CLI flags a configuration passes, read as
    pandaseq reads them (args.c and the setters of assembler_support.c):

    - ``-p`` / ``-q``: the forward / reverse primer;
    - ``-o N``: the least overlap, N in [1, 900]; the setter keeps the
      default 2 unless 1 < N < 900;
    - ``-O N``: the greatest overlap, N in [0, 900] (0: the reads'
      length); the setter ignores 900;
    - ``-t X``: the threshold, X in [0, 1], kept as log(X);
    - ``-k N``: the k-mers kept per position, N in [0, 127].

    Any other flag, a flag given twice (as the CLI refuses it), or a value
    out of its range raises ValueError; a configuration that needs
    another flag brings it here."""
    fp = PRECISIONS[precision]
    cfg = oracle.OracleConfig(algorithm=oracle.SimpleBayes(fp=fp), fp=fp)
    it = iter(flags)
    seen = set()
    for flag in it:
        if flag in seen:
            raise ValueError("%s is given twice" % flag)
        seen.add(flag)
        if flag == "-p":
            cfg.forward_primer = _primer(next(it), nt_from_ascii)
        elif flag == "-q":
            cfg.reverse_primer = _primer(next(it), nt_from_ascii_complement)
        elif flag == "-o":
            v = _number(flag, next(it), int, 1, 2 * MAX_LEN)
            if 1 < v < 2 * MAX_LEN:
                cfg.minoverlap = v
        elif flag == "-O":
            v = _number(flag, next(it), int, 0, 2 * MAX_LEN)
            if v < 2 * MAX_LEN:
                cfg.maxoverlap = v
        elif flag == "-t":
            cfg.threshold = math.log(_number(flag, next(it), float, 0, 1))
        elif flag == "-k":
            cfg.num_kmers = _number(flag, next(it), int, 0, 127)
        else:
            raise ValueError("the reference does not implement %s" % flag)
    return cfg


def _number(flag, text, kind, lo, hi):
    try:
        v = kind(text)
    except ValueError:
        v = None
    if v is None or not lo <= v <= hi:
        raise ValueError("bad value %r for %s" % (text, flag))
    return v


def _primer(text, conv):
    codes = conv(np.frombuffer(text.encode(), dtype=np.uint8))
    if np.any(codes == 0):
        raise ValueError("bad primer %r" % text)
    return codes


def _toindex(qbytes):
    """TOINDEX (fastq.c:44), with its above-range quirk."""
    v = qbytes.astype(np.int32)
    clamped = np.where(v > QUALMIN + PHREDMAX, PHREDMAX, v) - QUALMIN
    return np.where(v < QUALMIN, 0, clamped).astype(np.int8)


def _record(fh, offset):
    fh.seek(offset)
    head, seq, plus, qual = (fh.readline().rstrip(b"\r\n")
                             for _ in range(4))
    if not plus.startswith(b"+") or len(seq) != len(qual):
        raise ValueError("malformed FASTQ record at byte %d" % offset)
    return head, seq, qual


def _sid(head):
    m = _CASAVA_17.match(head)
    if m is None:
        raise ValueError("not a CASAVA 1.7+ header: %r" % head)
    inst, run, cell, lane, tile, x, y, _, tag = m.groups()
    return "%s:%s:%s:%d:%d:%d:%d:%s" % (
        inst.decode(), run.decode(), cell.decode(), int(lane), int(tile),
        int(x), int(y), tag.decode())


def _read(seq, qual, table):
    n = min(len(seq), MAX_LEN)
    nt = np.zeros(MAX_LEN, dtype=np.int8)
    q = np.zeros(MAX_LEN, dtype=np.int8)
    nt[:n] = table[np.frombuffer(seq[:n], dtype=np.uint8) & 0x1F]
    q[:n] = _toindex(np.frombuffer(qual[:n], dtype=np.uint8))
    return nt, q, n


def outcome(cfg, fwd, rev):
    """(sid, code, FASTA record or None, BESTOLP overlap or None, LOWQ
    text or None) of one pair given its two (header, sequence, quality)
    records."""
    sid = _sid(fwd[0])
    if _sid(rev[0]) != sid:
        raise ValueError("unpaired records %r %r" % (fwd[0], rev[0]))
    fwd_nt, fwd_q, flen = _read(fwd[1], fwd[2], IUPAC_FORWARD)
    rev_nt, rev_q, rlen = _read(rev[1], rev[2], IUPAC_REVERSE)
    pair = SimpleNamespace(sid=sid, fwd_nt=fwd_nt, fwd_q=fwd_q, flen=flen,
                           rev_nt=rev_nt, rev_q=rev_q, rlen=rlen)
    res, code = oracle.assemble(cfg, pair)
    bestolp = None if res is None else int(res.overlap)
    fp = cfg.fp
    fasta = lowq = None
    if code == "OK" and res.sequence_length > 0:
        seq = oracle.NT_TO_ASCII[
            res.sequence_nt[:res.sequence_length] & 0x0F].tobytes()
        fasta = b">%s;%f\n%s\n" % (sid.encode(),
                                   fp(math.exp(res.quality)), seq)
    elif code == "LOWQ":
        lowq = "%f < %f" % (fp(math.exp(res.quality)),
                            fp(math.exp(fp(cfg.threshold))))
    return sid, code, fasta, bestolp, lowq


def merge_records(fwd_path, rev_path, offsets, flags, precision="float64"):
    """outcome() of each pair at the (forward, reverse) byte offsets."""
    cfg = parse_flags(flags, precision)
    out = []
    with open(fwd_path, "rb") as f1, open(rev_path, "rb") as f2:
        for o1, o2 in offsets:
            out.append(outcome(cfg, _record(f1, o1), _record(f2, o2)))
    return out
