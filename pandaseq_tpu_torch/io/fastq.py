"""Host-side paired FASTQ decoding to numpy tensors.

Reimplements the reference's record grammar and error behavior
(fastq.c:45-207) including its load-bearing quirks:

  * Sequence decode stops at MAX_LEN (450) characters (fastq.c:61).
  * Quality decode maps byte -> PHRED index via TOINDEX (fastq.c:44):
    below qualmin -> 0; above qualmin+46 -> PHREDMAX - qualmin (a faithful
    reproduction of the reference's clamp-then-subtract expression);
    otherwise byte - qualmin.
  * Sequence/quality buffers are PERSISTENT across records (fastq.c:33-36):
    bytes past the current read length retain the previous record's
    content. The PEAR scorer reads stale forward-buffer quality
    (algo_pear.c:52-54), so snapshots of the full buffer are emitted.
  * Any malformed record terminates the stream (assembler.c:356-358 treats
    a false next() as end-of-stream).
  * A zero-length read logs NODATA but skips to the next record
    (fastq.c:98-100, 191).
  * Headers' first character is skipped unconditionally (fastq.c:130).
  * CASAVA 1.7 headers imply PHRED+33 (fastq.c:145-148).

The PyTorch port's copy of ``pandaseq_tpu/io/fastq.py``, unchanged but for its
imports; the port imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

import bz2
import gzip
import io
from dataclasses import dataclass

import numpy as np

from .. import seqid as seqid_mod
from ..nt import IUPAC_FORWARD, IUPAC_REVERSE
from ..tables import PHREDMAX

MAX_LEN = 450  # configure.ac:8 compile-time default


def open_buffer(path: str):
    """panda_open_buffer (fileio.c:60-98): sniff magic bytes; BZh -> bz2,
    else zlib/gzip (zlib transparently handles plain text via gzdopen)."""
    raw = open(path, "rb")
    magic = raw.read(3)
    raw.seek(0)
    if magic[:2] == b"BZ":
        return bz2.open(raw)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(raw)
    return raw


class StreamError(Exception):
    """Raised with a reference error code (ERR\\tXXX) on malformed input."""

    def __init__(self, code: str, detail: str = ""):
        super().__init__(f"{code} {detail}".strip())
        self.code = code
        self.detail = detail


@dataclass
class ReadPair:
    sid: "seqid_mod.SeqId"
    fwd_nt: np.ndarray  # [MAX_LEN] int8 snapshot of the persistent buffer
    fwd_q: np.ndarray  # [MAX_LEN] int8
    flen: int
    rev_nt: np.ndarray
    rev_q: np.ndarray
    rlen: int


class _LineBuf:
    """Line reader stripping trailing CR (linebuf.c:57-89)."""

    def __init__(self, fh):
        self.fh = io.BufferedReader(fh) if not isinstance(
            fh, io.BufferedReader) and hasattr(fh, "read") else fh

    def next(self):
        line = self.fh.readline()
        if not line:
            return None
        line = line.rstrip(b"\n")
        if line.endswith(b"\r"):
            line = line[:-1]
        return line


def _toindex(qbytes: np.ndarray, qualmin: int) -> np.ndarray:
    """TOINDEX from fastq.c:44, including the above-range quirk."""
    v = qbytes.astype(np.int32)
    clamped = np.where(v > qualmin + PHREDMAX, PHREDMAX, v) - qualmin
    return np.where(v < qualmin, 0, clamped).astype(np.int8)


class PairedFastqReader:
    """Streaming paired reader mirroring stream_next_seq (fastq.c:108-193).

    Iterates ReadPair objects; raises StreamError (carrying the reference
    error code) on malformed input, which callers treat as end-of-stream
    exactly like the reference does. Persistent per-stream decode buffers
    reproduce the reference's stale-content semantics.
    """

    def __init__(self, forward, reverse, qualmin: int = 33,
                 policy: str = seqid_mod.TAG_PRESENT, index=None,
                 max_len: int = MAX_LEN):
        self.fwd = _LineBuf(forward)
        self.rev = _LineBuf(reverse)
        self.index = _LineBuf(index) if index is not None else None
        self.qualmin = qualmin
        # index-read mode forces optional tags (fastq.c:231)
        self.policy = seqid_mod.TAG_OPTIONAL if index is not None else policy
        self.max_len = max_len
        self.fwd_nt_buf = np.zeros(max_len, dtype=np.int8)
        self.fwd_q_buf = np.zeros(max_len, dtype=np.int8)
        self.rev_nt_buf = np.zeros(max_len, dtype=np.int8)
        self.rev_q_buf = np.zeros(max_len, dtype=np.int8)
        self.seen_under_64 = False
        self.non_empty = False

    def _read_seq(self, linebuf, nt_buf, q_buf, table, max_len):
        """read_seq (fastq.c:45-104). Returns length; raises StreamError."""
        line = linebuf.next()
        if line is None:
            raise StreamError("EOF")
        data = np.frombuffer(line, dtype=np.uint8)
        pos = min(len(data), max_len)
        codes = table[data[:pos] & 0x1F]
        if np.any(codes == 0):
            bad = int(np.argmax(codes == 0))
            raise StreamError("BADNT", f"{chr(data[bad])}@{bad + 1}")
        nt_buf[:pos] = codes
        line = linebuf.next()
        if line is None:
            raise StreamError("EOF")
        if not line.startswith(b"+"):
            if len(line) > 0 and table[line[0] & 0x1F] != 0:
                raise StreamError("READLEN")
            raise StreamError("BADSEQ")
        line = linebuf.next()
        if line is None:
            raise StreamError("EOF")
        qdata = np.frombuffer(line, dtype=np.uint8)
        if np.any(qdata < 64):
            self.seen_under_64 = True
        qpos = len(qdata)
        if qpos != pos:
            raise StreamError("NOQUAL")
        q_buf[:pos] = _toindex(qdata, self.qualmin)
        # pos == 0 logs NODATA but is not fatal (fastq.c:98-100)
        self.non_empty = True
        return pos

    def __iter__(self):
        return self

    def __next__(self) -> ReadPair:
        while True:
            line = self.fwd.next()
            if line is None:
                raise StopIteration
            # the first character ('@') is skipped unconditionally
            hdr = line[1:].decode("ascii", errors="replace")
            fdir, sid, fmt = seqid_mod.parse(hdr, self.policy)
            if fdir == 0:
                raise StreamError("BADID", hdr)
            line = self.rev.next()
            if line is None:
                raise StopIteration
            rhdr = line[1:].decode("ascii", errors="replace")
            rdir, rid, _ = seqid_mod.parse(rhdr, self.policy)
            if rdir == 0:
                raise StreamError("BADID", rhdr)
            if sid != rid or (seqid_mod.fmt_has_direction(fmt)
                              and rdir == fdir):
                raise StreamError("NOTPAIRED")
            if fmt == seqid_mod.FMT_CASAVA_1_7:
                self.seen_under_64 = True
            flen = self._read_seq(self.fwd, self.fwd_nt_buf, self.fwd_q_buf,
                                  IUPAC_FORWARD, self.max_len)
            rlen = self._read_seq(self.rev, self.rev_nt_buf, self.rev_q_buf,
                                  IUPAC_REVERSE, self.max_len)
            if self.index is not None:
                line = self.index.next()
                if line is None:
                    raise StopIteration
                ihdr = line[1:].decode("ascii", errors="replace")
                idir, iid, _ = seqid_mod.parse(ihdr, self.policy)
                if idir == 0:
                    raise StreamError("BADID", ihdr)
                if sid != iid:
                    raise StreamError("NOTPAIRED")
                tag_nt = np.zeros(seqid_mod.PANDA_TAG_LEN - 1, dtype=np.int8)
                tag_q = np.zeros(seqid_mod.PANDA_TAG_LEN - 1, dtype=np.int8)
                ilen = self._read_seq(self.index, tag_nt, tag_q,
                                      IUPAC_FORWARD,
                                      seqid_mod.PANDA_TAG_LEN - 1)
                from ..nt import nt_to_ascii
                sid.tag = nt_to_ascii(tag_nt[:ilen]).tobytes().decode()
            if flen == 0:
                continue  # NODATA: skip record (fastq.c:191)
            return ReadPair(sid, self.fwd_nt_buf.copy(), self.fwd_q_buf.copy(),
                            flen, self.rev_nt_buf.copy(), self.rev_q_buf.copy(),
                            rlen)


def read_pairs(fwd_path: str, rev_path: str, **kw):
    """Convenience opener mirroring panda_open_fastq (fileio.c:100)."""
    return PairedFastqReader(open_buffer(fwd_path), open_buffer(rev_path),
                             **kw)
