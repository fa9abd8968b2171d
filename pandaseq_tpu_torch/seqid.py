"""Illumina sequence-identifier grammar.

Reimplements the four header dialects the reference recognises
(seqid.c:143-285):

  * NCBI / EBI Short Read Archive ("SRR..." / "ERR...")
  * CASAVA 1.4-1.6        instrument:lane:tile:x:y#tag/dir
  * CASAVA "converted"    instrument:run:flowcell:lane:tile:x:y#tag/dir
  * CASAVA 1.7+           instrument:run:flowcell:lane:tile:x:y dir:filt:ctl:tag

parse() returns (direction, SeqId, format) with direction == 0 meaning a
parse failure, exactly like panda_seqid_parse_fail. The tag policy is
enforced for the CASAVA formats (seqid.c:235,280).

The PyTorch port's copy of ``pandaseq_tpu/seqid.py``, unchanged but for its
imports; the port imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PANDA_TAG_LEN = 50  # pandaseq-common.h:45
_FIELD_LEN = 100  # instrument/run/flowcell buffer size (pandaseq-common.h:236)

# PandaIdFmt (order matches the reference enum usage)
FMT_EBI_SRA = "EBI_SRA"
FMT_SRA = "SRA"
FMT_CASAVA_1_4 = "CASAVA_1_4"
FMT_CASAVA_CONVERTED = "CASAVA_CONVERTED"
FMT_CASAVA_1_7 = "CASAVA_1_7"

# PandaTagging policy
TAG_PRESENT = "PRESENT"
TAG_ABSENT = "ABSENT"
TAG_OPTIONAL = "OPTIONAL"

_SEPS = frozenset(":#/ ")


def fmt_str(format: str) -> str:
    """panda_idfmt_str (seqid.c:24-40)."""
    return {
        FMT_EBI_SRA: "EBI Short Read Archive",
        FMT_SRA: "NCBI Short Read Archive",
        FMT_CASAVA_1_4: "CASAVA 1.4-1.6",
        FMT_CASAVA_CONVERTED: "CASAVA converted",
        FMT_CASAVA_1_7: "CASAVA 1.7+",
    }.get(format, "unknown")


def fmt_has_direction(format: str) -> bool:
    """panda_idfmt_has_direction (seqid.c:42-45)."""
    return format not in (FMT_EBI_SRA, FMT_SRA)


@dataclass
class SeqId:
    instrument: str = ""
    run: str = ""
    flowcell: str = ""
    lane: int = 0
    tile: int = 0
    x: int = 0
    y: int = 0
    tag: str = ""

    def __str__(self) -> str:
        # panda_seqid_xprint format (seqid.c:115)
        return (f"{self.instrument}:{self.run}:{self.flowcell}:{self.lane}:"
                f"{self.tile}:{self.x}:{self.y}:{self.tag}")

    def __eq__(self, other) -> bool:
        if not isinstance(other, SeqId):
            return NotImplemented
        return (self.lane == other.lane and self.tile == other.tile
                and self.x == other.x and self.y == other.y
                and self.instrument == other.instrument
                and self.run == other.run and self.flowcell == other.flowcell
                and self.tag == other.tag)


class _Cursor:
    __slots__ = ("s", "i")

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def cur(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else "\0"

    def chunk_maybe(self) -> str:
        """PARSE_CHUNK_MAYBE: consume until separator or end."""
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in _SEPS:
            self.i += 1
        return self.s[start:self.i]

    def push(self) -> bool:
        """PARSE_PUSH: fail at end-of-string, else skip one char."""
        if self.i >= len(self.s):
            return False
        self.i += 1
        return True


def _parse_int(c: _Cursor):
    """PARSE_INT (seqid.c:138): digits until separator, fail on non-digit."""
    if c.cur() == "\0":
        return None
    value = 0
    while c.i < len(c.s) and c.s[c.i] not in _SEPS:
        ch = c.s[c.i]
        if not ch.isdigit():
            return None
        value = 10 * value + (ord(ch) - ord("0"))
        c.i += 1
    return value


def _parse_sra_int(c: _Cursor):
    """PARSE_SRA_INT (seqid.c:139): digits until '.', ' ' or end."""
    value = 0
    while c.i < len(c.s) and c.s[c.i] not in ". ":
        ch = c.s[c.i]
        if not ch.isdigit():
            return None
        value = 10 * value + (ord(ch) - ord("0"))
        c.i += 1
    return value


def _parse_str(c: _Cursor, maxlen: int = _FIELD_LEN):
    """PARSE_STR (seqid.c:140): chunk with length check, fail at end."""
    if c.cur() == "\0":
        return None
    chunk = c.chunk_maybe()
    # The C guard (seqid.c:140) rejects only once strictly more than
    # sizeof(target)+1 characters have been seen.
    if len(chunk) > maxlen + 1:
        return None
    return chunk


def parse(input: str, policy: str = TAG_PRESENT):
    """panda_seqid_parse (seqid.c:127-133).

    Returns (direction, SeqId | None, format | None); direction 0 == failure.
    """
    d, sid, fmt, _ = parse_fail(input, policy)
    if d == 0:
        return 0, None, None
    return d, sid, fmt


def parse_fail(input: str, policy: str = TAG_PRESENT):
    """panda_seqid_parse_fail (seqid.c:143-285): like parse, but returns
    (direction, partial SeqId, format | None, fail_position) so callers
    (pandaseq-checkid) can point at the offending character."""
    sid = SeqId()
    c = _Cursor(input)

    if len(input) > 3 and input[0] in "ES" and input[1] == "R" and input[2] == "R":
        # Short Read Archive (seqid.c:157-172)
        format = FMT_SRA if input[0] == "S" else FMT_EBI_SRA
        c.i += 3
        value = _parse_sra_int(c)
        if value is None or not c.push():
            return 0, sid, format, c.i
        sid.instrument = "%cRR%d" % (input[0], value)
        value = _parse_sra_int(c)
        if value is None or not c.push():
            return 0, sid, format, c.i
        sid.lane = value
        if not c.push():
            return 0, sid, format, c.i
        return 1, sid, format, c.i

    if "/" in input:
        # Count colons up to '#' (seqid.c:176-180)
        colon_count = 0
        for ch in input:
            if ch == "#":
                break
            if ch == ":":
                colon_count += 1
        if colon_count == 6:
            format = FMT_CASAVA_CONVERTED  # seqid.c:181-202
            fields = ("instrument", "run", "flowcell")
        else:
            format = FMT_CASAVA_1_4  # seqid.c:203-223
            fields = ("instrument",)
        for f in fields:
            v = _parse_str(c)
            if v is None:
                return 0, sid, format, c.i
            setattr(sid, f, v)  # committed before the separator check
            if not c.push():
                return 0, sid, format, c.i
        for f in ("lane", "tile", "x", "y"):
            v = _parse_int(c)
            if v is None:
                return 0, sid, format, c.i
            setattr(sid, f, v)
            if not c.push():
                return 0, sid, format, c.i
        # Tag, present only if the separator we just crossed was '#'
        # (seqid.c:224-234).
        if c.i > 0 and c.s[c.i - 1] == "#":
            tag = c.chunk_maybe()
            if len(tag) > PANDA_TAG_LEN:
                return 0, sid, format, c.i
            sid.tag = tag
            if not c.push():
                return 0, sid, format, c.i
        if policy != TAG_OPTIONAL and policy != (
                TAG_ABSENT if sid.tag == "" else TAG_PRESENT):
            return 0, sid, format, c.i
        v = _parse_int(c)
        if v is None:
            return 0, sid, format, c.i
        return v, sid, format, c.i

    # CASAVA 1.7+ (seqid.c:240-284)
    format = FMT_CASAVA_1_7
    for f in ("instrument", "run", "flowcell"):
        v = _parse_str(c)
        if v is None:
            return 0, sid, format, c.i
        setattr(sid, f, v)  # committed before the separator check
        if not c.push():
            return 0, sid, format, c.i
    for f in ("lane", "tile", "x", "y"):
        v = _parse_int(c)
        if v is None:
            return 0, sid, format, c.i
        setattr(sid, f, v)
        if not c.push():
            return 0, sid, format, c.i
    mate = _parse_int(c)
    if mate is None or not c.push():
        return 0, sid, format, c.i
    # filtered (string chunk, discarded)
    if c.cur() == "\0":
        return 0, sid, format, c.i
    c.chunk_maybe()
    if not c.push():
        return 0, sid, format, c.i
    # control bits (int, discarded)
    v = _parse_int(c)
    if v is None or not c.push():
        return 0, sid, format, c.i
    tag = c.chunk_maybe()
    if len(tag) > PANDA_TAG_LEN:
        return 0, sid, format, c.i
    sid.tag = tag
    if policy != TAG_OPTIONAL and policy != (
            TAG_ABSENT if sid.tag == "" else TAG_PRESENT):
        return 0, sid, format, c.i
    return mate, sid, format, c.i
