"""Output formatting, byte-identical to the reference (output.c:85-182).

FASTA:  >id;quality\\nSEQ\\n   where quality is printf("%f", exp(logq))
FASTQ:  @id;quality\\nSEQ\\n+\\nPHRED+33\\n with PHRED re-derived from the
        per-base log probability via the reference's binary search
        (panda_result_phred, nt.c:126-150).
Failed pairs: FASTA/FASTQ of forward + '-' + reversed reverse read
        (panda_output_fail / _fail_qual, output.c:128-182).

Zero-length results produce no output but still count as written
(output.c:89-91).

The PyTorch port's copy of ``pandaseq_tpu/io/output.py``, unchanged but for its
imports; the port imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

import math

from ..nt import nt_to_ascii, result_phred


def _id_quality(prefix: str, sid, quality: float) -> str:
    return "%s%s;%f\n" % (prefix, sid, math.exp(quality))


def _seq_bytes(res) -> bytes:
    if res.sequence_ascii is not None:
        return res.sequence_ascii[:res.sequence_length].tobytes()
    return nt_to_ascii(res.sequence_nt[:res.sequence_length]).tobytes()


def format_fasta(res) -> bytes:
    """panda_output_fasta (output.c:85-103)."""
    if res.sequence_length == 0:
        return b""
    seq = _seq_bytes(res)
    return _id_quality(">", res.sid, res.quality).encode() + seq + b"\n"


def format_fastq(res) -> bytes:
    """panda_output_fastq (output.c:105-126)."""
    if res.sequence_length == 0:
        return b""
    seq = _seq_bytes(res)
    phred = (33 + result_phred(res.sequence_p[:res.sequence_length])).astype(
        "uint8").tobytes()
    return (_id_quality("@", res.sid, res.quality).encode() + seq + b"\n+\n"
            + phred + b"\n")


def format_fail(pair) -> bytes:
    """panda_output_fail (output.c:128-150)."""
    fwd = nt_to_ascii(pair.fwd_nt[:pair.flen]).tobytes()
    rev = nt_to_ascii(pair.rev_nt[:pair.rlen][::-1]).tobytes()
    return b">" + str(pair.sid).encode() + b"\n" + fwd + b"-" + rev + b"\n"


def format_fail_qual(pair) -> bytes:
    """panda_output_fail_qual (output.c:152-182)."""
    fwd = nt_to_ascii(pair.fwd_nt[:pair.flen]).tobytes()
    rev = nt_to_ascii(pair.rev_nt[:pair.rlen][::-1]).tobytes()
    fq = (33 + pair.fwd_q[:pair.flen]).astype("uint8").tobytes()
    rq = (33 + pair.rev_q[:pair.rlen][::-1]).astype("uint8").tobytes()
    return (b"@" + str(pair.sid).encode() + b"\n" + fwd + b"-" + rev
            + b"\n+\n" + fq + b"!" + rq + b"\n")
