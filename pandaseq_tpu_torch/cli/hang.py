"""pandaseq-hang (main-hang.c / hang.c / args_hang.c): trim overhanging
primer read-through from read tails before assembly.

The port's own copy of ``pandaseq_tpu/cli/hang.py``: the same flags and
output, over the port's oracle, native library and CLI ``run``, so the
merge behind it is the port's engine (``cand_join`` on the card).

Adds -P/-Q (overhang primers), -s (keep primer-less reads), and hijacks
-t as the primer-match threshold (args_hang.c:72-80 intercepts it before
the assembler ever sees it — faithful to the reference).
"""

from __future__ import annotations

import math
import sys

import numpy as np

from .. import oracle
from ..io import native as _native
from ..nt import nt_from_ascii, nt_from_ascii_complement
from . import main as cli_main


class HangReader:
    """panda_trim_overhangs (hang.c:82-114) as a ReadPair-stream wrapper:
    primers are stored reversed and located with a reverse scan; found ->
    the tail is truncated, absent -> the pair is dropped unless skip."""

    def __init__(self, inner, logger, forward, reverse, skip, threshold):
        self.inner = inner
        self.logger = logger
        self.fwd = forward[::-1].copy() if forward is not None else None
        self.rev = reverse[::-1].copy() if reverse is not None else None
        self.skip = skip
        self.threshold = threshold

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            pair = next(self.inner)
            keep = True
            if self.fwd is not None and len(self.fwd):
                off = oracle.compute_offset_qual(
                    self.threshold, 0, True, pair.fwd_nt, pair.fwd_q,
                    pair.flen, self.fwd)
                if off == 0:
                    self.logger.write("NOFP", sid=pair.sid,
                                      message="OVERHANGING REJECT")
                    if not self.skip:
                        keep = False
                else:
                    pair.flen -= off - 1
            if keep and self.rev is not None and len(self.rev):
                off = oracle.compute_offset_qual(
                    self.threshold, 0, True, pair.rev_nt, pair.rev_q,
                    pair.rlen, self.rev)
                if off == 0:
                    self.logger.write("NORP", sid=pair.sid,
                                      message="OVERHANGING REJECT")
                    if not self.skip:
                        keep = False
                else:
                    pair.rlen -= off - 1
            if keep:
                return pair

    def __getattr__(self, name):  # seen_under_64 / non_empty passthrough
        return getattr(self.inner, name)


class HangBatchFilter:
    """Batch-level panda_trim_overhangs over the native reader's
    reversed-frame batches: one native reverse-scan primer location per
    side per batch (psq_compute_offsets rev_scan), then a vectorized
    trim/compact (``Batch.trimmed``) — the per-pair HangReader semantics
    (hang.c:82-114) without the python-reader decode ceiling."""

    def __init__(self, inner, logger, forward, reverse, skip, threshold):
        self.inner = inner
        self.logger = logger
        self.fwd = forward[::-1].copy() if forward is not None else None
        self.rev = reverse[::-1].copy() if reverse is not None else None
        self.skip = skip
        self.threshold = threshold

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            b = next(self.inner)
            B = len(b.sids)
            keep = np.ones(B, dtype=bool)
            flen = b.flen.astype(np.int64).copy()
            rlen = b.rlen.astype(np.int64).copy()
            any_primer = False
            fmiss = rmiss = None
            if self.fwd is not None and len(self.fwd):
                any_primer = True
                off = _native.compute_offsets(
                    b.fwd_nt, b.fwd_q, b.flen, self.fwd,
                    self.threshold, 0.0, rev_scan=True)
                fmiss = off == 0
                if not self.skip:
                    keep &= ~fmiss
                flen = np.where(off != 0, flen - (off - 1), flen)
            if self.rev is not None and len(self.rev):
                any_primer = True
                # reverse side checked only for pairs still kept
                # (HangReader's `if keep` short-circuit)
                off = _native.compute_offsets(
                    b.rev_nt, b.rev_q, b.rlen, self.rev,
                    self.threshold, 0.0, rev_scan=True)
                rmiss = (off == 0) & keep
                if not self.skip:
                    keep &= ~rmiss
                rlen = np.where(off != 0, rlen - (off - 1), rlen)
            # reject lines in the per-pair reader's order: pair order,
            # NOFP before NORP within a pair (hang.c logs as it scans)
            rej = np.zeros(B, dtype=bool)
            if fmiss is not None:
                rej |= fmiss
            if rmiss is not None:
                rej |= rmiss
            for i in np.flatnonzero(rej):
                if fmiss is not None and fmiss[i]:
                    self.logger.write("NOFP", sid=b.sids[i],
                                      message="OVERHANGING REJECT")
                if rmiss is not None and rmiss[i]:
                    self.logger.write("NORP", sid=b.sids[i],
                                      message="OVERHANGING REJECT")
            if not any_primer:
                return b
            if keep.any():
                return b.trimmed(keep, flen, rlen)
            # whole batch rejected: pull the next one

    def __getattr__(self, name):
        return getattr(self.inner, name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # extract the hang-specific flags before the common parser runs
    fwd_primer = rev_primer = None
    skip = False
    threshold = math.log(0.6)  # args_hang.c:56
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-P" or a == "-Q":
            i += 1
            if i >= len(argv):
                print("Option %s requires an argument." % a,
                      file=sys.stderr)
                return 1
            conv = nt_from_ascii if a == "-P" else nt_from_ascii_complement
            codes = conv(np.frombuffer(argv[i].encode(), dtype=np.uint8))
            if np.any(codes == 0):
                print("ERR\tBADNT\t%sPRIMER"
                      % ("F" if a == "-P" else "R"), file=sys.stderr)
                return 1
            if a == "-P":
                fwd_primer = codes
            else:
                rev_primer = codes
        elif a == "-s":
            skip = True
        elif a == "-t":
            i += 1
            try:
                v = float(argv[i])
            except (ValueError, IndexError):
                v = -1
            if v < 0 or v > 1:
                print("Bad threshold: %s. It should be between 0 and 1."
                      % argv[i], file=sys.stderr)
                return 1
            threshold = math.log(v)
        else:
            rest.append(a)
        i += 1

    try:
        c = cli_main.parse_args(rest, prog="pandaseq-hang")
    except cli_main.ArgsError:
        print("Too confused to continue.\nTry -h for help.",
              file=sys.stderr)
        return 1
    except SystemExit as e:
        return int(e.code or 0)
    batch_wrapper = None
    if _native.get_lib() is not None:
        batch_wrapper = lambda inner, logger: HangBatchFilter(
            inner, logger, fwd_primer, rev_primer, skip, threshold)
    return cli_main.run(c, argv, prog="pandaseq-hang",
                        reader_wrapper=lambda inner, logger: HangReader(
                            inner, logger, fwd_primer, rev_primer, skip,
                            threshold),
                        batch_wrapper=batch_wrapper)


if __name__ == "__main__":
    sys.exit(main())
