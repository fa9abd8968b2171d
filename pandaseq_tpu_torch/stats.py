"""Structured logging with the reference's exact STAT/ERR/INFO schema.

Reimplements the LogProxy/Writer stack (proxy.c, writer.c) host-side:
tab-separated ``CODE\\tid\\tdetail`` lines (proxy.c:118-144), human hints
for BADID/PHRED_OFFSET/READLEN, the final counter block in do_assembly's
order (pool.c:83-104), and the OVERLAPS histogram (proxy.c:175-190).

The reference tallies counters per worker thread; here they are device
arrays psum-reduced over the mesh (parallel/shard.py) and printed once —
schema-identical, globally summed.

The PyTorch port's copy of ``pandaseq_tpu/stats.py``, unchanged but for its
imports; the port imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

import sys
import time

# panda_code_str (output.c:23-83)
CODE_STR = {
    "BADNT": "ERR\tBADNT",
    "BADID": "ERR\tBADID",
    "MOD_INFO": "INFO\tMOD",
    "NODATA": "ERR\tNODATA",
    "NOFILE": "ERR\tNOFILE",
    "NOQUAL": "ERR\tNOQUAL",
    "NOTPAIRED": "ERR\tNOTPAIRED",
    "BADSEQ": "ERR\tBADSEQ",
    "READLEN": "ERR\tREADLEN",
    "EOF": "ERR\tEOF",
    "REJECT_STAT": "STAT",
    "KLNG": "ERR\tKLNG",
    "FMER": "DBG\tFMER",
    "RMER": "DBG\tRMER",
    "LOST_KMER": "DBG\tFML",
    "OLD": "INFO\tOLD",
    "BESTOLP": "INFO\tBESTOLP",
    "NOFP": "ERR\tNOFP",
    "NORP": "ERR\tNORP",
    "LOWQ": "ERR\tLOWQ",
    "NEGS": "ERR\tNEGS",
    "OOM": "ERR\tOOM",
    "BUILD": "INFO\tBUILD",
    "RECR": "INFO\tRECR",
    "MISM": "INFO\tMISM",
    "PHRED_OFFSET": "INFO\tPHRED OFFSET",
}

# PandaDebug flag bits (pandaseq.h:183-194)
DEBUG_BUILD = 1
DEBUG_FILE = 2
DEBUG_STAT = 4
DEBUG_KMER = 8
DEBUG_RECON = 16
DEBUG_MISMATCH = 32
DEBUG_DEFAULT = DEBUG_BUILD | DEBUG_FILE | DEBUG_STAT  # pandaseq.h:194

_FLAG_CHARS = {"b": DEBUG_BUILD, "f": DEBUG_FILE, "s": DEBUG_STAT,
               "k": DEBUG_KMER, "r": DEBUG_RECON, "m": DEBUG_MISMATCH}


def parse_debug_flags(argument: str, current: int = DEBUG_DEFAULT) -> int:
    """-d flag parser (args.c:329-361): lowercase clears, uppercase sets."""
    flags = current
    for ch in argument:
        bit = _FLAG_CHARS.get(ch.lower())
        if bit is None:
            print(f"Ignoring unknown debug flag `{ch}'.", file=sys.stderr)
            continue
        if ch.islower():
            flags &= ~bit
        else:
            flags |= bit
    return flags


class LogProxy:
    """panda_log_proxy over a byte writer (stderr by default)."""

    def __init__(self, stream=None, debug_flags: int = DEBUG_DEFAULT):
        self.stream = stream if stream is not None else sys.stderr.buffer
        self.debug_flags = debug_flags

    def _out(self, text: str):
        self.stream.write(text.encode())
        try:
            self.stream.flush()
        except Exception:
            pass

    def write(self, code: str, name: str | None = None, sid=None,
              message: str | None = None, flag: int | None = None):
        """panda_log_proxy_write (proxy.c:118-144), including the extra
        human hint lines."""
        if flag is not None and not (self.debug_flags & flag):
            return
        parts = []
        if name:
            parts.append(name)
        parts.append(CODE_STR.get(code, "ERR\tUNKNOWN ERROR"))
        if sid is not None:
            parts.append(str(sid))
        if message is not None:
            parts.append(message)
        self._out("\t".join(parts) + "\n")
        if code == "BADID" and message is not None:
            self._out("* * * * * Something is wrong with this ID. If tags "
                      "are absent, try passing the -B option.\n* * * * * "
                      "Consult `pandaseq-checkid \"%s\"` to get an idea of "
                      "the problem..\n" % message)
        elif code == "PHRED_OFFSET":
            self._out("* * * * * Using the default PHRED+33 offset, but no "
                      "sequences had quality data under PHRED+64.\n"
                      "* * * * * This is probably not what you want. "
                      "Consult the manual about the -6 option.\n")
        elif code == "READLEN":
            self._out("* * * * * The input reads are longer than this "
                      "version of PANDAseq can handle. Currently %d "
                      "nucleotides.\n" % 450)

    def write_str(self, s: str):
        self._out(s + "\n")

    def stat(self, name: str, value, assembler_name: str | None = None):
        prefix = f"{assembler_name}\t" if assembler_name else ""
        if isinstance(value, float):
            self._out("%sSTAT\t%s\t%f\n" % (prefix, name, value))
        else:
            self._out("%sSTAT\t%s\t%s\n" % (prefix, name, value))

    def write_overlaps(self, overlaps: dict,
                       assembler_name: str | None = None):
        """STAT OVERLAPS histogram line (proxy.c:175-190): counts for
        overlap 0..longest seen."""
        prefix = f"{assembler_name}\t" if assembler_name else ""
        longest = max(overlaps) if overlaps else 0
        counts = " ".join(str(overlaps.get(o, 0))
                          for o in range(longest + 1))
        self._out("%sSTAT\tOVERLAPS\t%s\n" % (prefix, counts))


class StatReporter:
    """do_assembly's STAT block (pool.c:52-104) over our Counters."""

    def __init__(self, proxy: LogProxy, start_time: float | None = None):
        self.proxy = proxy
        self.start = start_time if start_time is not None else time.time()

    def print_time(self, count: int, name: str | None = None):
        now = time.time()
        self.proxy.stat("TIME", time.ctime(now), name)
        self.proxy.stat("ELAPSED", int(now - self.start), name)
        self.proxy.stat("READS", count, name)

    def final(self, counters, modules=(), has_fwd_primer=False,
              has_rev_primer=False, name: str | None = None):
        self.print_time(counters.count, name)
        if has_fwd_primer:
            self.proxy.stat("NOFP", counters.nofp, name)
        if has_rev_primer:
            self.proxy.stat("NORP", counters.norp, name)
        self.proxy.stat("NOALGN", counters.noalgn, name)
        self.proxy.stat("LOWQ", counters.lowq, name)
        self.proxy.stat("BADR", counters.badread, name)
        self.proxy.stat("SLOW", counters.slow, name)
        for mod in modules:  # panda_assembler_module_stats (module.c:208)
            if getattr(mod, "rejected", 0) > 0:
                prefix = f"{name}\t" if name else ""
                self.proxy._out("%sSTAT\t%s\t%d\n"
                                % (prefix, mod.name, mod.rejected))
        self.proxy.stat("OK", counters.ok, name)
        self.proxy.write_overlaps(counters.overlaps, name)
