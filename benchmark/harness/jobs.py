"""One CLI job, and the window of jobs.

A job is one in-process call of ``pandaseq_tpu_torch.cli.main.main`` on
one sample's FASTQ pair, with ``sys.stdout`` and ``sys.stderr`` swapped
for in-memory sinks: a window's FASTA is gigabytes, more than a run may
write. A sink counts its bytes and folds them into a CRC-32; the first
job on each sample file keeps its whole output for the check, and every
job keeps its log's head (the INFO ENGINE line) and tail (the final STAT
block).
"""

from __future__ import annotations

import sys
import time
import traceback
import zlib
from collections import deque
from dataclasses import dataclass, field

HEAD_BYTES = 8192
TAIL_BYTES = 65536
STAT = b"STAT\t"


class Sink:
    """A binary stream that keeps a count, a CRC-32, the time of the
    first byte and, when ``keep``, a copy of everything. Writes that
    start with ``skip`` (the log's STAT lines, which carry the clock)
    stay out of the CRC."""

    def __init__(self, keep: bool, skip: bytes | None = None):
        self.keep = keep
        self.skip = skip
        self.n = 0
        self.crc = 0
        self.first = None
        self.chunks = []
        self.head = bytearray()
        self.tail = deque()
        self.tail_n = 0

    def write(self, b) -> int:
        n = len(b)
        if not n:
            return 0
        if self.first is None:
            self.first = time.perf_counter()
        self.n += n
        if self.skip is None or not bytes(b[:len(self.skip)]) == self.skip:
            self.crc = zlib.crc32(b, self.crc)
        if self.keep:
            self.chunks.append(bytes(b))
        if len(self.head) < HEAD_BYTES:
            self.head += bytes(b[:HEAD_BYTES - len(self.head)])
        if self.skip is not None:
            self.tail.append(bytes(b[-TAIL_BYTES:]))
            self.tail_n += min(n, TAIL_BYTES)
            while self.tail_n - len(self.tail[0]) >= TAIL_BYTES:
                self.tail_n -= len(self.tail.popleft())
        return n

    def flush(self):
        pass

    def data(self) -> bytes:
        return b"".join(self.chunks)

    def tail_bytes(self) -> bytes:
        return b"".join(self.tail)


class TextSink:
    """What the CLI finds in place of ``sys.stdout`` / ``sys.stderr``:
    ``.buffer`` for bytes, ``.write`` for text."""

    encoding = "utf-8"

    def __init__(self, sink: Sink):
        self.buffer = sink

    def write(self, s: str) -> int:
        self.buffer.write(s.encode())
        return len(s)

    def flush(self):
        pass

    def isatty(self):
        return False


@dataclass
class Job:
    sample: int
    t0: float
    t1: float
    rc: object  # main()'s return code, or the exception's text
    out: Sink
    log: Sink
    stat: dict = field(default_factory=dict)

    @property
    def wall(self):
        return self.t1 - self.t0

    @property
    def reads(self):
        return self.stat.get("READS", 0)

    @property
    def first_write_s(self):
        return None if self.out.first is None else self.out.first - self.t0


def parse_stat(tail: bytes) -> dict:
    """The final STAT block of a log: from its last TIME line on, each
    counter as an int (OVERLAPS kept as its text)."""
    at = tail.rfind(b"STAT\tTIME\t")
    out = {}
    if at < 0:
        return out
    for line in tail[at:].split(b"\n"):
        parts = line.split(b"\t")
        if len(parts) != 3 or parts[0] != b"STAT":
            continue
        name = parts[1].decode()
        if name in ("TIME", "ELAPSED"):
            continue
        out[name] = parts[2].decode() if name == "OVERLAPS" \
            else int(parts[2])
    return out


def run_job(main, argv, sample: int, keep: bool) -> Job:
    out = Sink(keep)
    log = Sink(keep, skip=STAT)
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = TextSink(out), TextSink(log)
    t0 = time.perf_counter()
    try:
        rc = main(argv)
    except Exception:  # a failed job is counted, and the window goes on
        rc = traceback.format_exc()
    finally:
        t1 = time.perf_counter()
        sys.stdout, sys.stderr = saved
    if not isinstance(rc, int):
        sys.stderr.write("job on sample %d failed: %s\n" % (sample, rc))
    job = Job(sample, t0, t1, rc, out, log)
    job.stat = parse_stat(log.tail_bytes() if not keep else log.data())
    return job


def argv_of(config: dict, sample) -> list[str]:
    return ["-f", sample.paths[0], "-r", sample.paths[1],
            *config.get("flags", [])]


def run_window(main, config, samples, seconds: float):
    """Jobs over the samples in their order, cycling, until ``seconds``
    have passed; the job running then finishes and counts. Returns the
    jobs and the window's (start, end, process CPU seconds)."""
    jobs = []
    seen = set()
    t_start = time.perf_counter()
    c0 = time.process_time()
    k = 0
    while True:
        s = samples[k % len(samples)]
        job = run_job(main, argv_of(config, s), s.index,
                      keep=s.index not in seen)
        seen.add(s.index)
        jobs.append(job)
        k += 1
        if job.t1 - t_start >= seconds:
            break
    cpu = time.process_time() - c0
    return jobs, t_start, jobs[-1].t1, cpu
