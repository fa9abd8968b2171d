"""What decides ``correct``: the window's jobs held to the plain reference.

After the window, for the first job on each sample file (whose whole
FASTA and log the sinks kept), a sample of its pairs drawn from the seed
goes through ``reference.merge`` in worker processes, and each pair's
FASTA record, LOWQ line, NOFP / NORP line and BESTOLP overlap must equal
what the reference prints for it. Every later job on the same file must
give the same FASTA bytes, the same log apart from its STAT lines (CRC-32
and length) and the same STAT counters, so the check reaches every job
of the window. Every job must return 0, name the expected engine, read
every pair of its file, and keep its STAT block consistent.

Each number below is compared with its limit; ``correct`` is true when
every one holds:

- ``jobs_failed``: jobs that raised or returned non-zero (at most 0);
- ``jobs_off_engine``: jobs whose log lacks the engine line (at most 0);
- ``reads_off_input``: jobs whose STAT READS differs from their file's
  pairs (at most 0);
- ``jobs_off_first``: jobs whose output differs from the first job's on
  the same file (at most 0);
- ``counts_off_output``: first jobs whose STAT counters disagree with
  their own FASTA records and reject lines, or do not add up to READS
  (at most 0);
- ``pairs_off_reference``: sampled pairs that differ from the reference
  (at most 0);
- ``pairs_checked``: sampled pairs compared (at least 1).
"""

from __future__ import annotations

import math
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

CHUNK = 64  # pairs per reference task
COUNTERS = ("READS", "OK", "LOWQ", "NOALGN", "BADR", "NOFP", "NORP",
            "SLOW")


def draw(samples, done: set, check_pairs: int, seed: int) -> dict:
    """{sample index: sorted record indices} for the samples in
    ``done``, check_pairs split evenly over them, drawn from the seed."""
    rng = np.random.default_rng([seed, 3])
    picked = [s for s in samples if s.index in done]
    if not picked:
        return {}
    k = math.ceil(check_pairs / len(picked))
    return {s.index: np.sort(rng.choice(s.pairs, min(k, s.pairs),
                                        replace=False))
            for s in picked}


def run_reference(samples, picks: dict, flags, precision="float64",
                  workers=None) -> dict:
    """{sample index: [outcome per picked record]} from the reference,
    over ``workers`` spawned processes."""
    from reference.merge import merge_records
    workers = workers or min(8, os.cpu_count() or 1)
    by = {s.index: s for s in samples}
    tasks = []
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        for i, rows in picks.items():
            s = by[i]
            for c in range(0, len(rows), CHUNK):
                offs = [(int(s.offsets[0][j]), int(s.offsets[1][j]))
                        for j in rows[c:c + CHUNK]]
                tasks.append((i, ex.submit(merge_records, s.paths[0],
                                           s.paths[1], offs, list(flags),
                                           precision)))
        out = {i: [] for i in picks}
        for i, fut in tasks:
            out[i].extend(fut.result())
    return out


class View:
    """What the CLI printed for the wanted pairs of one kept job, and the
    counts of its records and reject lines."""

    def __init__(self, job, wanted: set):
        self.fasta, self.olp, self.lowq, self.rej = {}, {}, {}, {}
        lines = job.out.data().split(b"\n")
        self.records = len(lines) // 2
        for h, seq in zip(lines[0::2], lines[1::2]):
            sid = h[1:h.rfind(b";")]
            if sid in wanted:
                self.fasta[sid] = h + b"\n" + seq + b"\n"
        self.n_lowq = self.n_nofp = self.n_norp = 0
        for line in job.log.data().split(b"\n"):
            if line.startswith(b"INFO\tBESTOLP\t"):
                _, _, sid, o = line.split(b"\t")
                if sid in wanted:
                    self.olp[sid] = int(o)
            elif line.startswith(b"ERR\tLOWQ\t"):
                self.n_lowq += 1
                _, _, sid, msg = line.split(b"\t", 3)
                if sid in wanted:
                    self.lowq[sid] = msg.decode()
            elif line.startswith((b"ERR\tNOFP\t", b"ERR\tNORP\t")):
                _, code, sid = line.split(b"\t")[:3]
                if code == b"NOFP":
                    self.n_nofp += 1
                else:
                    self.n_norp += 1
                if sid in wanted:
                    self.rej[sid] = code.decode()

    def differs(self, ref) -> str | None:
        """None when this job printed what the reference prints for the
        pair, else what differs."""
        sid, code, fasta, olp, lowq = ref
        key = sid.encode()
        got = (self.fasta.get(key), self.lowq.get(key), self.rej.get(key),
               self.olp.get(key))
        want = (fasta, lowq, code if code in ("NOFP", "NORP") else None,
                olp)
        if got == want:
            return None
        return "%s: %s, printed %r, reference %r" % (sid, code, got, want)

    def counts_off(self, stat) -> int:
        """0 when the STAT block agrees with the records and reject lines
        and its counters add up to READS."""
        off = abs(stat.get("OK", -1) - self.records)
        off += abs(stat.get("LOWQ", -1) - self.n_lowq)
        off += abs(stat.get("NOFP", 0) - self.n_nofp)
        off += abs(stat.get("NORP", 0) - self.n_norp)
        parts = sum(stat.get(k, 0) for k in COUNTERS[1:7])
        return off + abs(stat.get("READS", -1) - parts)


def _key(job):
    return (job.out.n, job.out.crc, job.log.n, job.log.crc,
            tuple(job.stat.get(k) for k in COUNTERS),
            job.stat.get("OVERLAPS"))


def run_checks(jobs, samples, flags, check_pairs: int, seed: int,
               engine: str, workers=None):
    """[(name, value, limit, "max" | "min")] of the window's jobs, and the
    seconds the reference took."""
    by = {s.index: s for s in samples}
    engine_line = ("INFO\tENGINE\t%s\n" % engine).encode()
    first = {}
    failed = off_engine = off_reads = off_first = 0
    for job in jobs:
        failed += job.rc != 0
        off_engine += engine_line not in bytes(job.log.head)
        off_reads += job.reads != by[job.sample].pairs
        if job.sample not in first:
            first[job.sample] = job
        elif _key(job) != _key(first[job.sample]):
            off_first += 1
    picks = draw(samples, set(first), check_pairs, seed)
    t0 = time.perf_counter()
    ref = run_reference(samples, picks, flags, workers=workers)
    ref_s = time.perf_counter() - t0
    off_ref, checked, off_counts = compare(first, ref)
    return [("jobs_failed", failed, 0, "max"),
            ("jobs_off_engine", off_engine, 0, "max"),
            ("reads_off_input", off_reads, 0, "max"),
            ("jobs_off_first", off_first, 0, "max"),
            ("counts_off_output", off_counts, 0, "max"),
            ("pairs_off_reference", off_ref, 0, "max"),
            ("pairs_checked", checked, 1, "min")], ref_s


def compare(first: dict, ref: dict) -> tuple[int, int, int]:
    """(pairs off the reference, pairs checked, jobs whose STAT block is
    off their own output) of the kept jobs ``first`` ({sample index:
    Job}) against the reference's outcomes ({sample index: [outcome]})."""
    off_ref = checked = off_counts = 0
    shown = 0
    for i, outs in ref.items():
        view = View(first[i], {o[0].encode() for o in outs})
        off_counts += view.counts_off(first[i].stat) != 0
        for o in outs:
            checked += 1
            why = view.differs(o)
            if why is not None:
                off_ref += 1
                if shown < 5:
                    shown += 1
                    sys.stderr.write("sample %d pair %s\n" % (i, why))
    return off_ref, checked, off_counts


def holds(checks) -> bool:
    return all(v <= lim if op == "max" else v >= lim
               for _, v, lim, op in checks)
