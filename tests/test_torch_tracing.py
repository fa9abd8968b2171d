"""The port's spans and counters (pandaseq_tpu_torch/tracing.py) on the
CPU: the CLI run in-process on tests/data/synth_* with tracing off and
on, on the host engine and on the plain PyTorch device step
(``PANDASEQ_TPU_ENGINE=tpu``: ``_launch`` and ``_PendingList``), and the
trace ``PANDASEQ_TPU_PROFILE`` writes, on the profiler's clock."""

import glob
import io
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import pytest
import torch

from pandaseq_tpu_torch import tracing
from pandaseq_tpu_torch.cli.main import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
ARGV = ["-f", os.path.join(DATA, "synth_1.fastq"),
        "-r", os.path.join(DATA, "synth_2.fastq")]

JOB = {"job", "job.setup", "job.drain", "wait.prefetch", "dispatch",
       "wait.finalize", "emit", "decode", "pre", "finalize",
       "psq_finalize"}
DEVICE = {"pack", "launch", "wait.device", "fixup"}
ENGINES = {"host": JOB, "tpu": JOB | DEVICE}
FWD, REV = "GTGCCAGCMGCCGCGGTAA", "GGACTACHVGGGTWTCTAAT"  # 515F, 806R
COUNTERS = {"pairs", "batches", "device_steps", "overflow_reroutes",
            "fixup_rows", "fixup_rows_n", "fixup_rows_over",
            "ring_slots_new", "h2d_bytes", "d2h_bytes",
            "early_finalize_batches", "log_rows_native"}
# counted in traced batches only: the SLOW rows' scans, read-through and
# the CLI's reject path
TRACED_ONLY = ("slow_rows", "slow_scan_ns", "readthrough_pairs",
               "reject_rows", "reject_emit_ns")
COUNTERS |= set(TRACED_ONLY)


class _Text:
    encoding = "utf-8"

    def __init__(self, buf):
        self.buffer = buf

    def write(self, s):
        self.buffer.write(s.encode())
        return len(s)

    def flush(self):
        pass


def run_cli(argv=ARGV):
    """main(argv) in this process: (rc, stdout bytes, stderr bytes)."""
    out, err = io.BytesIO(), io.BytesIO()
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = _Text(out), _Text(err)
    try:
        rc = main(argv)
    finally:
        sys.stdout, sys.stderr = saved
    return rc, out.getvalue(), err.getvalue()


def stable_log(raw: bytes) -> bytes:
    """The log without the clock: STAT TIME and ELAPSED masked."""
    raw = re.sub(rb"STAT\tTIME\t[^\n]*", b"STAT\tTIME\t<t>", raw)
    return re.sub(rb"STAT\tELAPSED\t\d+", b"STAT\tELAPSED\t<e>", raw)


@pytest.fixture
def port(monkeypatch):
    """The port on the CPU, four batches of 64 pairs, tracing clear and
    off before and after."""
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_BATCH", "64")
    monkeypatch.delenv("PANDASEQ_TPU_PROFILE", raising=False)
    tracing.disable()
    tracing.clear()
    yield monkeypatch
    tracing.disable()
    tracing.clear()


def traced_run():
    tracing.enable()
    try:
        return run_cli()
    finally:
        tracing.disable()


def stat(log: bytes, name: str) -> int:
    return int(re.findall(rb"STAT\t%s\t(\d+)" % name.encode(), log)[-1])


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_spans_change_no_byte_and_nest(port, engine):
    """Off records nothing; on, the FASTA and the log (less its clock)
    are the same bytes, every span of the engine's path occurs, each
    parent was recorded, each child lies inside its parent, siblings on
    one thread never overlap, and the counters agree with the log and
    the spans."""
    port.setenv("PANDASEQ_TPU_ENGINE", engine)
    off = run_cli()
    assert tracing.collected().spans == [] and tracing.collected().jobs == {}
    on = traced_run()
    assert off[0] == on[0] == 0 and off[1] and off[1] == on[1]
    assert stable_log(off[2]) == stable_log(on[2])

    got = tracing.collected()
    spans = got.spans
    assert got.dropped == 0 and len(got.jobs) == 1
    assert {s.name for s in spans} == ENGINES[engine]
    (job_id, counts), = got.jobs.items()
    assert set(counts) == COUNTERS
    assert all(s.job == job_id for s in spans)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.t0 <= s.t1 and s.cpu >= 0
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert p.tid == s.tid
        assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
    sibs = defaultdict(list)
    for s in spans:
        sibs[s.tid, s.parent].append(s)
    for group in sibs.values():
        group.sort(key=lambda s: s.t0)
        for a, b in zip(group, group[1:]):
            assert a.t1 <= b.t0, (a, b)

    job, = [s for s in spans if s.name == "job"]
    assert job.parent is None and job.attrs == counts
    for name in ("job.setup", "job.drain"):
        s, = [s for s in spans if s.name == name]
        assert s.parent == job.id
    main_tid = job.tid
    roots = {s.name for s in spans if s.parent is None}
    assert roots == {"job", "decode", "pre", "finalize"}
    threads = {s.name: s.tid for s in spans if s.parent is None}
    assert threads["decode"] == threads["pre"]
    assert len({main_tid, threads["decode"], threads["finalize"]}) == 3

    def count(name, pairs=False):
        return sum(1 for s in spans if s.name == name
                   and (not pairs or s.attrs["pairs"]))

    assert counts["pairs"] == stat(on[2], "READS") == 200
    # decode: one span a batch, and the end-of-stream call (no pairs)
    assert counts["batches"] == count("decode", True) == 4
    assert count("decode") == 5
    assert count("pre") == count("finalize") == count("emit") == 4
    assert sum(s.attrs["pairs"] for s in spans if s.name == "emit") == 200
    assert counts["ring_slots_new"] == 5
    assert counts["early_finalize_batches"] == 3
    assert counts["h2d_bytes"] == counts["d2h_bytes"] == 0  # no card
    if engine == "tpu":
        assert counts["device_steps"] == count("launch") == 4
        assert count("wait.device") == 4
        # synth has N bases in some reads: their masks are redone
        assert counts["fixup_rows"] == sum(
            s.attrs["rows"] for s in spans if s.name == "fixup") > 0
        assert counts["fixup_rows"] == (counts["fixup_rows_n"]
                                        + counts["fixup_rows_over"])
    else:
        assert counts["device_steps"] == counts["fixup_rows"] == 0


@pytest.mark.parametrize("batch,batches", [(256, 1), (100, 2), (19, 11),
                                           (8, 25)])
def test_early_finalize_counter(port, batch, batches):
    """``early_finalize_batches``, on the job span and in
    engine_counters(): each batch's finalize goes to the worker at its
    dispatch, so every batch but the last is counted, at the CLI's
    depth of 10 too. Like the other engine counters it is counted with
    tracing off as well, and then no span carries it."""
    from pandaseq_tpu_torch.assembler import BatchAssembler
    from pandaseq_tpu_torch.io import native

    port.setenv("PANDASEQ_TPU_BATCH", str(batch))
    port.setenv("PANDASEQ_TPU_ENGINE", "tpu")
    assert traced_run()[0] == 0
    (_, counts), = tracing.collected().jobs.items()
    job, = [s for s in tracing.collected().spans if s.name == "job"]
    assert counts["batches"] == batches
    assert job.attrs["early_finalize_batches"] == batches - 1
    assert counts["early_finalize_batches"] == batches - 1

    def stream():
        asm = BatchAssembler(L=512)
        rdr = native.NativeBatchReader(ARGV[1], ARGV[3], batch=batch, L=512)
        for _ in asm.emit_stream(rdr, depth=10, threaded=True):
            pass
        return asm.engine_counters()

    tracing.enable()
    try:
        assert stream()["early_finalize_batches"] == batches - 1
    finally:
        tracing.disable()
    tracing.clear()
    assert stream()["early_finalize_batches"] == batches - 1
    assert not tracing.collected().spans
    assert not tracing.collected().jobs


def test_spans_agree_with_the_benchmark_wrappers(port, tmp_path):
    """In one traced run, the port's decode, pre and finalize spans sum
    to within 10% of the benchmark's wrappers around the same calls
    (benchmark/harness/spans.py)."""
    port.syspath_prepend(os.path.join(ROOT, "benchmark"))
    port.setenv("PANDASEQ_TPU_BATCH", "1024")
    prefix = str(tmp_path / "pairs")
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tests", "golden", "make_data.py"),
                    "--pairs", "2048", "--fast", "--out-prefix", prefix,
                    "--fwd-primer", FWD, "--rev-primer", REV],
                   check=True, capture_output=True, cwd=ROOT, timeout=300)
    # the primer scans give _pre work of the size of a decode's
    argv = ["-f", prefix + "_1.fastq", "-r", prefix + "_2.fastq",
            "-p", FWD, "-q", REV]
    from harness.spans import Spans
    wrap = Spans()
    wrap.install()
    tracing.enable()
    try:
        for _ in range(3):
            assert run_cli(argv)[0] == 0
    finally:
        tracing.disable()
        wrap.uninstall()
    spans = tracing.collected().spans
    for name in ("decode", "pre", "finalize"):
        port_s = sum(s.t1 - s.t0 for s in spans if s.name == name) / 1e9
        assert abs(port_s - wrap.total(name)) <= 0.1 * wrap.total(name), \
            (name, port_s, wrap.total(name))


def test_profiler_session_turns_a_job_on(port):
    """A job whose calling thread records a torch.profiler session is
    traced, and tracing is off again after it; other threads' sessions
    do not count (the profiler's flag is per thread)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert run_cli()[0] == 0
    assert not tracing.ON
    assert len(tracing.collected().jobs) == 1
    assert run_cli()[0] == 0
    assert len(tracing.collected().jobs) == 1


def _trace_file(tmp_path, job_id):
    path = tmp_path / ("trace-%d-%d.json" % (os.getpid(), job_id))
    assert glob.glob(str(tmp_path / "*.json")) == [str(path)]
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def test_spans_on_the_profilers_clock(port, tmp_path):
    """Under PANDASEQ_TPU_PROFILE, a port span around a record_function
    lands within 0.5 ms of it in the exported trace, on its row."""
    port.setenv("PANDASEQ_TPU_PROFILE", str(tmp_path))
    with tracing.job() as j:
        sp = tracing.begin("clock.probe")
        with torch.profiler.record_function("clock.probe"):
            time.sleep(0.02)
        tracing.end(sp)
    assert not tracing.ON
    events = _trace_file(tmp_path, j.id)
    ours, = [e for e in events if e.get("cat") == "pandaseq"
             and e["name"] == "clock.probe"]
    theirs, = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "clock.probe"]
    assert (ours["pid"], ours["tid"]) == (theirs["pid"], theirs["tid"])
    assert abs(ours["ts"] - theirs["ts"]) < 500
    assert abs((ours["ts"] + ours["dur"])
               - (theirs["ts"] + theirs["dur"])) < 500


def test_cli_profile_holds_the_spans_of_three_threads(port, tmp_path):
    """PANDASEQ_TPU_PROFILE on a CLI job: one file a job, named by the
    process and the job, holding the job's spans on three threads'
    rows; the device step's torch operations lie inside ``launch``."""
    port.setenv("PANDASEQ_TPU_ENGINE", "tpu")
    port.setenv("PANDASEQ_TPU_PROFILE", str(tmp_path))
    assert run_cli()[0] == 0
    (job_id, _), = tracing.collected().jobs.items()
    events = _trace_file(tmp_path, job_id)
    ours = [e for e in events if e.get("cat") == "pandaseq"]
    assert {e["name"] for e in ours} == ENGINES["tpu"]
    assert {e["pid"] for e in ours} == {os.getpid()}
    assert len({e["tid"] for e in ours}) == 3
    launches = [e for e in ours if e["name"] == "launch"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["tid"] == launches[0]["tid"]]
    inside = [o for o in ops if any(
        l["ts"] <= o["ts"] and o["ts"] + o["dur"] <= l["ts"] + l["dur"]
        for l in launches)]
    assert inside


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_traced_only_counters_sit_on_every_job(port, engine, tmp_path):
    """The five counters of SLOW rows, read-through and rejects on a
    traced job: on the synth reads they agree with the log (STAT SLOW,
    the pairs not OK, no BESTOLP overlap longer than the shorter read,
    since no -O lets one be) and their times are positive; a traced job
    on empty inputs carries all five, each 0."""
    port.setenv("PANDASEQ_TPU_ENGINE", engine)
    rc, _, log = traced_run()
    assert rc == 0
    (_, counts), = tracing.collected().jobs.items()
    assert counts["slow_rows"] == stat(log, "SLOW") > 0
    assert counts["reject_rows"] == stat(log, "READS") - stat(log, "OK") > 0
    assert counts["slow_scan_ns"] > 0 and counts["reject_emit_ns"] > 0
    assert re.findall(rb"INFO\tBESTOLP\t", log)
    assert counts["readthrough_pairs"] == 0

    tracing.clear()
    for name in ("e_1.fastq", "e_2.fastq"):
        (tmp_path / name).write_bytes(b"")
    tracing.enable()
    try:
        run_cli(["-f", str(tmp_path / "e_1.fastq"),
                 "-r", str(tmp_path / "e_2.fastq")])
    finally:
        tracing.disable()
    (_, counts), = tracing.collected().jobs.items()
    assert counts["pairs"] == 0
    assert {k: counts[k] for k in TRACED_ONLY} == dict.fromkeys(
        TRACED_ONLY, 0)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_untraced_job_counts_nothing_and_reads_no_clock(port, engine):
    """With tracing off the five traced-only counters' sites test the
    flag and do nothing: the native finalizer is never asked for its
    SLOW-row clock, no batch is scanned for them, no clock is read, no
    job is recorded; the bytes are those of a traced run."""
    from pandaseq_tpu_torch.assembler import BatchAssembler
    from pandaseq_tpu_torch.io import native

    port.setenv("PANDASEQ_TPU_ENGINE", engine)
    on = traced_run()
    tracing.clear()
    asked = []
    finalize = native.finalize

    def spy(*a, **kw):
        asked.append(kw.get("trace", False))
        return finalize(*a, **kw)

    def no_scan(*a):
        raise AssertionError("_count_traced ran with tracing off")

    reads = []
    clock = time.perf_counter_ns

    def counted():
        reads.append(1)
        return clock()

    port.setattr(native, "finalize", spy)
    port.setattr(BatchAssembler, "_count_traced", no_scan)
    port.setattr(time, "perf_counter_ns", counted)
    off = run_cli()
    port.setattr(time, "perf_counter_ns", clock)
    assert off[0] == 0 and off[1] == on[1]
    assert stable_log(off[2]) == stable_log(on[2])
    assert asked and not any(asked)
    assert reads == []
    assert not tracing.collected().jobs and not tracing.collected().spans
