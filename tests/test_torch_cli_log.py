"""The CLI's per-pair log lines, which the port writes in native code, one
call a batch (``psq_log_lines``, ``io/native.py log_lines``): the BESTOLP
line of each scored pair, the LOWQ line with its two ``%f`` and the NOFP /
NORP lines, with the TIME blocks between them at their 1,000-record marks.

The port's CLI against the JAX package's CLI on the CPU, on ITS-shaped
pairs drawn by the benchmark's generator (``benchmark/harness/generate.py``,
the ``its1_2x300`` configuration: read-through, LOWQ, NOALGN), with a
read cut under its primer's length in some pairs (NOFP, NORP), among them the records on and
just before the 1,000-record marks, and one pair named by the longest id
the decoder accepts. Stdout, the return code, the stderr line sequence
(``tests/test_torch_cli.py norm_stderr``) and every file the run writes
equal, byte for byte; the default run also prints what
``benchmark/reference`` prints for every pair. Then ``log_lines`` alone
against the old per-pair loop's formatting, and the ``log_rows_native``
counter."""

import bz2
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from pandaseq_tpu_torch import tracing
from pandaseq_tpu_torch.assembler import _CODE_NAMES
from pandaseq_tpu_torch.io import native
from tests.test_torch_cli import ENV, norm_stderr
from tests.test_torch_its import printed
from tests.test_torch_tracing import run_cli, stat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CONFIG = os.path.join(BENCH, "configs", "its1_2x300.json")
PAIRS = 2500
SEED = 2 ** 31 + 2020
# records whose forward (NOFP) or reverse (NORP) read is cut to SHORT
# bases, under its primer's length (offset.c:47-90 finds no primer there):
# every 50th from 7 and from 31, and those on (999, 1999) and just before
# (998) a 1,000-record mark
SHORT = 12
NOFP_ROWS = set(range(7, PAIRS, 50)) | {999}
NORP_ROWS = set(range(31, PAIRS, 50)) | {998, 1999}
LONG_ROW = 1234
# the longest id the decoder accepts: three fields of 101 characters, four
# numbers and a tag of 50 (seqid.c:140, pandaseq-common.h:45)
LONG_ID = ":".join(["I" * 101, "R" * 101, "F" * 101, "8", "21101",
                    "999999999", "999999999"]) + ":" + "T" * 50
PACKAGES = ("pandaseq_tpu.cli.main", "pandaseq_tpu_torch")


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """(forward path, reverse path, each record's (forward, reverse) byte
    offsets, flags) of the ITS pairs as described above."""
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    tmp = tmp_path_factory.mktemp("its_log")
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(BENCH)
        from harness import generate
        pool = generate.make_pool(cfg, {"r2_cut": None}, PAIRS, SEED)
        s, = generate.write_samples(pool, cfg, [PAIRS], str(tmp))
    paths, offsets = [], []
    for which, src in enumerate(s.paths):
        with open(src, "rb") as fh:
            lines = fh.read().split(b"\n")[:-1]
        cut = NORP_ROWS if which else NOFP_ROWS
        out, offs, pos = [], [], 0
        for k in range(PAIRS):
            head, seq, plus, qual = lines[4 * k:4 * k + 4]
            if k in cut:  # shorter than its primer: no primer found
                seq, qual = seq[:SHORT], qual[:SHORT]
            if k == LONG_ROW:
                head = b"@%s %d:N:0:%s" % (LONG_ID[:-51].encode(),
                                           which + 1, LONG_ID[-50:].encode())
            rec = b"\n".join([head, seq, plus, qual]) + b"\n"
            out.append(rec)
            offs.append(pos)
            pos += len(rec)
        path = str(tmp / ("log_%d.fastq" % (which + 1)))
        with open(path, "wb") as fh:
            fh.write(b"".join(out))
        paths.append(path)
        offsets.append(offs)
    return paths[0], paths[1], list(zip(*offsets)), cfg["flags"]


@pytest.fixture(scope="module")
def reference(sample):
    """The plain reference's outcome of every pair, in file order."""
    f1, f2, offsets, flags = sample
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(BENCH)
        from reference import merge
        out = merge.merge_records(f1, f2, offsets, flags)
    codes = [o[1] for o in out]
    # what the cases below rely on: rejects of every kind, and a reject
    # on and just before each 1,000-record mark
    assert {"OK", "LOWQ", "NOFP", "NORP", "NOALGN"} <= set(codes)
    assert [codes[k] for k in (998, 999, 1999)] == ["NORP", "NOFP", "NORP"]
    return out


# {case: (extra arguments, extra environment, the files the run writes:
# {flag: bz2?})}
CASES = {
    "default": ([], {}, {}),
    "no_bestolp": (["-d", "b"], {}, {}),
    "no_stat": (["-d", "s"], {}, {}),
    "fail_fasta": ([], {}, {"-u": False}),
    "fail_fastq": ([], {}, {"-U": False}),
    "log_file": ([], {}, {"-g": False}),
    "bz2_log": ([], {}, {"-G": True}),
    "threads2": (["-T", "2"], {}, {}),
    "fastq_out": (["-F"], {}, {}),
    # the 1,000-record marks on a batch's last record, then mid-batch
    "batch1000": ([], {"PANDASEQ_TPU_BATCH": "1000"}, {}),
    "batch999": ([], {"PANDASEQ_TPU_BATCH": "999"}, {}),
    "no_bestolp_batch999": (["-d", "b"], {"PANDASEQ_TPU_BATCH": "999"},
                            {}),
}
LOGS = ("-g", "-G")
_JAX = {}  # case -> the JAX CLI's run, shared by the engines


def _spawn(runs):
    """The CompletedProcess of each (package, argv, env) of ``runs``, run
    at once."""
    procs = [subprocess.Popen([sys.executable, "-m", pkg, *argv],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, cwd=ROOT)
             for pkg, argv, env in runs]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
        return [subprocess.CompletedProcess(p.args, p.returncode, *o)
                for p, o in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _run(sample, tmp_path, case, engine):
    """(the JAX CLI's run, the port's on ``engine``) of the case, each
    (stdout, rc, stderr lines, {flag: the file written}); the JAX CLI
    runs once a case, on its host engine."""
    f1, f2, _, flags = sample
    extra, env, outputs = CASES[case]
    if "-T" not in extra:
        extra = ["-T", "1"] + extra
    todo = [(pkg, eng) for pkg, eng in ((PACKAGES[0], "host"),
                                        (PACKAGES[1], engine))
            if pkg != PACKAGES[0] or case not in _JAX]
    runs, files = [], []
    for pkg, eng in todo:
        fs = {flag: str(tmp_path / ("%s%s.out" % (pkg, flag)))
              for flag in outputs}
        argv = (flags + ["-f", f1, "-r", f2] + extra
                + [a for flag, path in fs.items() for a in (flag, path)])
        runs.append((pkg, argv, dict(ENV, PANDASEQ_TPU_ENGINE=eng, **env)))
        files.append(fs)
    got = {}
    for (pkg, _, _), fs, proc in zip(runs, files, _spawn(runs)):
        written = {}
        for flag, path in fs.items():
            with (bz2.open if outputs[flag] else open)(path, "rb") as fh:
                data = fh.read()
            written[flag] = norm_stderr(data) if flag in LOGS else data
        got[pkg] = (proc.stdout, proc.returncode, norm_stderr(proc.stderr),
                    written)
    _JAX.setdefault(case, got.get(PACKAGES[0]))
    return _JAX[case], got[PACKAGES[1]]


@pytest.mark.parametrize("engine", ["host", "tpu"])
@pytest.mark.parametrize("case", list(CASES))
def test_log_lines_port_cli_equals_jax_cli(sample, reference, tmp_path,
                                           case, engine):
    want, got = _run(sample, tmp_path, case, engine)
    assert got == want
    out, rc, log, files = want
    assert rc == 0 and out
    for data in files.values():
        assert data
    log = "\n".join(files.get("-g") or files.get("-G") or log) + "\n"
    extra = CASES[case][0]
    threads = int(extra[extra.index("-T") + 1]) if "-T" in extra else 1
    assert log.count("STAT\tTIME\t") == PAIRS // 1000 + threads
    bestolp = log.count("INFO\tBESTOLP\t")
    rejects = sum(log.count("ERR\t%s\t" % c) for c in ("LOWQ", "NOFP",
                                                       "NORP"))
    assert (bestolp == 0) == ("b" in "".join(extra))
    assert (rejects == 0) == ("s" in "".join(extra))
    if case == "default":
        # the log's order around the first mark: the reject on record
        # 998, the one on record 999, then its TIME block
        lines = log.split("\n")
        t = lines.index("STAT\tTIME\t<t>")
        assert lines[t - 2:t] == ["ERR\tNORP\t" + reference[998][0],
                                  "ERR\tNOFP\t" + reference[999][0]]
        assert "\t%s\t" % LONG_ID in log
        # every pair as the plain reference prints it
        fasta, lowq, olp, rej = printed(out, log.encode())
        off = [(sid, code) for sid, code, fa, o, lq in reference
               if (fasta.get(sid), lowq.get(sid), olp.get(sid),
                   rej.get(sid)) != (fa, lq, o,
                                     code if code in ("NOFP", "NORP")
                                     else None)]
        assert off == [], off[:5]


def _old_loop(ids, scored, overlap, codes, quality, threshold, flags, done):
    """The bytes and marks of the CLI's former per-pair Python loop."""
    out, marks = b"", []
    for i in range(len(codes)):
        sid = ids[i].tobytes().split(b"\0", 1)[0]
        if flags & native.LOG_BESTOLP and scored[i]:
            out += b"INFO\tBESTOLP\t%s\t%d\n" % (sid, overlap[i])
        code = _CODE_NAMES[codes[i]]
        if flags & native.LOG_STAT:
            if code == "LOWQ":
                out += ("ERR\tLOWQ\t%s\t%f < %f\n"
                        % (sid.decode(), math.exp(quality[i]),
                           math.exp(threshold))).encode()
            elif code in ("NOFP", "NORP"):
                out += b"ERR\t%s\t%s\n" % (code.encode(), sid)
        if (done + i + 1) % 1000 == 0:
            marks.append(len(out))
    return out, marks


def _exact_log(x):
    """A log quality whose exp is ``x`` exactly, so that the ``%f`` of
    an exact half-way value is what is printed."""
    q = math.log(x)
    for _ in range(64):
        if math.exp(q) == x:
            return q
        q = math.nextafter(q, -math.inf if math.exp(q) > x else math.inf)
    raise AssertionError(x)


@pytest.mark.parametrize("flags", [0, 1, 2, 3])
@pytest.mark.parametrize("done", [0, 998, 1999])
def test_log_lines_equal_the_old_loop(flags, done):
    """log_lines on hand-set rows (every code; qualities whose exp is 0,
    1 and exactly half-way at the sixth decimal, both ways; ids empty,
    short and ID_STRIDE - 1 bytes long; negative and large overlaps;
    threshold log 0.6) against the former loop's formatting, with and
    without the reject clock, into a buffer too small and one reused."""
    rng = np.random.default_rng(7 + done + flags)
    B = 2600
    ids = np.zeros((B, native.ID_STRIDE), np.uint8)
    for i in range(B):
        n = (0, 1, native.ID_STRIDE - 1, 37 + i % 300)[min(i, 3)]
        s = (b"M%d:7:FC:1:1101:%d:%d" % (i, i, 2 * i) * 20)[:n]
        ids[i, :len(s)] = np.frombuffer(s, np.uint8)
    codes = rng.integers(0, len(_CODE_NAMES), B).astype(np.uint8)
    scored = rng.random(B) < 0.8
    overlap = rng.integers(-1, 1000, B).astype(np.int64)
    overlap[:3] = (-1, 0, 2 ** 40)
    quality = np.log(rng.random(B))
    special = [0.0, -math.inf] + [_exact_log(k / 128)
                                  for k in (65, 67, 99, 125, 127)]
    quality[:len(special)] = special
    codes[:len(special)] = _CODE_NAMES.index("LOWQ")
    threshold = math.log(0.6)
    want = _old_loop(ids, scored, overlap, codes, quality, threshold, flags,
                     done)
    # k / 128 is half-way at the sixth decimal: even digits either way
    assert b"\t0.507812 < 0.600000\n" in want[0] or not flags & 2
    assert b"\t0.523438 < 0.600000\n" in want[0] or not flags & 2
    ns = np.zeros(1, np.int64)
    buf = np.empty(10, np.uint8)
    for reject_ns in (None, ns):
        n, marks, buf2 = native.log_lines(
            ids, scored, overlap, codes, quality, threshold, flags, done,
            buf, reject_ns)
        assert buf2.nbytes > 10
        assert (bytes(buf2[:n]), marks.tolist()) == want
        n, marks, buf3 = native.log_lines(
            ids, scored, overlap, codes, quality, threshold, flags, done,
            buf2, reject_ns)
        assert buf3 is buf2 and bytes(buf3[:n]) == want[0]
    assert ns[0] > 0


def test_log_rows_native_counts_the_emit_branch(monkeypatch):
    """``log_rows_native`` is STAT READS on a default job, traced or not
    (it is counted always), and 0 where the CLI's general branch runs
    (``-a``: primers removed after assembly)."""
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_BATCH", "64")
    monkeypatch.delenv("PANDASEQ_TPU_PROFILE", raising=False)
    data = os.path.join(ROOT, "tests", "data")
    argv = ["-f", os.path.join(data, "synth_1.fastq"),
            "-r", os.path.join(data, "synth_2.fastq")]
    tracing.disable()
    tracing.clear()
    try:
        for extra, native_rows in (([], True), (["-a"], False)):
            tracing.enable()
            try:
                rc, _, log = run_cli(argv + extra)
            finally:
                tracing.disable()
            assert rc == 0
            (_, counts), = tracing.collected().jobs.items()
            tracing.clear()
            want = stat(log, "READS") if native_rows else 0
            assert counts["log_rows_native"] == want
            assert counts["reject_rows"] == \
                stat(log, "READS") - stat(log, "OK") > 0
    finally:
        tracing.disable()
        tracing.clear()
