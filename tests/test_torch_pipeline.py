"""The port's threaded pipeline (BatchAssembler._threaded_pipeline) on
the CPU, the plain device step under PANDASEQ_TORCH_DEVICE=cpu: the
threaded and unthreaded streams give the same results in the same
order at depths 1, 4 and 10 over jobs of 1, 2, 11 and 25 batches; each
batch's finalize goes to the worker before the next batch is
dispatched; behind a slow finalizer, with the downloads complete or
held until the worker waits on them, every group is launched once and
the bytes stay; a consumer that stops early still has every dispatched
batch finalized; and the CLI's decode ring (cli/main.py ring_slots)
never trips _check_ring, while one slot fewer does, threaded or not."""

import os
import re
import subprocess
import sys
import threading
import time

import pytest
import torch

from pandaseq_tpu_torch import assembler, tracing
from pandaseq_tpu_torch.assembler import BatchAssembler
from pandaseq_tpu_torch.cli.main import ring_slots
from pandaseq_tpu_torch.io import native
from pandaseq_tpu_torch.io.output import format_fasta
from pandaseq_tpu_torch.io.prefetch import prefetch
from tests.test_torch_tracing import run_cli, stable_log

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F1 = os.path.join(ROOT, "tests", "data", "synth_1.fastq")
F2 = os.path.join(ROOT, "tests", "data", "synth_2.fastq")
FWD, REV = "GTGCCAGCMGCCGCGGTAA", "GGACTACHVGGGTWTCTAAT"  # 515F, 806R
# batch size -> batches over the 200 synth pairs
JOBS = {256: 1, 100: 2, 19: 11, 8: 25}
DEPTHS = [1, 4, 10]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "tpu")  # the device step
    for k in ("PANDASEQ_TPU_DEPTH", "PANDASEQ_TPU_GROUP",
              "PANDASEQ_TPU_BATCH", "PANDASEQ_TPU_PROFILE"):
        monkeypatch.delenv(k, raising=False)
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _reader(batch, ring=0):
    return native.NativeBatchReader(F1, F2, batch=batch, L=512, ring=ring)


def _slow_finalize(monkeypatch, seconds):
    real = BatchAssembler._finalize

    def slow(self, *a, **kw):
        time.sleep(seconds)
        return real(self, *a, **kw)

    monkeypatch.setattr(BatchAssembler, "_finalize", slow)


def _emit(batch, depth, threaded, group=1):
    asm = BatchAssembler(L=512)
    out = [(tuple(p.sid for p in pairs), tuple(codes), payload)
           for pairs, codes, payload in asm.emit_stream(
               _reader(batch), depth=depth, threaded=threaded,
               group=group)]
    return out, asm.counters


def _assemble(batch, depth, threaded, group=1):
    asm = BatchAssembler(L=512)
    out = [(tuple(p.sid for p in pairs),
            tuple((code, format_fasta(r) if code == "OK" else None)
                  for code, r in results))
           for pairs, results in asm.assemble_stream(
               _reader(batch), depth=depth, threaded=threaded,
               group=group)]
    return out, asm.counters


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("batch", sorted(JOBS))
@pytest.mark.parametrize("stream", [_emit, _assemble],
                         ids=["emit_stream", "assemble_stream"])
def test_threaded_equals_unthreaded(stream, batch, depth):
    """One result a batch, in input order, with the same codes, bytes
    and counters as the unthreaded stream's."""
    got, got_c = stream(batch, depth, True)
    want, want_c = stream(batch, depth, False)
    assert len(got) == JOBS[batch]
    assert got == want
    sids = [s for b in got for s in b[0]]
    assert len(sids) == 200 and sids == [p.sid for b in _reader(256)
                                         for p in b.pairs]
    assert got_c == want_c and got_c.ok > 0


class _LoggedExecutor(assembler.ThreadPoolExecutor):
    log = None

    def submit(self, fn, *a, **kw):
        self.log.append("submit")
        return super().submit(fn, *a, **kw)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("depth", DEPTHS)
def test_finalize_goes_to_the_worker_at_dispatch(monkeypatch, depth,
                                                 group):
    """Every dispatch call of n batches is followed by the n finalizes'
    submissions before the next call, and ``early_finalize_batches``
    counts every batch but the last group's."""
    log = []
    real = BatchAssembler._dispatch_group

    def dispatch(self, sts):
        log.append(len(sts))
        return real(self, sts)

    monkeypatch.setattr(BatchAssembler, "_dispatch_group", dispatch)
    monkeypatch.setattr(_LoggedExecutor, "log", log)
    monkeypatch.setattr(assembler, "ThreadPoolExecutor", _LoggedExecutor)
    asm = BatchAssembler(L=512)
    tracing.enable()
    try:
        n = sum(1 for _ in asm.emit_stream(_reader(8), depth=depth,
                                           threaded=True, group=group))
    finally:
        tracing.disable()
    assert n == 25
    want = []
    for k in range(0, 25, group):
        size = min(group, 25 - k)
        want += [size] + ["submit"] * size
    assert log == want
    assert asm.engine_counters()["early_finalize_batches"] == 25 - want[-2]


class _HeldDownload:
    """A download event that completes only when waited on: the batch
    stays on the card until the worker reaches it."""

    def __init__(self):
        self.done = False

    def synchronize(self):
        self.done = True


def _count_launches(monkeypatch, held):
    """The list of the device step's launches, one download event each:
    a _HeldDownload with ``held``, else None (done at once)."""
    real = BatchAssembler._launch
    launches = []

    def counting(self, *a, **kw):
        out = real(self, *a, **kw)
        event = _HeldDownload() if held else None
        launches.append(event)
        return assembler._PendingList(out._host, event) if held else out

    monkeypatch.setattr(BatchAssembler, "_launch", counting)
    return launches


@pytest.mark.parametrize("held", [False, True], ids=["done", "held"])
@pytest.mark.parametrize("depth,group", [(1, 1), (2, 1), (3, 1), (4, 2),
                                         (6, 4), (10, 1)],
                         ids=["1", "2", "3", "4-2", "6-4", "10-1"])
def test_slow_finalizer_keeps_the_bytes(monkeypatch, depth, group, held):
    """13 batches behind a finalizer 50 ms slower than the device step,
    at the CLI's depth and group, run_distributed's and those between:
    one launch a dispatch group, and the bytes and codes of the run
    that is not slowed, whether each download is done at once or held
    until the worker waits on it (and then every one is waited on)."""
    want = _emit(16, depth, True, group)
    launches = _count_launches(monkeypatch, held)
    _slow_finalize(monkeypatch, 0.05)
    got = _emit(16, depth, True, group)
    assert len(got[0]) == 13 and want[0][0][2]
    assert got == want
    assert len(launches) == -(-13 // group)
    if held:
        assert all(event.done for event in launches)


@pytest.mark.parametrize("depth", DEPTHS)
def test_consumer_that_stops_early(monkeypatch, depth):
    """A consumer that closes the stream after three results still has
    every batch that was dispatched finalized, and no more."""
    _slow_finalize(monkeypatch, 0.01)
    dispatched, finalized = [], []
    real_d, real_f = BatchAssembler._dispatch_group, BatchAssembler._finalize

    def dispatch(self, sts):
        dispatched.extend(st["seq"] for st in sts)
        return real_d(self, sts)

    def fin(self, st, *a, **kw):
        out = real_f(self, st, *a, **kw)
        finalized.append(st["seq"])
        return out

    monkeypatch.setattr(BatchAssembler, "_dispatch_group", dispatch)
    monkeypatch.setattr(BatchAssembler, "_finalize", fin)
    asm = BatchAssembler(L=512)
    it = asm.emit_stream(_reader(8), depth=depth, threaded=True)
    for _ in range(3):
        next(it)
    it.close()
    assert len(dispatched) >= 3 + (depth > 1)
    assert finalized == dispatched == list(range(len(dispatched)))


@pytest.fixture(scope="module")
def primed(tmp_path_factory):
    """300 pairs that begin with the primers, for the -a result path."""
    prefix = str(tmp_path_factory.mktemp("pipeline") / "primed")
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tests", "golden", "make_data.py"),
                    "--out-prefix", prefix, "--pairs", "300", "--seed",
                    "5", "--fwd-primer", FWD, "--rev-primer", REV],
                   check=True, stdout=subprocess.DEVNULL, cwd=ROOT,
                   timeout=300)
    return ["-f", prefix + "_1.fastq", "-r", prefix + "_2.fastq", "-p",
            FWD, "-q", REV]


PATHS = {"emit": [], "result": ["-a"], "result_T2": ["-a", "-T", "2"]}


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("path", sorted(PATHS))
def test_cli_ring_never_trips(monkeypatch, primed, path, depth, group):
    """The CLI at PANDASEQ_TPU_DEPTH / PANDASEQ_TPU_GROUP over 25 batches
    (the emit path, the result path's threaded and unthreaded streams)
    with a finalizer slow enough that the prefetch thread runs as far
    ahead as it can: the run ends, with the bytes of the defaults."""
    argv = primed + PATHS[path]
    monkeypatch.setenv("PANDASEQ_TPU_BATCH", "12")
    want = run_cli(argv)
    _slow_finalize(monkeypatch, 0.02)
    monkeypatch.setenv("PANDASEQ_TPU_DEPTH", str(depth))
    monkeypatch.setenv("PANDASEQ_TPU_GROUP", str(group))
    got = run_cli(argv)
    assert want[0] == got[0] == 0 and want[1]
    assert got[1] == want[1]
    assert stable_log(got[2]) == stable_log(want[2])
    # one STAT block a virtual thread under -T 2
    assert sum(map(int, re.findall(rb"STAT\tREADS\t(\d+)", got[2]))) == 300


@pytest.mark.parametrize("threaded", [True, False])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("depth", DEPTHS)
def test_one_ring_slot_fewer_trips(monkeypatch, depth, group, threaded):
    """The CLI's chain (the prefetch thread running decode and _pre,
    then the emit stream, threaded or not: depth means the same cap in
    both) with batch 1's finalize held: main
    fills the cap (depth batches from batch 1 on, the last a group's
    first when depth is even) and the prefetch thread its queue, so the
    reader pulls ring_slots(depth, group) - 1 batches after batch 1
    (or batch 0 trips first, where its finalize is still running), and
    a ring one slot short fails loudly: the bound is tight."""
    reader = _reader(8, ring_slots(depth, group) - 1)
    real = BatchAssembler._finalize
    tripped = threading.Event()

    def held(self, st, *a, **kw):
        if st["seq"] == 1:
            deadline = time.monotonic() + 60
            while reader._ring_i < ring_slots(depth, group) + 1 \
                    and not tripped.is_set():
                assert time.monotonic() < deadline, reader._ring_i
                time.sleep(0.001)
        try:
            return real(self, st, *a, **kw)
        except RuntimeError:
            tripped.set()
            raise

    monkeypatch.setattr(BatchAssembler, "_finalize", held)
    asm = BatchAssembler(L=512)
    chain = prefetch(asm.pre_stream(reader))
    with pytest.raises(RuntimeError, match="decode ring overrun"):
        for _ in asm.emit_stream(chain, depth=depth, threaded=threaded,
                                 group=group):
            pass
