"""Spans and counters of the port, and the operator's trace.

Spans mark the port's layer boundaries (table in README.md, "Tracing"):
a CLI call is one *job* (``job``, ``job.setup``, ``job.drain``, the main
thread's ``wait.prefetch``, ``dispatch`` with ``pack`` and ``launch``,
``wait.finalize`` and ``emit``), the prefetch thread records ``decode``
and ``pre``, the finalize worker ``finalize`` with ``wait.device``,
``fixup`` and ``psq_finalize``. A span's parent is the innermost span
open on its thread when it began.

Every site tests the one flag ``ON`` and, when it is False, allocates
nothing and reads no clock. The flag is per process, so the threads a
job starts record into it. It is set

- for one CLI job (``job``) when ``PANDASEQ_TPU_PROFILE=<dir>`` is set,
  or when the calling thread records a ``torch.profiler`` session;
- by library callers, with ``enable()`` and ``disable()``.

With ``PANDASEQ_TPU_PROFILE=<dir>`` a job runs under ``torch.profiler``
(the card's activity too, when one is visible) and writes the Chrome
trace ``<dir>/trace-<pid>-<job>.json`` at its end, the job's spans
added as ``"X"`` events of category ``pandaseq`` on their threads' rows
and on the trace's own clock.

Spans are kept in memory, at most ``CAP`` of them (``dropped`` counts
the rest), until ``clear()``; ``collected()`` returns them with each
job's counters (``BatchAssembler.engine_counters()``, the reader's
``ring_slots_new``, the CLI's ``reject_rows`` and ``reject_emit_ns``).
``slow_rows``, ``slow_scan_ns``, ``readthrough_pairs`` and the two
``reject_`` counters grow in traced batches only: their sites read a
clock or scan a batch, so untraced they test the flag and do nothing.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import NamedTuple

ON = False
CAP = 1_000_000


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None
    job: int | None  # the CLI job it ran in, None outside one
    seq: int | None  # the batch's number in its job, where there is one
    tid: int  # threading.get_native_id(), the profiler's ``tid``
    t0: int  # time.perf_counter_ns()
    t1: int
    cpu: int  # time.thread_time_ns() of its thread over the span
    attrs: dict


class Collected(NamedTuple):
    spans: list  # of Span, in the order they ended
    jobs: dict  # job id -> that job's counters
    dropped: int  # spans not kept (over CAP)


class _Open:
    __slots__ = ("name", "id", "parent", "seq", "attrs", "t0", "c0")


_spans: list = []  # Span's fields as plain tuples
_jobs: dict = {}
_dropped = 0
_ids = itertools.count(1)
_job_ids = itertools.count(1)
_job = None  # the running job
_anchor = (0, 0)  # (perf_counter_ns, time_ns) taken by enable()
_local = threading.local()
_drop_lock = threading.Lock()


def enable():
    """Record spans from now on, in every thread."""
    global ON, _anchor
    if not ON:
        _anchor = (time.perf_counter_ns(), time.time_ns())
        ON = True


def disable():
    global ON
    ON = False


def clear():
    """Forget the spans and job counters recorded so far."""
    global _dropped
    _spans.clear()
    _jobs.clear()
    _dropped = 0


def collected() -> Collected:
    return Collected([Span(*r) for r in _spans], dict(_jobs), _dropped)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
        _local.tid = threading.get_native_id()
    return st


def begin(name: str, seq: int | None = None, **attrs) -> _Open:
    """Open a span on this thread; call only where ``ON`` is True, and
    close it with ``end``. The clocks are read first here and last in
    ``end``, so that the span's bookkeeping falls inside it and the
    span's ends lie as close to its caller's code as they can."""
    t0 = time.perf_counter_ns()
    c0 = time.thread_time_ns()
    st = _stack()
    sp = _Open()
    sp.name = name
    sp.id = next(_ids)
    sp.parent = st[-1].id if st else None
    sp.seq = seq
    sp.attrs = attrs
    sp.t0 = t0
    sp.c0 = c0
    st.append(sp)
    return sp


def end(sp: _Open, **attrs):
    """Close ``sp`` (and any span opened inside it and left open)."""
    global _dropped
    st = _stack()
    for k in range(len(st) - 1, -1, -1):
        if st[k] is sp:
            del st[k:]
            break
    if attrs:
        sp.attrs.update(attrs)
    job = None if _job is None else _job.id
    tid = _local.tid
    c1 = time.thread_time_ns()
    t1 = time.perf_counter_ns()
    if len(_spans) >= CAP:
        with _drop_lock:
            _dropped += 1
        return
    _spans.append((sp.name, sp.id, sp.parent, job, sp.seq, tid, sp.t0, t1,
                   c1 - sp.c0, sp.attrs))


def drain():
    """The main thread has dispatched the running job's last batch:
    opens its ``job.drain``, which ends with the job."""
    j = _job
    if j is not None and j.drain is None:
        j.drain = begin("job.drain")


class job:
    """One CLI job: ``with tracing.job() as j:`` around ``run``'s body.
    The body ends ``job.setup`` with ``j.setup_done()`` and sets
    ``j.counters`` to a function returning the job's counters."""

    def __init__(self):
        self.id = None
        self.span = self.setup = self.drain = None
        self.counters = None
        self._prof = None
        self._own = False

    def __enter__(self):
        global _job
        trace_dir = os.environ.get("PANDASEQ_TPU_PROFILE")
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            import torch
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._dir = trace_dir
        # the profiler's flag is per thread: read it on the calling one
        self._own = not ON and (self._prof is not None
                                or _profiler_enabled())
        if self._own:
            enable()
        if ON:
            self.id = next(_job_ids)
            _job = self
            self.span = begin("job")
            self.setup = begin("job.setup")
        return self

    def setup_done(self):
        if self.setup is not None:
            end(self.setup)
            self.setup = None

    def __exit__(self, *exc):
        global _job
        try:
            if self.span is not None:
                if self.drain is not None:
                    end(self.drain)
                counts = self.counters() if self.counters else {}
                end(self.span, **counts)
                _jobs[self.id] = counts
        finally:
            _job = None
            if self._own:
                disable()
            if self._prof is not None:
                self._prof.__exit__(*exc)
                self._export()
        return False

    def _export(self):
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, "trace-%d-%d.json"
                            % (os.getpid(), self.id))
        self._prof.export_chrome_trace(path)
        self._prof = None
        with open(path) as fh:
            doc = json.load(fh)
        base = doc.get("baseTimeNanoseconds")
        if base is None:
            raise RuntimeError("%s has no baseTimeNanoseconds: the port's "
                               "spans cannot be put on its clock" % path)
        doc["traceEvents"].extend(chrome_events(
            [s for s in collected().spans if s.job == self.id], base))
        with open(path, "w") as fh:
            json.dump(doc, fh)


def chrome_events(spans, base_ns: int) -> list:
    """``spans`` as Chrome trace ``"X"`` events on the clock of a
    ``torch.profiler`` trace whose ``baseTimeNanoseconds`` is
    ``base_ns``: the CPU events' ``ts`` is (CLOCK_REALTIME ns - base) /
    1000, reached from ``perf_counter_ns`` through the anchor."""
    p0, w0 = _anchor
    pid = os.getpid()
    return [{"ph": "X", "cat": "pandaseq", "name": s.name, "pid": pid,
             "tid": s.tid, "ts": (w0 + s.t0 - p0 - base_ns) / 1e3,
             "dur": (s.t1 - s.t0) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "job": s.job,
                      "seq": s.seq, "cpu_us": s.cpu / 1e3, **s.attrs}}
            for s in spans]


def _profiler_enabled() -> bool:
    import torch
    return bool(torch.autograd._profiler_enabled())
