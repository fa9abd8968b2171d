"""One run of one cell: inputs, warm-up, the measured window, the traced
run's reductions, the check against the reference, the metrics.

The window is a closed loop with one client: a pipeline that merges a
run's samples one after another, each sample one in-process call of
``pandaseq_tpu_torch.cli.main.main`` with the configuration's flags and
the program's own defaults (jobs.py).
"""

from __future__ import annotations

import resource
import tempfile
import time
from dataclasses import dataclass

from . import check, generate, jobs, spec
from .spans import Spans
from .trace import DeviceTrace, reduce


@dataclass
class Run:
    """What the metric readers (metrics/*.py) read."""
    jobs: list
    window_s: float
    cpu_s: float
    setup_s: float
    spans: object = None  # spans.Spans of a traced run
    trace: dict = None  # trace.reduce() of a traced run

    @property
    def pairs(self):
        return sum(j.reads for j in self.jobs)


def host_probe() -> dict:
    """Seconds of fixed work on the host, taken after the window: a
    Python loop, a first touch of 256 MB and a copy of it. A run that
    reads far off its set while these read as usual was not slowed by
    the host's CPU or memory."""
    import numpy as np
    t0 = time.perf_counter()
    x = 0
    for i in range(2_000_000):
        x += i
    t1 = time.perf_counter()
    a = np.ones(1 << 25)
    t2 = time.perf_counter()
    a.copy()
    t3 = time.perf_counter()
    return {"loop_s": t1 - t0, "touch_s": t2 - t1, "copy_s": t3 - t2}


def dirty_kb() -> dict:
    """/proc/meminfo's Dirty and Writeback (kB): page cache not yet on
    the disk, read at the window's start and end (where /proc has them;
    a sandbox's may read 0 whatever the host holds)."""
    out = {}
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                key, _, rest = line.partition(":")
                if key in ("Dirty", "Writeback"):
                    out[key] = int(rest.split()[0])
    except OSError:
        pass
    return out


def fifths(jobs, t_start, t_end) -> list:
    """Pairs per second of the jobs that ended in each fifth of the
    window: a window that warms up, or slows down, shows here."""
    edges = [t_start + (t_end - t_start) * k / 5 for k in range(6)]
    out = []
    for lo, hi in zip(edges, edges[1:]):
        done = [j for j in jobs if lo < j.t1 <= hi]
        out.append(sum(j.reads for j in done) / (hi - lo))
    return out


def run(name: str, seed: int, seconds: float, trace: bool, t_process0: float,
        *, engine: str = "cuda (default)", traffic: dict | None = None,
        workers: int | None = None):
    """(result dict, checks) of one run. ``traffic`` replaces the cell's
    traffic file (the tests' small runs); ``engine`` is the INFO ENGINE
    text every job must log."""
    import torch

    b = spec.bench()
    w = spec.workload(b, name)
    cfg = spec.config(b, w["config"])
    tr = traffic if traffic is not None else spec.traffic(w["traffic"])
    if tr["config"] != w["config"]:
        raise ValueError("traffic %r is for configuration %r, not %r"
                         % (w["traffic"], tr["config"], w["config"]))
    on_card = torch.cuda.is_available() and engine.startswith("cuda")
    if on_card:
        torch.cuda.init()
    sizes = generate.sample_sizes(tr["samples"])
    marks = [time.perf_counter()]
    with tempfile.TemporaryDirectory(prefix="pandaseq-bench-") as tmp:
        pool = generate.make_pool(cfg, tr, max(sizes), seed,
                                  "cuda" if on_card else "cpu")
        marks.append(time.perf_counter())
        samples = generate.write_samples(pool, cfg, sizes, tmp)
        marks.append(time.perf_counter())
        del pool
        if on_card:  # the peak is the program's, not the generator's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        from pandaseq_tpu_torch.cli.main import main
        # every sample once: each bucket, and each partial last batch, of
        # the cell's files, so that the window's first jobs find every
        # allocation and code path warm
        for s in samples:
            job = jobs.run_job(main, jobs.argv_of(cfg, s), s.index, False)
            if job.rc != 0:
                raise RuntimeError("the warm-up job failed: %s" % job.rc)
        marks.append(time.perf_counter())
        spans = tracer = None
        dirty0 = dirty_kb()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        if trace:
            spans = Spans()
            spans.install()
            tracer = DeviceTrace(tmp)
            tracer.start()
            with tracer.window():
                t_w0 = time.perf_counter()
                window = jobs.run_window(main, cfg, samples, seconds)
        else:
            window = jobs.run_window(main, cfg, samples, seconds)
        done, t_start, t_end, cpu_s = window
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        dirty1 = dirty_kb()
        memory = torch.cuda.max_memory_allocated() if on_card else 0
        probe = host_probe()
        reduced = None
        if trace:
            events = tracer.stop()
            spans.uninstall()
            for j in done:
                spans.log.append(("job", 0, j.t0, j.t1))
            reduced = reduce(events, spans, t_w0)
        checks, ref_s = check.run_checks(
            done, samples, cfg.get("flags", []), tr["check_pairs"], seed,
            engine, workers)
    r = Run(done, t_end - t_start, cpu_s, t_start - t_process0, spans,
            reduced)
    metrics = {}
    for m in spec.metrics_for(b, name, trace):
        v = spec.reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": w["chips"], "memory_peak_bytes": memory}
    result = {"correct": check.holds(checks), "attempted": len(done),
              "failed": checks[0][1], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = reduced["busy_s"]
        device["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    # set-up in parts: before the inputs (imports, the card's context),
    # drawing the pool, writing the samples, the warm-up jobs (with the
    # builds of a checkout's first run)
    setup = [marks[0] - t_process0] + [t1 - t0 for t0, t1 in
                                       zip(marks, marks[1:])]
    result["info"] = {"reference_s": ref_s, "pairs": r.pairs,
                      "jobs": len(done), "window_s": r.window_s,
                      "setup_parts_s": setup,
                      "window_user_s": ru1.ru_utime - ru0.ru_utime,
                      "window_sys_s": ru1.ru_stime - ru0.ru_stime,
                      "window_fifths_pairs_per_s": fifths(
                          done, t_start, t_end),
                      "window_dirty_kb": [dirty0, dirty1],
                      "host_probe_s": probe}
    result["checks"] = {n: {"value": v, "limit": lim,
                            "holds": "at most" if op == "max"
                            else "at least"}
                        for n, v, lim, op in checks}
    return result, checks
