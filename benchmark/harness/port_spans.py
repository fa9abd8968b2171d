"""The port's own spans and counters in a traced run
(``pandaseq_tpu_torch/tracing.py``), for the metrics that read them.

A CLI job records spans while its calling thread records a
``torch.profiler`` session, so in a traced run (``--trace 1``) the port
holds the window's jobs and no warm-up job. ``window(run)`` is None for
an untraced run, for a port without ``tracing.py``, and where the spans
do not account for the run: as many jobs as ``run.jobs``, their
``pairs`` counters summing to ``run.pairs``, no span dropped. Within a
run that passes, a span or counter that never occurred reads 0.
"""

from __future__ import annotations

import statistics


def window(run):
    if run.spans is None:
        return None
    try:
        from pandaseq_tpu_torch import tracing
    except ImportError:
        return None
    got = tracing.collected()
    if (got.dropped or len(got.jobs) != len(run.jobs)
            or sum(c.get("pairs", 0) for c in got.jobs.values())
            != run.pairs):
        return None
    return got


def total_s(got, name: str) -> float:
    """Seconds summed over every span named ``name``."""
    return sum(s.t1 - s.t0 for s in got.spans if s.name == name) / 1e9


def median_ms(got, name: str) -> float:
    """The median over the spans named ``name`` (one a job), in ms."""
    d = [(s.t1 - s.t0) / 1e6 for s in got.spans if s.name == name]
    return statistics.median(d) if d else 0.0


def counter(got, key: str) -> int:
    """A counter summed over the jobs."""
    return sum(c.get(key, 0) for c in got.jobs.values())


def us_per_pair(run, name: str):
    """Microseconds of the spans named ``name`` per pair read."""
    got = window(run)
    if got is None or not run.pairs:
        return None
    return total_s(got, name) / run.pairs * 1e6
