"""The metrics that read the port's own spans and counters
(pandaseq_tpu_torch/tracing.py, harness/port_spans.py), on the CPU: a
traced run of a small cell on the host engine reads a value for each,
and an untraced run reads none."""

import time

import pytest

from harness import cell, spec

NAME = "v4_2x250.small_samples"
PORT = ("job_setup_ms", "job_drain_ms", "emit_us_per_pair",
        "wait_prefetch_us_per_pair", "wait_finalize_us_per_pair",
        "wait_device_us_per_pair", "host_fixup_pct", "pipeline_cpu_pct")
DEVICE_SIDE = ("wait_device_us_per_pair", "host_fixup_pct")


def _traffic():
    w = spec.workload(spec.bench(), NAME)
    tr = dict(spec.traffic(w["traffic"]))
    tr["samples"] = {"count": 3, "median_pairs": 1500, "sigma": 0.3}
    tr["check_pairs"] = 300
    return tr


@pytest.mark.parametrize("trace", [False, True])
def test_the_port_metrics_of_a_small_run(trace, cpu_port):
    from pandaseq_tpu_torch import tracing
    tracing.clear()
    r, _ = cell.run(NAME, 2 ** 31 + 4242, 1.0, trace, time.perf_counter(),
                    engine=cpu_port, traffic=_traffic(), workers=2)
    assert r["correct"] is True
    b = spec.bench()
    assert set(PORT) <= {m["name"] for m in b["per_layer"]}
    if not trace:
        run = cell.Run(jobs=[], window_s=1.0, cpu_s=1.0, setup_s=0.0)
        assert all(spec.reader(n)(run) is None for n in PORT)
        assert not set(PORT) & set(r["metrics"])
        return
    got = {n: r["metrics"][n]["value"] for n in PORT}
    for n in DEVICE_SIDE:  # the host engine launches nothing
        assert got[n] == 0, n
    for n in set(PORT) - set(DEVICE_SIDE):
        assert got[n] > 0, n
    assert got["pipeline_cpu_pct"] <= 100
    # per job: one job span, its pairs the STAT READS of the job
    jobs = tracing.collected().jobs
    assert len(jobs) == r["info"]["jobs"]
    assert sum(c["pairs"] for c in jobs.values()) == r["info"]["pairs"]


def test_a_run_the_spans_do_not_account_for_reads_nothing(cpu_port):
    """Spans left from an earlier traced job make the job count differ:
    the readers return None rather than mix two runs."""
    from pandaseq_tpu_torch import tracing
    tracing.clear()
    cell.run(NAME, 2 ** 31 + 4243, 0.5, True, time.perf_counter(),
             engine=cpu_port, traffic=_traffic(), workers=2)
    r, _ = cell.run(NAME, 2 ** 31 + 4244, 0.5, True, time.perf_counter(),
                    engine=cpu_port, traffic=_traffic(), workers=2)
    assert r["correct"] is True
    assert not set(PORT) & set(r["metrics"])
    tracing.clear()
