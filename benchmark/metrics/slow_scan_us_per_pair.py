"""slow_scan_us_per_pair: the port's ``slow_scan_ns`` counter
(BatchAssembler.engine_counters()), the time psq_finalize spends
scoring every overlap of its SLOW rows (pairs with no k-mer candidate),
on each thread's steady clock, summed over its OpenMP threads and the
window's jobs, per pair read. None where the jobs carry no such counter
(a port without it)."""

from harness import port_spans


def read(run):
    got = port_spans.window(run)
    if got is None or not run.pairs or not all(
            "slow_scan_ns" in c for c in got.jobs.values()):
        return None
    return port_spans.counter(got, "slow_scan_ns") / 1e3 / run.pairs
