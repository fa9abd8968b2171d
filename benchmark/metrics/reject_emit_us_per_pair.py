"""reject_emit_us_per_pair: the port's ``reject_emit_ns`` counter
(pandaseq_tpu_torch/cli/main.py), the main thread's time in the emit
loop's reject calls (LOWQ, NOFP / NORP lines) and the BESTOLP flush
before each, summed over the window's jobs, per pair read. None where
the jobs carry no such counter (a port without it)."""

from harness import port_spans


def read(run):
    got = port_spans.window(run)
    if got is None or not run.pairs or not all(
            "reject_emit_ns" in c for c in got.jobs.values()):
        return None
    return port_spans.counter(got, "reject_emit_ns") / 1e3 / run.pairs
