"""job_drain_ms: the median over the traced window's CLI jobs of the
port's ``job.drain`` span (pandaseq_tpu_torch/tracing.py): from the main
thread's dispatch of the job's last batch to run()'s return (the last
finalizes and emits, the STAT block, the closes)."""

from harness import port_spans


def read(run):
    got = port_spans.window(run)
    return None if got is None else port_spans.median_ms(got, "job.drain")
