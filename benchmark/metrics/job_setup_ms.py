"""job_setup_ms: the median over the traced window's CLI jobs of the
port's ``job.setup`` span (pandaseq_tpu_torch/tracing.py): run()'s entry,
argv parsed, to the start of the batch stream (BatchAssembler, the
reader's open, the INFO lines)."""

from harness import port_spans


def read(run):
    got = port_spans.window(run)
    return None if got is None else port_spans.median_ms(got, "job.setup")
