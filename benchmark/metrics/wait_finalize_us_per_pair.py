"""wait_finalize_us_per_pair: the port's ``wait.finalize`` spans
(pandaseq_tpu_torch/tracing.py), the main thread blocked on the finalize
worker's futures, summed, per pair read."""

from harness import port_spans


def read(run):
    return port_spans.us_per_pair(run, "wait.finalize")
