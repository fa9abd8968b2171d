"""wait_prefetch_us_per_pair: the port's ``wait.prefetch`` spans
(pandaseq_tpu_torch/tracing.py), the main thread blocked on the prefetch
queue (decode and _pre behind), summed, per pair read."""

from harness import port_spans


def read(run):
    return port_spans.us_per_pair(run, "wait.prefetch")
