"""emit_us_per_pair: the port's ``emit`` spans (pandaseq_tpu_torch/
tracing.py), the CLI's per-batch body on the main thread (the payload
write, reject, BESTOLP and TIME lines), summed, per pair read."""

from harness import port_spans


def read(run):
    return port_spans.us_per_pair(run, "emit")
