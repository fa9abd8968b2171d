"""wait_device_us_per_pair: the port's ``wait.device`` spans
(pandaseq_tpu_torch/tracing.py), the finalize worker waiting on a device
step's download, summed, per pair read."""

from harness import port_spans


def read(run):
    return port_spans.us_per_pair(run, "wait.device")
