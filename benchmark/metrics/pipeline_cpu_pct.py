"""pipeline_cpu_pct: the CPU time of the threads that call into the port,
as a share of the process's CPU over the window: each thread's outermost
spans (pandaseq_tpu_torch/tracing.py: ``job`` on the main thread,
``decode`` and ``pre`` on the prefetch thread, ``finalize`` on the
worker), their thread CPU summed. The rest is the native OpenMP teams
and what no span covers."""

from harness import port_spans


def read(run):
    got = port_spans.window(run)
    if got is None or not run.cpu_s:
        return None
    cpu = sum(s.cpu for s in got.spans
              if s.parent is None and s.job is not None)
    return 100.0 * cpu / 1e9 / run.cpu_s
