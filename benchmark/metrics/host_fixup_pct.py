"""host_fixup_pct: the port's ``fixup_rows`` counter
(BatchAssembler.engine_counters()), rows of a device step whose
candidate mask the host recomputed (N bases, more candidates than the
list holds), summed over the window's jobs, as a share of pairs read."""

from harness import port_spans


def read(run):
    got = port_spans.window(run)
    if got is None or not run.pairs:
        return None
    return 100.0 * port_spans.counter(got, "fixup_rows") / run.pairs
