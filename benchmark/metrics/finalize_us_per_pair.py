"""finalize_us_per_pair: the wall time of the traced run's ``finalize`` spans
(harness/spans.py), summed over every thread, per pair read."""


def read(run):
    if run.spans is None or not run.pairs:
        return None
    total = run.spans.total("finalize")
    return total / run.pairs * 1e6 if total else None
