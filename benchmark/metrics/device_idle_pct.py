"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card (harness/trace.py)."""


def read(run):
    if run.trace is None or not run.trace["window_s"]:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
