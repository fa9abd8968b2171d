"""pairs_per_s: the pairs read by all the window's jobs (the sum of their
STAT READS) over the time from the first job's start to the last job's
end, on the host clock."""


def read(run):
    return run.pairs / run.window_s if run.window_s > 0 else None
