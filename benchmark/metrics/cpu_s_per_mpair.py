"""cpu_s_per_mpair: the process's CPU time over the window, all threads
(``time.process_time``), per million pairs read."""


def read(run):
    return run.cpu_s / run.pairs * 1e6 if run.pairs else None
