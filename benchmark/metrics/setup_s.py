"""setup_s: from the process's start to the window's start: imports, the
card's context, the inputs' generation, the builds of a first run and
one warm-up job on each of the cell's sample files."""


def read(run):
    return run.setup_s
