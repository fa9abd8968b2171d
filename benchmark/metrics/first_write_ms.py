"""first_write_ms: the median over the window's jobs of the time from
main()'s call to the first byte in the FASTA sink."""

import statistics


def read(run):
    firsts = [j.first_write_s for j in run.jobs
              if j.first_write_s is not None]
    return statistics.median(firsts) * 1e3 if firsts else None
