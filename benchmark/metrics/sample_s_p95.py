"""sample_s_p95: the 95th percentile (nearest rank) of the wall time of
every job of the window, from main()'s call to its return."""

import math


def read(run):
    walls = sorted(j.wall for j in run.jobs)
    if not walls:
        return None
    return walls[math.ceil(0.95 * len(walls)) - 1]
