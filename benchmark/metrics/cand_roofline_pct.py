"""cand_roofline_pct: the candidate search's least time, summed over the
window's device steps (harness/roofline.py, from each launched batch's
shape and read lengths), as a share of the summed device time of every
kernel in the traced window, whatever its name."""

from harness.roofline import cand_least_s


def read(run):
    if run.trace is None or not run.trace["kernel_s"]:
        return None
    least = sum(cand_least_s(B, Lb, O, kmers)
                for sparse, B, Lb, O, kmers in run.spans.launches if sparse)
    return 100.0 * least / run.trace["kernel_s"] if least else None
