#!/usr/bin/env python3
"""The control of the check that decides ``correct``.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13

For each seed it makes a cell's inputs as a run does, draws the pairs a
run's check compares (every sample done), and puts the reference
computed one precision lower (float32 for the configurations' stated
float64) in the program's place: the float32 outcomes of the drawn
pairs are printed as the CLI prints them (``as_job``) and go through the
check's own comparison (``harness.check.compare`` and ``holds``) against
the float64 reference. It prints, per seed, the control's
``pairs_off_reference``, ``correct`` (false where the check fails it)
and the seconds each reference took. It draws the inputs on the card where there is one, as
a run does (elsewhere on the CPU, whose draws differ), and imports
neither the port nor JAX.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def as_job(sample: int, outs, engine: str):
    """A kept job whose FASTA and log hold what the CLI prints for these
    reference outcomes: the records, the BESTOLP, LOWQ, NOFP and NORP
    lines and a STAT block of their counts."""
    from harness import jobs
    out = jobs.Sink(True)
    log = jobs.Sink(True, skip=jobs.STAT)
    log.write(("INFO\tENGINE\t%s\n" % engine).encode())
    stat = dict.fromkeys(("READS", "OK", "LOWQ", "NOALGN", "BADR", "NOFP",
                          "NORP", "SLOW"), 0)
    for sid, code, fasta, olp, lowq in outs:
        stat["READS"] += 1
        stat[code] += 1
        if fasta is not None:
            out.write(fasta)
        if olp is not None:
            log.write(b"INFO\tBESTOLP\t%s\t%d\n" % (sid.encode(), olp))
        if code == "LOWQ":
            log.write(b"ERR\tLOWQ\t%s\t%s\n" % (sid.encode(),
                                                 lowq.encode()))
        elif code in ("NOFP", "NORP"):
            log.write(b"ERR\t%s\t%s\n" % (code.encode(), sid.encode()))
    job = jobs.Job(sample, 0.0, 0.0, 0, out, log)
    job.stat = stat
    return job


def judge(want: dict, got: dict) -> list:
    """The check's numbers of ``got`` ({sample index: [outcome]}) printed
    as the program's output and compared with the reference ``want``."""
    from harness import check
    first = {i: as_job(i, outs, "control") for i, outs in got.items()}
    off, checked, off_counts = check.compare(first, want)
    return [("counts_off_output", off_counts, 0, "max"),
            ("pairs_off_reference", off, 0, "max"),
            ("pairs_checked", checked, 1, "min")]


def control(name: str, seed: int, workers=None) -> dict:
    from harness import check, generate, spec
    b = spec.bench()
    w = spec.workload(b, name)
    cfg = spec.config(b, w["config"])
    tr = spec.traffic(w["traffic"])
    sizes = generate.sample_sizes(tr["samples"])
    import torch
    with tempfile.TemporaryDirectory(prefix="pandaseq-control-") as tmp:
        pool = generate.make_pool(cfg, tr, max(sizes), seed,
                                  "cuda" if torch.cuda.is_available()
                                  else "cpu")
        samples = generate.write_samples(pool, cfg, sizes, tmp)
        del pool
        picks = check.draw(samples, {s.index for s in samples},
                           tr["check_pairs"], seed)
        out = {"workload": name, "seed": seed}
        refs = {}
        for precision in ("float64", "float32"):
            t0 = time.perf_counter()
            refs[precision] = check.run_reference(
                samples, picks, cfg.get("flags", []), precision, workers)
            out[precision + "_s"] = time.perf_counter() - t0
    checks = judge(refs["float64"], refs["float32"])
    out.update({n: v for n, v, _, _ in checks})
    out["correct"] = check.holds(checks)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workers", type=int, default=None)
    args = ap.parse_args(argv)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, args.workers)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
