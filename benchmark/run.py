#!/usr/bin/env python3
"""Runs one cell of the benchmark of pandaseq_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. It makes its inputs from the seed, warms up, merges the cell's
samples one CLI job after another for ``--seconds``, checks the jobs'
output against the plain reference (``reference/``), and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, then
``info`` and, last, ``checks``: each number compared with its limit,
which also end standard error.

It exits non-zero and prints no result when no card is visible, when the
cell asks for more cards than there are, when a tuning variable of the
program is set, when the port is not beside this directory, and when
JAX or the JAX package pandaseq_tpu was loaded.
"""

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (/proc, 10 ms ticks)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))


T_PROCESS0 = time.perf_counter() - _process_age()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's own knobs: the benchmark runs its defaults
TUNING = ("PANDASEQ_TPU_ENGINE", "PANDASEQ_TPU_HYBRID",
          "PANDASEQ_TPU_OFFLOAD", "PANDASEQ_TPU_GROUP", "PANDASEQ_TPU_DEPTH",
          "PANDASEQ_TPU_BATCH", "PANDASEQ_TPU_HOST", "PANDASEQ_TPU_JOIN",
          "PANDASEQ_TPU_NO_NATIVE", "PANDASEQ_TPU_PROFILE",
          "PANDASEQ_TORCH_DEVICE")
FORBIDDEN = ("jax", "jaxlib", "flax", "pandaseq_tpu")


def loaded_forbidden() -> list[str]:
    """Modules of sys.modules whose top-level name is one of FORBIDDEN,
    compared whole (pandaseq_tpu_torch is not pandaseq_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def fail(msg: str) -> int:
    sys.stderr.write("benchmark: %s\n" % msg)
    return 1


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_knobs = [k for k in TUNING if k in os.environ]
    if set_knobs:
        return fail("the program's tuning variables are set: %s"
                    % ", ".join(set_knobs))
    # the port's builds and any Triton cache stay in fixed directories
    # of this checkout: only a checkout's first run builds
    os.environ["PANDASEQ_TPU_CACHE"] = os.path.join(HERE, ".cache", "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    try:
        import pandaseq_tpu_torch
    except ImportError as e:
        return fail("the port is not importable: %s" % e)
    if os.path.dirname(os.path.dirname(
            os.path.abspath(pandaseq_tpu_torch.__file__))) != ROOT:
        return fail("pandaseq_tpu_torch comes from %s, not this checkout"
                    % pandaseq_tpu_torch.__file__)

    from harness import cell, spec
    chips = spec.workload(spec.bench(), args.workload)["chips"]
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        return fail("the cell asks for %d cards, %d are visible"
                    % (chips, torch.cuda.device_count()))

    result, checks = cell.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_PROCESS0)
    bad = loaded_forbidden()
    if bad:
        return fail("modules of JAX or the JAX package are loaded: %s"
                    % ", ".join(bad))
    import json
    for name, value, limit, op in checks:
        sys.stderr.write("check %s %s, limit %s %s\n"
                         % (name, value, "at most" if op == "max"
                            else "at least", limit))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
