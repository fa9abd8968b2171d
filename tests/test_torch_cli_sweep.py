"""A seeded random-config sweep of the PyTorch port's CLI (``python -m
pandaseq_tpu_torch``, plain twins on the CPU) against the JAX package's
CLI (``python -m pandaseq_tpu.cli.main``, JAX on the CPU), in the manner
of tests/golden/config_sweep.py but anchored on the JAX CLI rather than
the C binary: stdout and the return code equal, one case a config.

The N_CONFIGS configs are drawn from SEED. Together they cover ``-A``
(every algorithm, each at least once), ``-k`` in 0-8, ``-o`` / ``-O``
(up to 899: on the long primed reads that is past the 512-wide device
plane, so those batches take the overflow reroute), ``-l`` / ``-L``,
``-N``, ``-F``, ``-C`` chains, ``-t``, ``-B`` and ``-p`` / ``-q`` (primer
sequences, with ``-a``, on the primed reads; trim counts elsewhere);
``test_sweep_covers_the_flags`` holds the draw to that. Inputs:
tests/data/synth_* (200 2x250 pairs, regenerated by tests/conftest.py),
the tracked tests/data/negs_*, and 100 primed 2x440 pairs with N runs
that tests/golden/make_data.py writes from a fixed seed. The 2 * N_CONFIGS
CLI runs start together on POOL worker threads, so the file takes about
1 / POOL of running them in turn."""

import os
import random
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from tests.test_torch_cli import DATA, ROOT, run_module

SEED = 75
N_CONFIGS = 8
POOL = 4
ALGOS = ["simple_bayesian", "pear", "rdp_mle", "uparse", "ea_util", "flash",
         "stitch"]
FWD, REV = "GTGCCAGCMGCCGCGGTAA", "GGACTACHVGGGTWTCTAAT"
INPUTS = ("synth", "synth", "primed", "primed", "negs")
PLANE = 512  # the CLI's frame width: the device plane's widest O


def draw(seed=SEED, n=N_CONFIGS):
    """[(input name, argv)] of ``n`` configs; every algorithm comes first
    once, in a drawn order."""
    rng = random.Random(seed)
    algos = rng.sample(ALGOS, len(ALGOS)) + [
        rng.choice(ALGOS) for _ in range(n - len(ALGOS))]
    out = []
    for algo in algos:
        args = ["-T", "1", "-A", algo]
        data = rng.choice(INPUTS)
        if rng.random() < 0.5:
            args += ["-o", str(rng.choice([1, 2, 5, 10, 35, 60, 900]))]
        if rng.random() < 0.5:
            args += ["-O", str(rng.choice([0, 40, 80, 150, 300, 700, 899]))]
        if rng.random() < 0.6:
            args += ["-k", str(rng.randint(0, 8))]
        if rng.random() < 0.3:
            args += ["-t", str(rng.choice([0.05, 0.2, 0.45, 0.6, 0.8, 0.9,
                                           0.99]))]
        if rng.random() < 0.2:
            args += ["-B"]
        if rng.random() < 0.3:
            args += ["-l", str(rng.choice([5, 50, 150]))]
        if rng.random() < 0.3:
            args += ["-L", str(rng.choice([120, 260, 440]))]
        if rng.random() < 0.25:
            args += ["-N"]
        if rng.random() < 0.25:
            args += ["-F"]
        if rng.random() < 0.5:  # filter-module chains
            mods = rng.sample(
                ["min_phred:%d" % rng.choice([5, 10, 20]), "min_overlapbits",
                 "min_overlapbits:%d" % rng.choice([5, 10, 25]),
                 "completely_miss_the_point:%d" % rng.choice([0, 2, 6]),
                 "empty", "pear_test", "overlap_stat",
                 "validtag:%s" % rng.choice(["ACGTAC", "TTTTTT:GGGGGG"]),
                 "other_primer:f:ACGTACGT", "other_primer:r:TGCATG"],
                k=rng.choice([1, 1, 2, 3]))
            for m in mods:
                args += ["-C", m]
        if data == "primed":
            if rng.random() < 0.7:
                args += ["-p", FWD, "-q", REV]
                if rng.random() < 0.3:
                    args += ["-a"]
        elif rng.random() < 0.25:  # trim counts
            args += ["-p", str(rng.choice([1, 5, 20])),
                     "-q", str(rng.choice([1, 5, 20]))]
        out.append((data, args))
    return out


CONFIGS = draw()


def _flag(args, name):
    return args[args.index(name) + 1] if name in args else None


def test_sweep_covers_the_flags():
    flags = {a for _, args in CONFIGS for a in args}
    assert {"-o", "-O", "-k", "-l", "-L", "-N", "-F", "-C", "-p", "-q", "-a",
            "-t", "-B"} <= flags
    assert {_flag(a, "-A") for _, a in CONFIGS} == set(ALGOS)
    ks = {int(_flag(a, "-k")) for _, a in CONFIGS if "-k" in a}
    assert 0 in ks and max(ks) > 2
    # the long primed reads: maxo past the plane at -O >= 700
    assert any(d == "primed" and int(_flag(a, "-O") or 0) > PLANE
               for d, a in CONFIGS)
    assert any(d == "primed" and _flag(a, "-p") == FWD for d, a in CONFIGS)
    assert {d for d, _ in CONFIGS} == set(INPUTS)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{config index: (JAX CLI's run, port CLI's run)}, all runs started
    together on POOL threads."""
    prefix = str(tmp_path_factory.mktemp("sweep") / "primed")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "golden", "make_data.py"),
         "--pairs", "100", "--seed", "23", "--read-len", "440",
         "--amp-min", "500", "--amp-max", "870", "--n-run-rate", "0.05",
         "--fwd-primer", FWD, "--rev-primer", REV, "--out-prefix", prefix],
        check=True, cwd=ROOT, stdout=subprocess.DEVNULL)
    files = {name: ["-f", p + "_1.fastq", "-r", p + "_2.fastq"]
             for name, p in (("synth", os.path.join(DATA, "synth")),
                             ("negs", os.path.join(DATA, "negs")),
                             ("primed", prefix))}
    with ThreadPoolExecutor(POOL) as ex:
        futs = {i: [ex.submit(run_module, module, args + files[data])
                    for module in ("pandaseq_tpu.cli.main",
                                   "pandaseq_tpu_torch")]
                for i, (data, args) in enumerate(CONFIGS)}
        return {i: [f.result() for f in fs] for i, fs in futs.items()}


@pytest.mark.parametrize("i", range(N_CONFIGS),
                         ids=[" ".join(a[2:]) for _, a in CONFIGS])
def test_port_cli_equals_jax_cli_on_drawn_config(results, i):
    want, got = results[i]
    assert got.stdout == want.stdout
    assert got.returncode == want.returncode


def test_sweep_is_not_vacuous(results):
    """Most configs merge some pairs: the JAX CLI exits 0 with output on
    at least half of them."""
    ok = [want.returncode == 0 and want.stdout
          for want, _ in results.values()]
    assert sum(map(bool, ok)) >= N_CONFIGS // 2
