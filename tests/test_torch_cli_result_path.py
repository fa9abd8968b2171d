"""The port CLI's result-object path (cli/main.py: assemble_stream and
one result object a pair, taken for -a, the -d replay flags and a -C
module without check_batch) against the JAX CLI on the CPU: stdout, the
return code and the stderr line sequence equal, with the volatile lines
masked as in tests/test_torch_cli.py (STAT TIME / ELAPSED, and the ARG
lines, one of which holds the module file's path). Each -C module file
imports its own package's filters.Module."""

import os
import re
import subprocess
import sys

import pytest

from tests.test_torch_cli import norm_stderr, run_module

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the primers of tests/test_oracle_primers.py
FWD_PRIMER = "GTGCCAGCMGCCGCGGTAA"
REV_PRIMER = "GGACTACHVGGGTWTCTAAT"
# a check module without check_batch: keeps merged reads no longer than
# its argument (default 400)
ONLY_SHORT = '''from {pkg}.filters import Module

api = 3


def opener(args, logger):
    limit = int(args) if args else 400
    return Module("only_short", check=lambda res: res.sequence_length
                  <= limit, args=args)
'''
CONFIGS = {
    "post_primers": ("primed", ["-p", FWD_PRIMER, "-q", REV_PRIMER, "-a"]),
    "post_primers_fastq": ("primed", ["-p", FWD_PRIMER, "-q", REV_PRIMER,
                                      "-a", "-F"]),
    "debug_replay": ("n", ["-d", "rkm", "-N"]),
    "module_file": ("n", ["-C", "{module}:400"]),
    "module_file_post_primers": ("primed", ["-p", FWD_PRIMER, "-q",
                                            REV_PRIMER, "-a", "-C",
                                            "{module}:420"]),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("result_path")
    out = {}
    for name, args in (("primed", ["--pairs", "300", "--seed", "5",
                                   "--fwd-primer", FWD_PRIMER,
                                   "--rev-primer", REV_PRIMER]),
                       ("n", ["--pairs", "150", "--seed", "12",
                              "--n-run-rate", "0.2"])):
        prefix = str(d / name)
        subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "golden",
                                     "make_data.py"),
                        "--out-prefix", prefix, *args],
                       check=True, stdout=subprocess.DEVNULL)
        out[name] = ["-f", prefix + "_1.fastq", "-r", prefix + "_2.fastq"]
    for pkg in ("pandaseq_tpu", "pandaseq_tpu_torch"):
        (d / pkg).mkdir()
        (d / pkg / "only_short.py").write_text(ONLY_SHORT.format(pkg=pkg))
        out[pkg] = str(d / pkg / "only_short.py")
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_result_path_equals_jax_cli(inputs, config):
    data, extra = CONFIGS[config]

    def argv(pkg):
        return (["-T", "1"] + inputs[data]
                + [a.format(module=inputs[pkg]) for a in extra])

    want = run_module("pandaseq_tpu.cli.main", argv("pandaseq_tpu"))
    got = run_module("pandaseq_tpu_torch", argv("pandaseq_tpu_torch"))
    assert want.returncode == 0 and want.stdout
    assert got.stdout == want.stdout
    assert got.returncode == want.returncode
    assert norm_stderr(got.stderr) == norm_stderr(want.stderr)
    assert b"INFO\tENGINE\tcpu" in got.stderr
    if "{module}" in " ".join(extra):
        # the module ran and rejected some merged reads
        assert re.search(rb"^STAT\tonly_short\t[1-9]\d*$", got.stderr,
                         re.M)
