"""The slice end to end: the PyTorch port's CLI (``python -m
pandaseq_tpu_torch``, plain twins on the CPU) against pandaseq_tpu's CLI
(JAX on the CPU) on tests/data/synth_*: stdout byte-identical and the
stderr line sequence identical once the volatile lines are masked as in
tests/test_cli.py test_stderr_line_sequence_parity."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
BASE = ["-T", "1", "-f", os.path.join(DATA, "synth_1.fastq"),
        "-r", os.path.join(DATA, "synth_2.fastq")]
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
           PANDASEQ_TPU_HOST="0", PANDASEQ_TORCH_DEVICE="cpu",
           OMP_NUM_THREADS="1")


def run_module(module, args, env=ENV):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, env=env, cwd=ROOT,
                          timeout=300)


def run_modules(runs, env=ENV):
    """``run_module`` of each (module, args) of ``runs``, all at once;
    returns their CompletedProcess objects in order."""
    procs = [subprocess.Popen([sys.executable, "-m", module, *args],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, cwd=ROOT)
             for module, args in runs]
    out = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            out.append(subprocess.CompletedProcess(proc.args,
                                                   proc.returncode, stdout,
                                                   stderr))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# the head line of an absl / XLA log record (``E1017 19:02:11.123456 ...``)
XLA_HEAD = re.compile(r"^[EWI]\d{4} ")
# a line the CLI writes: a tab-separated key (after the -T thread tag and
# a module's name, if any), or one of the log's "* * * * *" hint lines
CLI_LINE = re.compile(r"^(?:0x[0-9a-f]+:\d+\t)?(?:[^\t]*\t)?"
                      r"(?:INFO|STAT|ERR|DBG|ARG\[\d+\])\t"
                      r"|^\* \* \* \* \* ")


def norm_stderr(raw):
    """The stderr line sequence with the volatile lines masked. A
    process log record of absl / XLA (JAX's side only) is dropped whole:
    its head line and every line after it up to the next line in the
    CLI's form (CLI_LINE). XLA's slow-operation alarm spans paragraphs
    and blank lines, and fires when a compile outlasts a second, so it
    comes and goes with the load on the host."""
    out = []
    in_record = False
    for ln in raw.decode(errors="replace").splitlines():
        if XLA_HEAD.match(ln):
            in_record = True
            continue
        if in_record and not CLI_LINE.match(ln):
            continue
        in_record = False
        ln = re.sub(r"0x[0-9a-f]+:\d+\t", "", ln)
        ln = re.sub(r"STAT\tTIME\t.*", "STAT\tTIME\t<t>", ln)
        ln = re.sub(r"STAT\tELAPSED\t\d+", "STAT\tELAPSED\t<e>", ln)
        if ln.startswith(("INFO\tVER", "INFO\tUNAME", "ARG[",
                          "INFO\tENGINE")):
            continue
        out.append(ln)
    return out


def check_port_cli_equals_jax_cli(extra):
    want = run_module("pandaseq_tpu.cli.main", BASE + extra)
    got = run_module("pandaseq_tpu_torch", BASE + extra)
    assert want.returncode == 0 and want.stdout
    assert got.stdout == want.stdout
    assert got.returncode == want.returncode
    assert norm_stderr(got.stderr) == norm_stderr(want.stderr)
    assert b"INFO\tENGINE\tcpu" in got.stderr


@pytest.mark.parametrize("extra", [[], ["-F"], ["-k", "1"]])
def test_port_cli_equals_jax_cli(extra):
    check_port_cli_equals_jax_cli(extra)


# XLA's slow constant-folding alarm as a JAX compile under load prints it
# (slow_operation_alarm.cc), between two of the CLI's lines
XLA_ALARM = """\
E1017 19:02:11.123456   81234 slow_operation_alarm.cc:65] Constant folding \
an instruction is taking > 1s:

  %reduce.12 = s32[4096]{0} reduce(s32[4096,256]{1,0} %constant.7, s32[] \
%constant.3), dimensions={1}, to_apply=%region_0.8

This isn't necessarily a bug; constant-folding is inherently a trade-off \
between compilation time and speed at runtime. XLA has some guards that \
attempt to keep constant folding from taking too long, but fundamentally \
you'll always be able to come up with an input program that takes a long \
time.

If you'd like to file a bug, run with envvar XLA_FLAGS=--xla_dump_to=/tmp/foo \
and attach the results.
E1017 19:02:12.987654   81234 slow_operation_alarm.cc:133] The operation \
took 1.864312s
Constant folding an instruction is taking > 1s:

  %reduce.12 = s32[4096]{0} reduce(s32[4096,256]{1,0} %constant.7, s32[] \
%constant.3), dimensions={1}, to_apply=%region_0.8

This isn't necessarily a bug; constant-folding is inherently a trade-off \
between compilation time and speed at runtime. XLA has some guards that \
attempt to keep constant folding from taking too long, but fundamentally \
you'll always be able to come up with an input program that takes a long \
time.

If you'd like to file a bug, run with envvar XLA_FLAGS=--xla_dump_to=/tmp/foo \
and attach the results.
"""


def test_norm_stderr_drops_the_xla_alarm_and_keeps_the_cli_lines():
    cli = ["INFO\tENGINE\ttpu (env)", "STAT\tTHREADS\t1",
           "only_short\tINFO\tBESTOLP\tM00000:7:1:10000:2000\t172",
           "0x7f3a:1\tERR\tNOALGN\tM00000:7:1:10001:2001",
           "* * * * * Something is wrong with this ID.",
           "STAT\tREADS\t300", "DBG\tKMER\tx", "ARG[1]\t-T",
           "Unable to open module nope."]
    plain = "\n".join(cli).encode()
    # the alarm between two CLI lines, at the start and at the end
    for at in (2, 0, len(cli)):
        raw = "\n".join(cli[:at] + [XLA_ALARM.rstrip("\n")]
                        + cli[at:]).encode()
        assert norm_stderr(raw) == norm_stderr(plain)
    assert norm_stderr(plain) == [
        "STAT\tTHREADS\t1",
        "only_short\tINFO\tBESTOLP\tM00000:7:1:10000:2000\t172",
        "ERR\tNOALGN\tM00000:7:1:10001:2001",
        "* * * * * Something is wrong with this ID.",
        "STAT\tREADS\t300", "DBG\tKMER\tx",
        "Unable to open module nope."]
    # the alarm alone leaves nothing; the first line only was dropped
    # before, leaving its paragraphs to fail the comparison
    assert norm_stderr(XLA_ALARM.encode()) == []
