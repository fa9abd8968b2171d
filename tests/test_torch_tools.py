"""The PyTorch port's companion tools against the JAX package's on the
CPU: ``python -m pandaseq_tpu_torch.cli.{checkid,hang,diffcmd}`` (the
port with ``PANDASEQ_TORCH_DEVICE=cpu PANDASEQ_TPU_ENGINE=tpu``: the
plain device step) against ``python -m pandaseq_tpu.cli.{checkid,hang,
diffcmd}`` (JAX on the CPU). Stdout and exit status are equal; for
checkid stderr too, for hang the log's line sequence once the volatile
lines are masked (tests/test_torch_cli.py ``norm_stderr``). A diff pass
that fails exits 2 with its traceback.

The hang tool's per-pair path (``HangReader``, over the Python reader)
runs in process: the JAX package's with its ``io.native.get_lib``
patched to None; the port's, whose engine refuses to run without the
native library, through the CLI's reader switch
``PANDASEQ_TPU_NO_NATIVE``."""

import os
import subprocess
import sys

import pytest

from tests.test_torch_cli import ENV, ROOT, norm_stderr

DATA = os.path.join(ROOT, "tests", "data")
F1 = os.path.join(DATA, "synth_1.fastq")
F2 = os.path.join(DATA, "synth_2.fastq")
FWD_PRIMER = "GTGCCAGCMGCCGCGGTAA"
REV_PRIMER = "GGACTACHVGGGTWTCTAAT"
PORT_ENV = dict(ENV, PANDASEQ_TORCH_DEVICE="cpu", PANDASEQ_TPU_ENGINE="tpu")


def _tool(package, tool, args):
    env = PORT_ENV if package == "pandaseq_tpu_torch" else ENV
    return subprocess.run(
        [sys.executable, "-m", "%s.cli.%s" % (package, tool), *args],
        capture_output=True, env=env, cwd=ROOT, timeout=300)


def _both(tool, args):
    """(JAX package's run, port's run) of one tool."""
    return _tool("pandaseq_tpu", tool, args), \
        _tool("pandaseq_tpu_torch", tool, args)


@pytest.fixture(scope="module")
def primed(tmp_path_factory):
    """150 primed pairs made by tests/golden/make_data.py, as
    tests/test_oracle_primers.py makes them."""
    prefix = str(tmp_path_factory.mktemp("primed") / "primer")
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tests", "golden", "make_data.py"),
                    "--out-prefix", prefix, "--fwd-primer", FWD_PRIMER,
                    "--rev-primer", REV_PRIMER, "--pairs", "150",
                    "--seed", "7"], check=True, cwd=ROOT)
    return prefix + "_1.fastq", prefix + "_2.fastq"


@pytest.mark.parametrize("args", [
    ["M01271:10:000000000-A3WGH:1:1101:18786:6175 1:N:0:1"],
    ["M00000:7:000000000-TEST1:1:1101:10000:2000 2:N:0:ACGTAC"],
    ["HWUSI-EAS100R:6:73:941:1973#ACGT/1"],
    ["SRR014849.1 EIXKN4201CFU84.1 length=93"],
    ["complete garbage"],
    ["@M01271:10:000000000-A3WGH:1:1101:18786:6175 1:N:0:1",
     "@bad header"],
    ["-h"],
    ["-v"],
], ids=["casava17", "casava17-tag", "casava14", "sra", "garbage", "at",
        "help", "version"])
def test_checkid_equals_jax(args):
    want, got = _both("checkid", args)
    assert want.stdout or want.stderr
    assert got.stdout == want.stdout
    assert got.stderr == want.stderr
    assert got.returncode == want.returncode


HANG_ARGS = ["-P", REV_PRIMER, "-Q", FWD_PRIMER]


@pytest.mark.parametrize("extra", [
    [], ["-s"], ["-t", "0.5"], ["-t", "2"], ["-P", "ACGTZ"]],
    ids=["primers", "skip", "threshold", "bad-threshold", "bad-primer"])
def test_hang_equals_jax(primed, extra):
    args = ["-T", "1", "-f", primed[0], "-r", primed[1]] + (
        extra if extra[:1] == ["-P"] else HANG_ARGS + extra)
    want, got = _both("hang", args)
    assert got.returncode == want.returncode
    assert got.stdout == want.stdout  # the FASTA
    assert norm_stderr(got.stderr) == norm_stderr(want.stderr)
    if extra in ([], ["-s"], ["-t", "0.5"]):
        assert want.stdout and want.returncode == 0


def test_hang_reader_path_equals_jax(primed, tmp_path, monkeypatch):
    """The per-pair HangReader path of both tools, in process."""
    from pandaseq_tpu.cli import hang as jax_hang
    from pandaseq_tpu.io import native as jax_native
    from pandaseq_tpu_torch.cli import hang as port_hang
    from pandaseq_tpu_torch.io import native as port_native

    outs = {}
    for name, mod in (("jax", jax_hang), ("port", port_hang)):
        with monkeypatch.context() as m:
            if name == "jax":
                m.setattr(jax_native, "get_lib", lambda: None)
            else:
                m.setenv("PANDASEQ_TPU_NO_NATIVE", "1")
                m.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
                m.setenv("PANDASEQ_TPU_ENGINE", "tpu")
            made = []
            for cls in ("HangReader", "HangBatchFilter"):
                real = getattr(mod, cls)
                m.setattr(mod, cls, lambda *a, _r=real, _c=cls:
                          made.append(_c) or _r(*a))
            fa = tmp_path / (name + ".fa")
            log = tmp_path / (name + ".log")
            rc = mod.main(["-T", "1", "-f", primed[0], "-r", primed[1],
                           "-w", str(fa), "-g", str(log)] + HANG_ARGS)
            assert made == ["HangReader"], (name, made)
            outs[name] = (rc, fa.read_bytes(), norm_stderr(log.read_bytes()))
    assert port_native.get_lib() is not None
    assert outs["jax"][1] and outs["port"] == outs["jax"]
    # the per-pair path gives the native batch path's bytes
    batch_path = _tool("pandaseq_tpu_torch", "hang",
                       ["-T", "1", "-f", primed[0], "-r", primed[1]]
                       + HANG_ARGS)
    assert batch_path.stdout == outs["port"][1]


@pytest.mark.parametrize("args", [
    ["-f", F1, "-r", F2, "--", "--", "-t", "0.9"],
    ["-f", F1, "-r", F2, "--", "-A", "pear", "--", "-A", "rdp_mle"],
    ["-v", "-f", F1, "-r", F2, "--", "-A", "pear", "--", "-A", "rdp_mle"],
    ["-f", F1, "--", "--"],
], ids=["threshold", "pear-rdp_mle", "verbose", "missing-r"])
def test_diff_equals_jax(args):
    want, got = _both("diffcmd", args)
    assert want.stdout or want.stderr
    assert got.stdout == want.stdout
    assert got.returncode == want.returncode


def test_diff_failed_pass_exits_2(monkeypatch, capsys):
    """A pass that fails (here an injected kernel launch failure) prints
    its traceback and exits 2, never 0 (differences) or 1 (none)."""
    from pandaseq_tpu_torch.cli import diffcmd

    def broken(c, pairs):
        raise RuntimeError("cand_join kernel launch failed: injected")

    monkeypatch.setattr(diffcmd, "_assemble_all", broken)
    rc = diffcmd.main(["-f", F1, "-r", F2, "--", "--", "-t", "0.9"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == ""
    assert "Traceback" in err and "injected" in err
