"""The port CLI's input and output options against the JAX CLI on the
CPU, on tests/data/synth_*: PHRED+64 input (-6), index reads (-i), the
malformed inputs of tests/test_malformed.py and the empty pair,
compressed and CRLF inputs, the unaligned-pair files (-u / -U), bz2
output (-W) with a log file (-g), and a bz2 log (-G) beside an output
file (-w). Stdout, the return code and the stderr line sequence
(tests/test_torch_cli.py norm_stderr) equal; every file the run writes
equal byte for byte after bz2 decompression, the logs through
norm_stderr. Zero tolerance."""

import bz2
import gzip
import os
import shutil

import pytest

from tests.test_torch_cli import DATA, norm_stderr, run_modules

F1 = os.path.join(DATA, "synth_1.fastq")
F2 = os.path.join(DATA, "synth_2.fastq")
PACKAGES = ("pandaseq_tpu.cli.main", "pandaseq_tpu_torch")


def _lines(path):
    with open(path) as fh:
        return fh.readlines()


def _write(path, lines):
    with open(path, "w") as fh:
        fh.writelines(lines)
    return str(path)


def _mutate(tmp, src, name, line_no, new_line):
    """``src`` with line ``line_no`` replaced (or the file cut there when
    ``new_line`` is None), as tests/test_malformed.py makes them."""
    lines = _lines(src)
    lines = lines[:line_no] if new_line is None \
        else lines[:line_no] + [new_line] + lines[line_no + 1:]
    return _write(tmp / name, lines)


def _not_paired(tmp):
    lines = _lines(F2)
    lines[40] = lines[40].replace(":2010", ":9999")
    return F1, _write(tmp / "p2.fastq", lines)


def _phred64(tmp):
    out = []
    for src, name in ((F1, "p64_1.fastq"), (F2, "p64_2.fastq")):
        lines = [ln if n % 4 != 3 else
                 "".join(chr(ord(c) + 31) for c in ln.rstrip()) + "\n"
                 for n, ln in enumerate(_lines(src))]
        out.append(_write(tmp / name, lines))
    return out


def _index(tmp):
    lines = []
    for n, ln in enumerate(_lines(F1)):
        if n % 4 == 0:
            tag = "ACGT" if (n // 4) % 2 == 0 else "TTGG"
            lines += [ln, tag + "\n", "+\n", "I" * len(tag) + "\n"]
    return _write(tmp / "index.fastq", lines)


def _compressed(tmp):
    f1 = str(tmp / "c_1.fastq.gz")
    f2 = str(tmp / "c_2.fastq.bz2")
    with open(F1, "rb") as src, gzip.open(f1, "wb") as dst:
        shutil.copyfileobj(src, dst)
    with open(F2, "rb") as src, bz2.open(f2, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return f1, f2


def _crlf(tmp):
    return _write(tmp / "crlf_1.fastq",
                  [ln.rstrip("\n") + "\r\n" for ln in _lines(F1)]), F2


# {case: (make(tmp) -> (forward, reverse, extra args), the files the run
# writes: {flag: bz2?}, whether stdout holds merged reads)}
CASES = {
    "phred64": (lambda t: (*_phred64(t), ["-6"]), {}, True),
    "index_reads": (lambda t: (F1, F2, ["-i", _index(t)]), {}, True),
    "bad_nt_mid_stream": (lambda t: (_mutate(t, F1, "m1.fastq", 41,
                                             "ACGTZZZACGT\n"), F2, []),
                          {}, True),
    "truncated_file": (lambda t: (_mutate(t, F1, "t1.fastq", 42, None), F2,
                                  []), {}, True),
    "not_paired": (lambda t: (*_not_paired(t), []), {}, True),
    "missing_separator": (lambda t: (_mutate(t, F1, "s1.fastq", 42,
                                             "NOTPLUS\n"), F2, []),
                          {}, True),
    "qual_length_mismatch": (lambda t: (_mutate(t, F1, "q1.fastq", 43,
                                                "III\n"), F2, []),
                             {}, True),
    "empty_pair": (lambda t: (_write(t / "e1.fastq", []),
                              _write(t / "e2.fastq", []), []), {}, False),
    "gzip_fwd_bz2_rev": (lambda t: (*_compressed(t), []), {}, True),
    "crlf_fwd": (lambda t: (*_crlf(t), []), {}, True),
    "unaligned_fasta": (lambda t: (F1, F2, ["-o", "150"]), {"-u": False},
                        True),
    "unaligned_fastq": (lambda t: (F1, F2, ["-o", "150"]), {"-U": False},
                        True),
    "bz2_out_with_log": (lambda t: (F1, F2, []), {"-W": True, "-g": False},
                         False),
    "out_with_bz2_log": (lambda t: (F1, F2, []), {"-w": False, "-G": True},
                         False),
}
LOGS = ("-g", "-G")


def _read(path, compressed):
    with (bz2.open if compressed else open)(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("case", list(CASES))
def test_input_option_port_cli_equals_jax_cli(tmp_path, case):
    make, outputs, merged = CASES[case]
    fwd, rev, extra = make(tmp_path)
    files = {pkg: {flag: str(tmp_path / ("%s%s.out" % (pkg, flag)))
                   for flag in outputs} for pkg in PACKAGES}
    argv = {pkg: ["-T", "1", "-f", fwd, "-r", rev, *extra]
            + [a for flag, path in files[pkg].items() for a in (flag, path)]
            for pkg in PACKAGES}
    runs = {}
    for pkg, proc in zip(PACKAGES, run_modules([(pkg, argv[pkg])
                                                for pkg in PACKAGES])):
        written = {}
        for flag, path in files[pkg].items():
            data = _read(path, outputs[flag])
            written[flag] = norm_stderr(data) if flag in LOGS else data
        runs[pkg] = (proc.stdout, proc.returncode,
                     norm_stderr(proc.stderr), written)
    want, got = runs["pandaseq_tpu.cli.main"], runs["pandaseq_tpu_torch"]
    assert got == want
    assert bool(want[0]) == merged
    for flag, data in want[3].items():
        assert data, flag  # every file the run writes holds records
    if case == "index_reads":  # the tags come from the index reads
        assert b":ACGT;" in want[0] or b":TTGG;" in want[0]
    if case == "empty_pair":
        assert want[1] == 1
