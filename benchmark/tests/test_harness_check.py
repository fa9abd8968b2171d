"""The check that decides ``correct``, on the CPU: the frozen reference
against the port's CLI, the float32 control, and the faults a run must
come out false on."""

import json
import os
import time

import numpy as np
import pytest

from harness import cell, check, generate, jobs, spec

CELLS = ("v3v4_2x300.samples", "v4_2x250.small_samples",
         "v3v4_2x300.r2trim_samples")
# a configuration no cell runs yet: ITS1 amplicons of 200-600 bp on
# 2x300 reads, so read-through, overlaps past the read length and NOALGN
ITS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "its1_2x300.json")


def its_config() -> dict:
    with open(ITS) as fh:
        return json.load(fh)


def _traffic(name, count, median, check_pairs):
    w = spec.workload(spec.bench(), name)
    tr = dict(spec.traffic(w["traffic"]))
    tr["samples"] = {"count": count, "median_pairs": median, "sigma": 0.3}
    tr["check_pairs"] = check_pairs
    return tr


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_cli(name, cpu_port):
    """Every pair of a few thousand of each configuration (and of the
    R2-cut traffic): the port's CLI on the CPU prints what the frozen
    reference prints."""
    tr = _traffic(name, 3, 800, 10000)
    r, checks = cell.run(name, 20261017, 0.5, False, time.perf_counter(),
                         engine=cpu_port, traffic=tr, workers=4)
    got = {n: v for n, v, _, _ in checks}
    assert got["pairs_checked"] == sum(
        generate.sample_sizes(tr["samples"]))
    assert r["correct"] is True, got


@pytest.mark.parametrize("extra", [["-o", "30"], ["-O", "450"],
                                   ["-t", "0.8"], ["-k", "0"]],
                         ids=["-o", "-O", "-t", "-k"])
def test_reference_agrees_with_the_cli_on_each_flag(extra, tmp_path,
                                                    cpu_port):
    """ITS-shaped pairs with read-through, merged with each of -o, -O, -t
    and -k set (on top of the configuration's -p, -q and, but where -O is
    the flag set, its -O 500): the port's CLI on the CPU prints for every
    pair what the frozen reference prints."""
    from pandaseq_tpu_torch.cli.main import main
    cfg = its_config()
    flags = cfg["flags"][:4] + (extra if extra[0] == "-O"
                                else cfg["flags"][4:] + extra)
    pool = generate.make_pool(cfg, {"r2_cut": None}, 500, 2 ** 31 + 18)
    samples = generate.write_samples(pool, cfg, [500, 300], tmp_path)
    done = [jobs.run_job(main, jobs.argv_of(dict(cfg, flags=flags), s),
                         s.index, True) for s in samples]
    checks, _ = check.run_checks(done, samples, flags, 10 ** 6, 18,
                                 cpu_port, workers=4)
    got = {n: v for n, v, _, _ in checks}
    assert check.holds(checks), got
    assert got["pairs_checked"] == 800
    olp = [int(line.rsplit(b"\t", 1)[1]) for line in
           done[0].log.data().split(b"\n")
           if line.startswith(b"INFO\tBESTOLP\t")]
    assert max(olp) > cfg["read_len"]


def test_the_float32_control_fails_the_check(tmp_path):
    """The reference one precision lower in the program's place, printed
    as the CLI prints and judged by the check's own comparison, comes
    out not correct; the float64 reference in its place comes out
    correct."""
    import control
    name = "v4_2x250.small_samples"
    b = spec.bench()
    cfg = spec.config(b, "v4_2x250")
    tr = _traffic(name, 2, 1500, 3000)
    sizes = generate.sample_sizes(tr["samples"])
    pool = generate.make_pool(cfg, tr, max(sizes), 8)
    samples = generate.write_samples(pool, cfg, sizes, tmp_path)
    picks = check.draw(samples, {0, 1}, tr["check_pairs"], 8)
    ref = check.run_reference(samples, picks, [], "float64", 4)
    ctl = check.run_reference(samples, picks, [], "float32", 4)
    same = dict((n, v) for n, v, _, _ in control.judge(ref, ref))
    assert check.holds(control.judge(ref, ref)), same
    assert same["pairs_checked"] == sum(map(len, picks.values()))
    checks = control.judge(ref, ctl)
    got = dict((n, v) for n, v, _, _ in checks)
    assert not check.holds(checks)
    assert got["pairs_off_reference"] > 0 and got["counts_off_output"] == 0


def _stale_launch(asm_cls, monkeypatch):
    """The device step returns what its previous call returned: a step
    that leaves its state unchanged. Every job of the window, the first
    one too, gets the output of another batch."""
    orig = asm_cls._launch
    last = {}

    def launch(self, *a):
        out = np.asarray(orig(self, *a))
        keep = last.get("out", out)
        last["out"] = out
        return np.resize(keep, (out.shape[0], keep.shape[1]))

    monkeypatch.setattr(asm_cls, "_launch", launch)


def _edit_payload(asm_cls, monkeypatch, edit):
    orig = asm_cls._finalize

    def finalize(self, st, dev, emit=None):
        out = orig(self, st, dev, emit)
        if emit is None:
            return out
        codes, payload, extras = out
        return codes, edit(bytes(payload)), extras

    monkeypatch.setattr(asm_cls, "_finalize", finalize)


def _half(payload):
    """Half of the batch left out: only its first half's records."""
    lines = payload.split(b"\n")
    return b"".join(lines[2 * i] + b"\n" + lines[2 * i + 1] + b"\n"
                    for i in range(len(lines) // 4))


def _altered(payload):
    """An answer altered where it is produced: one base of every 64th
    record flipped."""
    lines = payload.split(b"\n")
    for r in range(0, len(lines) // 2, 64):
        seq = bytearray(lines[2 * r + 1])
        seq[len(seq) // 2] = ord("A") if seq[len(seq) // 2] != ord("A") \
            else ord("C")
        lines[2 * r + 1] = bytes(seq)
    return b"\n".join(lines)


@pytest.mark.parametrize("fault", [None, "stale_step", "half_batch",
                                   "altered_answer"])
def test_a_run_with_a_fault_is_not_correct(fault, cpu_port, monkeypatch):
    """The rest of a run, its look for a card skipped, with the timed
    path's device step pinned (the plain PyTorch twin on the CPU) and
    broken underneath: correct comes out false for each fault, true
    without one. (One card: there is no exchange between cards to
    leave out.)"""
    from pandaseq_tpu_torch.assembler import BatchAssembler
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "tpu")
    if fault == "stale_step":
        _stale_launch(BatchAssembler, monkeypatch)
    elif fault == "half_batch":
        _edit_payload(BatchAssembler, monkeypatch, _half)
    elif fault == "altered_answer":
        _edit_payload(BatchAssembler, monkeypatch, _altered)
    name = "v4_2x250.small_samples"
    tr = _traffic(name, 2, 900, 600)
    r, checks = cell.run(name, 77, 0.5, False, time.perf_counter(),
                         engine="cpu (env)", traffic=tr, workers=4)
    got = {n: v for n, v, _, _ in checks}
    assert r["correct"] is (fault is None), got
    if fault is not None:
        assert got["pairs_off_reference"] > 0
