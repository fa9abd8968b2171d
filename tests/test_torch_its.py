"""The fungal ITS1 2x300 deployment on the port: the benchmark's
configuration (``benchmark/configs/its1_2x300.json``: ITS1F / ITS2
primers in the reads, 200-600 bp amplicons on 300 bp reads, ``-O 500``)
over 3,000 pairs drawn by the benchmark's generator
(``benchmark/harness/generate.py``). About half of them are read-through
pairs (the insert is shorter than a read, which runs into the Nextera
adapter), a quarter are LOWQ, a few SLOW (no k-mer candidate, so every
overlap up to 500 is scored) and NOALGN (inserts longer than both reads).

On the CPU the port's CLI, on the native host twin and on the plain
device step (``PANDASEQ_TPU_ENGINE=tpu``), prints what the benchmark's
plain reference (``benchmark/reference``) prints for every pair, runs
every batch in the (512, 512) bucket with no overflow reroute, and its
traced counters agree with its log. The tests marked ``cuda`` hold
``cand_join`` at Lb = O = 512 to its plain version on these pairs and
the CLI on the card to the host twin; on a machine with the card (no
JAX, hence no conftest) run

    python -m pytest --noconftest -q -m cuda tests/test_torch_its.py
"""

import json
import os

import numpy as np
import pytest
import torch

from pandaseq_tpu_torch import tracing
from pandaseq_tpu_torch.assembler import BatchAssembler
from tests.test_torch_tracing import run_cli, stable_log, stat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CONFIG = os.path.join(BENCH, "configs", "its1_2x300.json")
PAIRS = 3000
SEED = 2 ** 31 + 1919
BATCH = 1024  # three batches, the last one partial


@pytest.fixture(scope="module")
def its(tmp_path_factory):
    """(configuration, sample): the pairs as one sample's FASTQ pair."""
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(BENCH)
        from harness import generate
        pool = generate.make_pool(cfg, {"r2_cut": None}, PAIRS, SEED)
        sample, = generate.write_samples(
            pool, cfg, [PAIRS], str(tmp_path_factory.mktemp("its")))
    assert (pool.rlen == cfg["read_len"]).all()
    return cfg, sample


@pytest.fixture(scope="module")
def reference(its):
    """The reference's outcome of every pair, in file order: ``(sid,
    code, FASTA record, BESTOLP overlap, LOWQ text, SLOW)``, SLOW being
    the reference's ``res.slow`` (every overlap in range examined). One
    process, so that the suite's other workers keep their cores."""
    cfg, s = its
    offs = list(zip(s.offsets[0].tolist(), s.offsets[1].tolist()))
    slow = []
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(BENCH)
        from reference import merge, oracle
        assemble = oracle.assemble

        def spy(*a, **kw):
            res, code = assemble(*a, **kw)
            slow.append(bool(res is not None and res.slow))
            return res, code

        mp.setattr(oracle, "assemble", spy)
        out = merge.merge_records(s.paths[0], s.paths[1], offs, cfg["flags"])
    assert len(out) == len(slow) == PAIRS
    return [o + (sl,) for o, sl in zip(out, slow)]


def printed(out: bytes, log: bytes):
    """What the CLI printed, by pair id: FASTA records, LOWQ texts,
    BESTOLP overlaps, NOFP / NORP codes."""
    fasta, lowq, olp, rej = {}, {}, {}, {}
    lines = out.split(b"\n")
    for h, seq in zip(lines[0::2], lines[1::2]):
        fasta[h[1:h.rfind(b";")].decode()] = h + b"\n" + seq + b"\n"
    for line in log.split(b"\n"):
        f = line.split(b"\t", 3)
        if line.startswith(b"INFO\tBESTOLP\t"):
            olp[f[2].decode()] = int(f[3])
        elif line.startswith(b"ERR\tLOWQ\t"):
            lowq[f[2].decode()] = f[3].decode()
        elif line.startswith((b"ERR\tNOFP\t", b"ERR\tNORP\t")):
            rej[f[2].decode()] = f[1].decode()
    return fasta, lowq, olp, rej


def _traced_cli(argv, monkeypatch):
    """(rc, stdout, stderr, the job's counters, each dispatched batch's
    (Lb, O, O_full)) of one traced CLI job."""
    shapes = []
    dispatch = BatchAssembler._dispatch

    def spy(self, st):
        shapes.append((st["Lb"], st["O"], st["O_full"]))
        return dispatch(self, st)

    monkeypatch.setattr(BatchAssembler, "_dispatch", spy)
    tracing.disable()
    tracing.clear()
    tracing.enable()
    try:
        rc, out, log = run_cli(argv)
    finally:
        tracing.disable()
    (_, counts), = tracing.collected().jobs.items()
    launches = {(s.attrs["Lb"], s.attrs["O"])
                for s in tracing.collected().spans if s.name == "launch"}
    tracing.clear()
    return rc, out, log, counts, shapes, launches


@pytest.mark.parametrize("engine", ["host", "tpu"])
def test_its_cli_equals_reference(its, reference, engine, monkeypatch):
    """Every pair's FASTA record, LOWQ line, NOFP / NORP line and
    BESTOLP overlap are the reference's, and so are STAT OK / LOWQ /
    NOALGN / NOFP / NORP / SLOW; every batch is (512, 512) with O_full
    512, so none is rerouted; the traced counters agree with the log."""
    cfg, s = its
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", engine)
    monkeypatch.setenv("PANDASEQ_TPU_BATCH", str(BATCH))
    monkeypatch.delenv("PANDASEQ_TPU_PROFILE", raising=False)
    rc, out, log, counts, shapes, launches = _traced_cli(
        cfg["flags"] + ["-f", s.paths[0], "-r", s.paths[1]], monkeypatch)
    assert rc == 0
    fasta, lowq, olp, rej = printed(out, log)
    off = [(sid, code) for sid, code, fa, o, lq, _ in reference
           if (fasta.get(sid), lowq.get(sid), olp.get(sid),
               rej.get(sid)) != (fa, lq, o, code if code in ("NOFP", "NORP")
                                 else None)]
    assert off == [], off[:5]
    codes = [r[1] for r in reference]
    want = {"OK": codes.count("OK"), "LOWQ": codes.count("LOWQ"),
            "NOALGN": codes.count("NOALGN") + codes.count("NEGS"),
            "NOFP": codes.count("NOFP"), "NORP": codes.count("NORP"),
            "SLOW": sum(r[5] for r in reference), "READS": PAIRS}
    assert {k: stat(log, k) for k in want} == want
    assert len(fasta) == want["OK"] and len(lowq) == want["LOWQ"]
    # the deployment's work: read-through, rejects, SLOW rows, NOALGN
    longer = sum(o > cfg["read_len"] for o in olp.values())
    assert longer > 0.3 * PAIRS and want["LOWQ"] > 0.15 * PAIRS
    assert want["SLOW"] > 0 and want["NOALGN"] > 0

    assert len(shapes) == -(-PAIRS // BATCH)
    assert set(shapes) == {(512, 512, 512)}
    assert launches == ({(512, 512)} if engine == "tpu" else set())
    assert counts["overflow_reroutes"] == 0
    assert counts["slow_rows"] == want["SLOW"]
    assert counts["readthrough_pairs"] == longer
    assert counts["reject_rows"] == PAIRS - want["OK"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cand_join_at_512_equals_plain_on_its_pairs(its, dev):
    """cand_join at Lb = O = 512, num_kmers 2, on the read-through ITS
    pairs: list and mask equal the plain version's, and the mask equals
    the exact host twin's."""
    from pandaseq_tpu_torch.io import native
    from pandaseq_tpu_torch.ops import cand, fused2

    _, s = its
    reader = native.NativeBatchReader(s.paths[0], s.paths[1], batch=PAIRS,
                                      L=512)
    b = next(reader)
    reader.close()
    plane, hasN = native.pack4(b, 512)
    args = (torch.from_numpy(plane).to(dev),
            torch.from_numpy(np.ascontiguousarray(b.flen, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(b.rlen, np.int32)).to(dev),
            512, 512, 2)
    for mode in ("list", "mask"):
        got = cand.candidates_join(*args, mode, fused2.CAND_LIST_C)
        assert torch.equal(got, fused2.plain_candidates_join(
            *args, mode, fused2.CAND_LIST_C)), mode
    torch.cuda.synchronize()
    rows = np.flatnonzero(~hasN)
    assert len(rows) == PAIRS
    np.testing.assert_array_equal(got.cpu().numpy()[rows],
                                  native.cand_mask(b, rows, 2, 512))


@pytest.mark.cuda
def test_its_cli_on_card_equals_host_twin(its, dev, monkeypatch):
    """The CLI on the card (unpinned: ``INFO ENGINE cuda (default)``)
    prints the host twin's bytes; every launch is (512, 512), one a
    batch, and none is rerouted."""
    cfg, s = its
    argv = cfg["flags"] + ["-f", s.paths[0], "-r", s.paths[1]]
    for knob in ("PANDASEQ_TORCH_DEVICE", "PANDASEQ_TPU_ENGINE",
                 "PANDASEQ_TPU_HOST", "PANDASEQ_TPU_PROFILE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("PANDASEQ_TPU_BATCH", str(BATCH))
    rc, out, log, counts, shapes, launches = _traced_cli(argv, monkeypatch)
    assert rc == 0 and b"INFO\tENGINE\tcuda (default)\n" in log
    assert set(shapes) == {(512, 512, 512)} and launches == {(512, 512)}
    assert counts["device_steps"] == len(shapes) == -(-PAIRS // BATCH)
    assert counts["overflow_reroutes"] == 0
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    host = run_cli(argv)
    assert host[0] == 0 and out and out == host[1]

    def body(raw):
        return b"\n".join(line for line in stable_log(raw).split(b"\n")
                          if not line.startswith(b"INFO\tENGINE\t"))

    assert body(log) == body(host[2])
