"""The harness's inputs, names and arithmetic, on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from harness import generate, roofline, spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
IUPAC = {k: set(v.encode()) for k, v in generate.IUPAC.items()}


def _small(name, count=3, median=300):
    b = spec.bench()
    w = spec.workload(b, name)
    tr = dict(spec.traffic(w["traffic"]))
    tr["samples"] = {"count": count, "median_pairs": median, "sigma": 0.5}
    return spec.config(b, w["config"]), tr


def _records(path):
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return [lines[i:i + 4] for i in range(0, len(lines) - 1, 4)]


def test_generator_is_deterministic_for_a_seed(tmp_path):
    cfg, tr = _small("v3v4_2x300.samples")
    a = generate.make_pool(cfg, tr, 500, 2 ** 31 + 12345)
    b = generate.make_pool(cfg, tr, 500, 2 ** 31 + 12345)
    c = generate.make_pool(cfg, tr, 500, 2 ** 31 + 12346)
    for x, y in zip(a.seq + a.qual, b.seq + b.qual):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.seq[0], c.seq[0])
    assert np.array_equal(a.rlen, b.rlen)


def test_sample_sizes_are_the_log_normal_quantiles():
    sizes = generate.sample_sizes(
        {"count": 8, "median_pairs": 50000, "sigma": 0.6})
    assert sizes == sorted(sizes) and len(sizes) == 8
    assert sizes[0] == 19917 and sizes[-1] == 125524
    assert sum(sizes) == 464722
    # symmetric about the median in log space
    assert abs(np.log(sizes[3] * sizes[4] / 50000 ** 2)) < 1e-3


def test_record_slices_and_offsets(tmp_path):
    cfg, tr = _small("v4_2x250.small_samples")
    pool = generate.make_pool(cfg, tr, 400, 7)
    samples = generate.write_samples(pool, cfg, [400, 250, 120], tmp_path)
    for s in samples:
        start = int(round(s.index * pool.n / 3))
        idx = (start + np.arange(s.pairs)) % pool.n
        for which in (0, 1):
            recs = _records(s.paths[which])
            assert len(recs) == s.pairs
            with open(s.paths[which], "rb") as fh:
                data = fh.read()
            for j in (0, 1, s.pairs // 2, s.pairs - 1):
                head, seq, plus, qual = recs[j]
                assert data[s.offsets[which][j]:].startswith(head + b"\n")
                x = int(head.split(b":")[5])
                assert x == generate.X_BASE + idx[j]
                assert head.endswith(b" %d:N:0:ACGTAC" % (which + 1))
                assert seq == pool.seq[which][idx[j]].tobytes()
                assert qual == pool.qual[which][idx[j]].tobytes()
                assert plus == b"+"
        assert s.bucket == (256, 256)


def test_pool_reads_are_the_amplicon_ends():
    """The reverse read, reverse-complemented, is the amplicon's last
    read_len bases: with inserts of 252-255 and reads of 250 it agrees
    with the forward read at one shift of 2-5 bases, but for errors (a
    B-cliff's PHRED-2 tail errs on most of its bases)."""
    cfg, tr = _small("v4_2x250.small_samples")
    pool = generate.make_pool(cfg, tr, 200, 11)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    q = pool.qual[0].astype(int) - 33
    assert q.min() >= 2 and q.max() <= 40
    best = []
    for i in range(200):
        fwd = pool.seq[0][i].tobytes()
        rev = pool.seq[1][i].tobytes().translate(comp)[::-1]
        best.append(max(sum(a == b for a, b in zip(fwd[d:], rev))
                        / (250 - d) for d in range(2, 6)))
    assert min(best) > 0.6 and np.median(best) > 0.97


def test_primers_are_placed_resolved():
    cfg, tr = _small("v3v4_2x300.samples")
    pool = generate.make_pool(cfg, tr, 400, 5)
    for which, primer in ((0, cfg["forward_primer"]),
                          (1, cfg["reverse_primer"])):
        reads = pool.seq[which][:, :len(primer)]
        quals = pool.qual[which][:, :len(primer)].astype(int) - 33
        err = 10.0 ** (-quals / 10.0)
        # a base may carry a PHRED-rate substitution; elsewhere every base
        # is one the degenerate letter allows, and each letter's options
        # all occur
        ok = np.array([[b in IUPAC[ch] for b, ch in zip(row, primer)]
                       for row in reads])
        assert ok.mean() > 0.99
        assert (~ok).sum() <= 3 * err.sum() + 10
        for j, ch in enumerate(primer):
            if len(IUPAC[ch]) > 1:
                assert set(reads[:, j]) == IUPAC[ch]


def test_r2_cut_is_placed_right(tmp_path):
    cfg, tr = _small("v3v4_2x300.r2trim_samples")
    assert tr["r2_cut"] == [200, 250]
    pool = generate.make_pool(cfg, tr, 2000, 99)
    assert pool.rlen.min() == 200 and pool.rlen.max() == 250
    assert len(set(pool.rlen.tolist())) == 51
    samples = generate.write_samples(pool, cfg, [700, 500], tmp_path)
    for s in samples:
        start = int(round(s.index * pool.n / 2))
        idx = (start + np.arange(s.pairs)) % pool.n
        recs = _records(s.paths[1])
        lens = [len(r[1]) for r in recs]
        assert lens == pool.rlen[idx].tolist()
        assert all(len(r[3]) == len(r[1]) for r in recs)
        assert recs[3][1] == pool.seq[1][idx[3]][:lens[3]].tobytes()
        assert all(len(r[1]) == 300 for r in _records(s.paths[0]))
        assert s.bucket == (384, 256)


# sha256 of a pool of 400 pairs at seed 2**31 + 2026 (its bases,
# qualities and R2 lengths) and of three sample files cut from it (their
# bytes and record offsets), taken from the tree before read-through and
# the new flags came in: the existing cells' inputs stay byte for byte
POOL_SHA256 = {
    "v3v4_2x300.samples":
        "4bf5ada326ca74ad6976aba5df54fba1f415260c35209456c913a749cb419afd",
    "v3v4_2x300.r2trim_samples":
        "6b7e981c10c04444dc78214d81ffbf57f753631c18617db7be6b875b8db3eb95",
    "v4_2x250.small_samples":
        "d4972bd44180b81e4b4cd3a9bef4ba66b99d7ff0672c2c6014bc8421f3a4dc0a",
}


@pytest.mark.parametrize("name", sorted(POOL_SHA256))
def test_existing_pools_are_unchanged(name, tmp_path):
    import hashlib
    b = spec.bench()
    w = spec.workload(b, name)
    cfg = spec.config(b, w["config"])
    pool = generate.make_pool(cfg, spec.traffic(w["traffic"]), 400,
                              2 ** 31 + 2026)
    h = hashlib.sha256()
    for a in pool.seq + pool.qual + (pool.rlen,):
        h.update(a.tobytes())
    for s in generate.write_samples(pool, cfg, [400, 250, 120], tmp_path):
        for path in s.paths:
            with open(path, "rb") as fh:
                h.update(fh.read())
        for o in s.offsets:
            h.update(o.tobytes())
    assert h.hexdigest() == POOL_SHA256[name]


def _its():
    with open(os.path.join(HERE, "tests", "its1_2x300.json")) as fh:
        return json.load(fh)


def test_reads_run_through_into_the_adapter():
    """ITS amplicons of 200-600 bp on 300 bp reads: a read that passes the
    amplicon's end goes on into its adapter, right after the other
    primer's reverse complement; without adapter keys such amplicons are
    refused."""
    cfg = _its()
    pool = generate.make_pool(cfg, {"r2_cut": None}, 4000, 21)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for which, other in ((0, cfg["reverse_primer"]),
                         (1, cfg["forward_primer"])):
        adapter = cfg["adapter_r%d" % (which + 1)].encode()
        before = other.encode().translate(comp)[::-1]
        reads = [r.tobytes() for r in pool.seq[which]]
        hits = [r.find(adapter) for r in reads]
        at = [(r, h) for r, h in zip(reads, hits) if h >= len(before)]
        # amplicons under 300 bp: about a quarter, less the reads whose
        # adapter carries a substitution
        assert 0.15 < len(at) / len(reads) < 0.26
        same = [sum(x == y for x, y in zip(r[h - len(before):h], before))
                / len(before) for r, h in at]
        assert np.median(same) == 1.0 and np.mean(same) > 0.95
    assert pool.qual[0].min() >= 35 and pool.qual[0].max() <= 73
    no_adapter = {k: v for k, v in cfg.items() if not k.startswith("adapter")}
    with pytest.raises(ValueError, match="shorter than the reads"):
        generate.make_pool(no_adapter, {"r2_cut": None}, 10, 21)


def test_reference_reads_the_flags_as_the_cli():
    import math
    from reference.merge import parse_flags
    cfg = parse_flags(["-p", "CTTGGTCATTTAGAGGAAGTAA", "-q",
                       "GCTGCGTTCTTCATCGATGC", "-o", "30", "-O", "500",
                       "-t", "0.8", "-k", "3"])
    assert (cfg.minoverlap, cfg.maxoverlap, cfg.num_kmers) == (30, 500, 3)
    assert cfg.threshold == math.log(0.8)
    assert len(cfg.forward_primer) == 22 and len(cfg.reverse_primer) == 20
    # the setters' silent guards: -o 1 and -o 900 keep 2, -O 900 keeps 0
    assert parse_flags(["-o", "1"]).minoverlap == 2
    assert parse_flags(["-o", "900"]).minoverlap == 2
    assert parse_flags(["-O", "900"]).maxoverlap == 0
    for bad in (["-A", "pear"], ["-F"], ["-o", "0"], ["-O", "901"],
                ["-t", "1.5"], ["-k", "128"], ["-k", "x"],
                ["-O", "400", "-O", "500"]):
        with pytest.raises(ValueError):
            parse_flags(bad)


def test_every_name_loads():
    b = spec.bench()
    cells = [w["name"] for w in b["workloads"]]
    for c in b["configs"]:
        cfg = spec.config(b, c["name"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        tr = spec.traffic(w["traffic"])
        assert tr["config"] == w["config"] and w["chips"] == 1
        e2e = {m["name"] for m in spec.metrics_for(b, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(b, w["name"], True)
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]))
        for c in m.get("workloads", []):
            assert c in cells
    for m in b["per_layer"]:
        for c in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  spec.metrics_for(b, c, False)}


def _smoke_cand_bytes(chip_smoke, B, Lb):
    """The bytes that chip_smoke.py's phase 2 records in WORK for
    cand_join (the first element of the tuple it assigns in
    sparse_kernels), evaluated from its own source at B and Lb."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(chip_smoke.sparse_kernels))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and ast.unparse(node.targets[0]).startswith("WORK[")
                and "cand_join" in ast.unparse(node.targets[0])):
            expr = ast.Expression(node.value.elts[0])
            return eval(compile(expr, "chip_smoke", "eval"),
                        {"B": B, "Lb": Lb, "C": chip_smoke.C})
    raise AssertionError("chip_smoke.sparse_kernels records no cand_join")


@pytest.mark.parametrize("Lb", [256, 384])
def test_cand_roofline_matches_chip_smoke(Lb):
    """The least time of a batch equals chip_smoke.bound for cand_join,
    with the bytes read from chip_smoke's own code and a candidate list
    whose counts are not all zero: the benchmark counts only the k-mers
    (the candidates are not visible outside the program), which lowers
    the operations and leaves the bytes to set the bound."""
    import torch
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    B = chip_smoke.B
    rng = np.random.default_rng(Lb)
    fl = torch.from_numpy(rng.integers(0, Lb + 1, size=B).astype(np.int32))
    rl = torch.from_numpy(rng.integers(0, Lb + 1, size=B).astype(np.int32))
    lst = torch.zeros((B, chip_smoke.C + 2), dtype=torch.int16)
    lst[:, 0] = torch.from_numpy(rng.integers(0, 9, size=B).astype(np.int16))
    need = chip_smoke.join_needed_ops(fl, rl, Lb, Lb, lst)
    nbytes = _smoke_cand_bytes(chip_smoke, B, Lb)
    chip_smoke.WORK[("cand_join", Lb, Lb)] = (nbytes, need, 0)
    ms, which = chip_smoke.bound("cand_join", Lb, Lb)
    from harness.spans import emitted
    kmers = emitted(fl.numpy(), Lb) + emitted(rl.numpy(), Lb)
    assert kmers == need - int(lst[:, 0].sum()) and kmers < need
    assert roofline.cand_bytes(B, Lb) == nbytes
    assert roofline.cand_least_s(B, Lb, Lb, kmers) * 1e3 == \
        pytest.approx(ms, rel=1e-12)
    assert which == "bytes"
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert roofline.INT32_OPS_PER_S == chip_smoke.INT32_OPS_PER_S


def test_no_jax_check_compares_whole_top_level_names(monkeypatch):
    import run
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "pandaseq_tpu",
                 "pandaseq_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("jaxtyping", "pandaseq_tpu_torch", "pandaseq_tpu_torch.io",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.loaded_forbidden() == sorted(
        ["jax", "jax.numpy", "jaxlib", "flax.linen", "pandaseq_tpu",
         "pandaseq_tpu.ops"])


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path[:0] = %r; import run, control; "
            "from harness import cell, check, generate, jobs, spans, trace;"
            " import reference.merge; from pandaseq_tpu_torch.cli import "
            "main; print(run.loaded_forbidden())" % [HERE, ROOT])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"
    ref = ("import sys; sys.path[:0] = %r; import reference.merge; "
           "print(sorted(m for m in sys.modules if m.split('.')[0] in "
           "('torch', 'pandaseq_tpu', 'pandaseq_tpu_torch', 'jax')))"
           % [HERE])
    out = subprocess.run([sys.executable, "-c", ref], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"


def test_run_refuses_without_a_card_or_with_a_knob_set(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PANDASEQ_TPU_ENGINE", None)
    args = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
            "v4_2x250.small_samples", "--seed", "1", "--seconds", "1"]
    for extra in ({}, {"PANDASEQ_TPU_ENGINE": "host"}):
        p = subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                           env=dict(env, **extra))
        assert p.returncode != 0 and p.stdout.strip() == ""
    # a directory that holds only BENCHMARK.json and the benchmark
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", *args[3:]],
                       capture_output=True, text=True, cwd=tmp_path,
                       env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_config_a_cell_and_a_metric_come_as_new_files(tmp_path,
                                                        cpu_port):
    """A later PR adds a configuration, a traffic mix, a cell and a
    per-layer metric: new files and new entries in BENCHMARK.json, no
    edit of a file that is there. The copy runs the new cell."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: open(os.path.join(HERE, p), "rb").read()
              for p in _files(HERE)}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    cfg = spec.config(b, "v4_2x250")
    cfg.update(name="v4_2x250_long", amplicon=[300, 320])
    (tmp_path / "benchmark" / "configs" / "v4_2x250_long.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "tiny_run.json").write_text(
        json.dumps({"config": "v4_2x250_long", "check_pairs": 200,
                    "samples": {"count": 2, "median_pairs": 300,
                                "sigma": 0.5}, "r2_cut": None,
                    "why": "a test's cell"}))
    (tmp_path / "benchmark" / "metrics" / "jobs_per_s.py").write_text(
        "def read(run):\n    return len(run.jobs) / run.window_s\n")
    b["configs"].append({"name": "v4_2x250_long", "source": "a test",
                         "file": "benchmark/configs/v4_2x250_long.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "v4_2x250_long.tiny",
                           "config": "v4_2x250_long", "traffic": "tiny_run",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "jobs_per_s", "unit": "jobs/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "cli", "moves": "pairs_per_s",
                           "workloads": ["v4_2x250_long.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import sys, json, time; sys.path[:0] = [%r, %r]; "
            "from harness import cell; "
            "r, c = cell.run('v4_2x250_long.tiny', 5, 1.0, True, "
            "time.perf_counter(), engine=%r, workers=2); "
            "print(json.dumps(r))"
            % (str(tmp_path / "benchmark"), ROOT, cpu_port))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["jobs_per_s"]["value"] > 0
    assert {p: open(os.path.join(HERE, p), "rb").read()
            for p in _files(HERE)} == before


LONGEST_OVERLAP = '''
def read(run):
    """The longest BESTOLP overlap of a merged pair, over the jobs that
    kept their whole output."""
    best = None
    for job in run.jobs:
        if not job.out.keep:
            continue
        heads = job.out.data().split(b"\\n")[0::2]
        merged = {h[1:h.rfind(b";")] for h in heads if h}
        for line in job.log.data().split(b"\\n"):
            if line.startswith(b"INFO\\tBESTOLP\\t"):
                _, _, sid, olp = line.split(b"\\t")
                if sid in merged:
                    best = max(-1 if best is None else best, int(olp))
    return best
'''


def test_an_its_deployment_comes_as_new_files(tmp_path, cpu_port):
    """The ITS1 2x300 deployment (amplicons of 200-600 bp, so reads that
    run through into the adapter, -O 500 and NOALGN), a traffic mix, a
    cell and a metric added as new files to a copy: the new cell runs
    correct on the CPU and merges pairs whose overlap is longer than a
    read."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: open(os.path.join(HERE, p), "rb").read()
              for p in _files(HERE)}
    bench = tmp_path / "benchmark"
    shutil.copy(os.path.join(HERE, "tests", "its1_2x300.json"),
                bench / "configs" / "its1_2x300.json")
    (bench / "traffic" / "its1_tiny.json").write_text(json.dumps(
        {"config": "its1_2x300", "check_pairs": 1000,
         "samples": {"count": 2, "median_pairs": 300, "sigma": 0.5},
         "r2_cut": None, "why": "a test's cell"}))
    (bench / "metrics" / "longest_merged_overlap.py").write_text(
        LONGEST_OVERLAP)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    b["configs"].append({"name": "its1_2x300", "source": "a test",
                         "file": "benchmark/configs/its1_2x300.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "its1_2x300.tiny", "config": "its1_2x300",
                           "traffic": "its1_tiny", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "longest_merged_overlap", "unit": "bp",
                           "better": "higher", "source": "program_counter",
                           "layer": "cli", "moves": "pairs_per_s",
                           "workloads": ["its1_2x300.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import sys, json, time; sys.path[:0] = [%r, %r]; "
            "from harness import cell; "
            "r, c = cell.run('its1_2x300.tiny', 2 ** 31 + 500, 1.0, True, "
            "time.perf_counter(), engine=%r, workers=2); "
            "print(json.dumps(r))" % (str(bench), ROOT, cpu_port))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["pairs_off_reference"]["value"] == 0
    assert r["checks"]["pairs_checked"]["value"] > 400
    assert r["metrics"]["longest_merged_overlap"]["value"] > 300
    assert {p: open(os.path.join(HERE, p), "rb").read()
            for p in _files(HERE)} == before


def _files(top):
    out = []
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        out += [os.path.relpath(os.path.join(d, f), top) for f in files
                if not f.endswith(".pyc")]
    return sorted(out)
