"""The PyTorch port's library entry point (pandaseq_tpu_torch.Assembler,
api.py) against the JAX package's (pandaseq_tpu.Assembler) on the CPU:
the same seeded inputs through both, with JAX on the CPU and the port on
PANDASEQ_TORCH_DEVICE=cpu (the plain versions of the kernels). The
tolerance is zero: FASTA bytes, counters, sids and every result field
must be equal. Also the port's registry of custom algorithms, idset,
io/url and io/prefetch against the JAX package's copies."""

import bz2
import gzip
import http.server
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import pandaseq_tpu as jpt
import pandaseq_tpu_torch as tpt
from pandaseq_tpu import algorithms as jax_algorithms
from pandaseq_tpu import oracle as jax_oracle
from pandaseq_tpu.idset import IdSet as JaxIdSet
from pandaseq_tpu.io import fastq as jax_fq
from pandaseq_tpu.io import native as jax_native
from pandaseq_tpu.io import output as jax_output
from pandaseq_tpu.io.prefetch import prefetch as jax_prefetch
from pandaseq_tpu.io.url import open_url as jax_open_url
from pandaseq_tpu_torch import algorithms, api, oracle
from pandaseq_tpu_torch.idset import IdSet
from pandaseq_tpu_torch.io import fastq as fq
from pandaseq_tpu_torch.io import native
from pandaseq_tpu_torch.io import output
from pandaseq_tpu_torch.io.prefetch import prefetch
from pandaseq_tpu_torch.io.url import open_url
from pandaseq_tpu_torch.ops import cand

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGORITHMS = ["simple_bayesian", "uparse", "pear", "rdp_mle", "ea_util",
              "flash", "stitch"]
# the primers of tests/test_oracle_primers.py
FWD_PRIMER = "GTGCCAGCMGCCGCGGTAA"
REV_PRIMER = "GGACTACHVGGGTWTCTAAT"
BATCH = 256  # the streams' batch: 1100 pairs are 5 batches
FIELDS = ("sequence_length", "quality", "overlap", "overlaps_examined",
          "overlap_mismatches", "degenerates",
          "estimated_overlap_probability", "slow", "forward_offset",
          "reverse_offset", "forward_length", "reverse_length")
NO_LAUNCH = dict.fromkeys(cand.KERNELS, 0)


def _make_data(prefix, *args):
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tests", "golden", "make_data.py"),
                    "--out-prefix", prefix, *args],
                   check=True, stdout=subprocess.DEVNULL)
    return prefix + "_1.fastq", prefix + "_2.fastq"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seeded streams: 2x250 with N runs and B-cliffs, the same with the
    16S V4 primers, and 2x100 reads (another shape bucket)."""
    d = tmp_path_factory.mktemp("api")
    return {
        "n": _make_data(str(d / "n"), "--pairs", "1100", "--seed", "12",
                        "--n-run-rate", "0.1"),
        "primed": _make_data(str(d / "p"), "--pairs", "300", "--seed", "5",
                             "--fwd-primer", FWD_PRIMER,
                             "--rev-primer", REV_PRIMER),
        "short": _make_data(str(d / "s"), "--pairs", "300", "--seed", "3",
                            "--read-len", "100", "--amp-min", "130",
                            "--amp-max", "190"),
    }


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    for name in ("PANDASEQ_TPU_ENGINE", "PANDASEQ_TPU_GROUP",
                 "PANDASEQ_TPU_JOIN"):
        monkeypatch.delenv(name, raising=False)


def fields(res):
    """Every field of a result (NativeResult or OracleResult), the sid
    as its string, the sequence as bytes and the per-base
    log-probabilities bit for bit; None stays None."""
    if res is None:
        return None
    out = {f: getattr(res, f) for f in FIELDS}
    out["sid"] = str(res.sid)
    n = res.sequence_length
    if res.sequence_ascii is not None or res.sequence_nt is not None:
        out["sequence"] = output._seq_bytes(res)
        out["p"] = np.asarray(res.sequence_p[:n], np.float64).tobytes()
    return out


def _counters(asm):
    return (asm.count, asm.ok_count, asm.low_quality_count,
            asm.bad_read_count, asm.failed_alignment_count,
            asm.no_forward_primer_count, asm.no_reverse_primer_count,
            asm.slow_count, asm.overlap_count, asm.longest_overlap)


def _stream(asm, files, fmt):
    """(FASTA or FASTQ bytes of the OK results, fail-callback sids,
    counters, module rejects) of one ``stream`` run."""
    failed = []
    asm.set_fail_alignment(lambda pair: failed.append(str(pair.sid)))
    out = b"".join(fmt(res) for res in asm.stream(*files))
    return (out, failed, _counters(asm),
            [(m.name, m.rejected) for m in asm.modules])


def _both(configure, files, fmt="fasta"):
    """One stream run through each package's Assembler, configured by
    ``configure(asm, package)``; returns (port's, JAX's, port's
    Assembler)."""
    got_asm = tpt.Assembler(batch=BATCH)
    configure(got_asm, tpt)
    want_asm = jpt.Assembler(batch=BATCH)
    configure(want_asm, jpt)
    got = _stream(got_asm, files, getattr(output, "format_" + fmt))
    want = _stream(want_asm, files, getattr(jax_output, "format_" + fmt))
    return got, want, got_asm


@pytest.mark.parametrize("k", [2, 0])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_stream_equals_jax(data, algo, k):
    """Every built-in algorithm at num_kmers 2 (the candidate search)
    and 0 (the dense shortlist, or the LUT algorithms' sparse step),
    through the default group of 4 stacked batches."""
    def configure(asm, pkg):
        asm.algorithm = algo
        asm.num_kmers = k

    cand.reset_launch_counts()
    got, want, asm = _both(configure, data["n"])
    assert want[0] and got == want
    assert asm.device is None and asm._engine.device.type == "cpu"
    assert asm._engine.engine == "cpu"
    # 5 batches of one shape bucket, in groups of 4: two device steps,
    # each through the plain versions (no kernel launched on the CPU)
    assert asm._engine._device_dispatches == 2
    assert cand.launch_counts() == NO_LAUNCH


@pytest.mark.parametrize("group", ["1", "4"])
def test_stream_group_and_fastq_equal_jax(data, monkeypatch, group):
    """PANDASEQ_TPU_GROUP 1 (one device step per batch) and 4, FASTQ
    output (the per-base PHRED from sequence_p)."""
    monkeypatch.setenv("PANDASEQ_TPU_GROUP", group)
    got, want, asm = _both(lambda a, p: None, data["n"], "fastq")
    assert want[0] and got == want
    assert asm._engine._device_dispatches == (5 if group == "1" else 2)


def test_stream_fasta_equals_cli(data, tmp_path):
    """The stream's FASTA is the CLI's output for the same reads."""
    from pandaseq_tpu_torch.cli.main import main

    out = tmp_path / "cli.fa"
    rc = main(["-T", "1", "-f", data["n"][0], "-r", data["n"][1],
               "-w", str(out), "-g", str(tmp_path / "cli.log")])
    assert rc == 0
    asm = tpt.Assembler()
    got = b"".join(output.format_fasta(r) for r in asm.stream(*data["n"]))
    assert got and got == out.read_bytes()


def _revcomp(s):
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


AMP = ("ACGTACGTACGTTACGGACCTAGGACTTACGATCGGACTACGGTACCGTA"
       "GGATCCTAGCATCGATCGGATCCGATTACAGCATCGATCAGGATCCAGCT")
SINGLE = {
    "plain": (AMP[:70], _revcomp(AMP)[:70]),
    "quals": ((AMP[:70], "I" * 60 + "#" * 10),
              (_revcomp(AMP)[:70], "".join(chr(33 + 2 + i % 39)
                                           for i in range(70)))),
    "n_bases": (AMP[:30] + "NNN" + AMP[33:70],
                _revcomp(AMP)[:20] + "N" + _revcomp(AMP)[21:70]),
    "no_overlap": (AMP[:40], _revcomp(AMP)[:40]),
}


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_assemble_single_pair_equals_jax(case):
    fwd, rev = SINGLE[case]
    cand.reset_launch_counts()
    got, code = tpt.Assembler().assemble("p_" + case, fwd, rev)
    want, want_code = jpt.Assembler().assemble("p_" + case, fwd, rev)
    assert code == want_code
    assert (code == "OK") == (case != "no_overlap")
    assert fields(got) == fields(want)
    if got is not None:
        assert got.sequence == want.sequence
        assert case != "plain" or got.sequence == AMP
    # the single-pair path is the oracle's: no device step
    assert cand.launch_counts() == NO_LAUNCH


@pytest.mark.parametrize("kind,n", [("pairs", 1), ("pairs", 7),
                                    ("pairs", 1024), ("batch", 1100)])
def test_assemble_batch_equals_jax(data, kind, n):
    """A list of ReadPair (through make_batch) and a decoded Batch: one
    device step each, every result field equal."""
    if kind == "pairs":
        got_in = [p for p, _ in zip(fq.read_pairs(*data["n"]), range(n))]
        want_in = [p for p, _ in zip(jax_fq.read_pairs(*data["n"]),
                                     range(n))]
    else:
        got_in = next(iter(native.NativeBatchReader(*data["n"], batch=2048)))
        want_in = next(iter(jax_native.NativeBatchReader(*data["n"],
                                                         batch=2048)))
    asm = tpt.Assembler()
    got = asm.assemble_batch(got_in)
    want = jpt.Assembler().assemble_batch(want_in)
    assert len(got) == len(want) == n
    assert [c for c, _ in got] == [c for c, _ in want]
    assert [fields(r) for _, r in got] == [fields(r) for _, r in want]
    assert any(c == "OK" for c, _ in got)
    assert asm._engine._device_dispatches == 1


def _setters(asm, pkg):
    asm.algorithm = "pear"
    asm.threshold = 0.7
    asm.minimum_overlap = 1  # ignored: outside (1, 900)
    asm.minimum_overlap = 10
    asm.maximum_overlap = 900  # ignored: outside [0, 900)
    asm.maximum_overlap = 400
    asm.num_kmers = 3
    asm.primer_penalty = 0.5
    asm.set_forward_trim(2)
    asm.set_reverse_trim(3)


def _primers(after):
    def configure(asm, pkg):
        asm.set_forward_primer(FWD_PRIMER)
        asm.set_reverse_primer(REV_PRIMER)
        asm.primers_after = after
    return configure


SETUPS = {"setters": (_setters, "n"),
          "primers_before": (_primers(False), "primed"),
          "primers_after": (_primers(True), "primed")}


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_copy_configuration_and_module_stream_equal_jax(data, setup):
    """The setters (their guards included), copy_configuration into a
    fresh Assembler, then add_module("min_phred:5") and stream: the
    copied configuration, the counters and the module's rejects equal
    the JAX package's. primers_after takes the eager result path with
    the batched post-assembly primer scan."""
    configure, stream = SETUPS[setup]

    def copied(asm, pkg):
        src = pkg.Assembler()
        configure(src, pkg)
        asm.copy_configuration(src)
        assert asm.algorithm is src.algorithm
        assert asm.count == 0  # counters are not copied
        asm.add_module("min_phred:5")

    got, want, asm = _both(copied, data[stream])
    assert want[0] and got == want
    jasm = jpt.Assembler()
    copied(jasm, jpt)
    for name in oracle.OracleConfig.__dataclass_fields__:
        a, b = getattr(asm.cfg, name), getattr(jasm.cfg, name)
        if name == "algorithm":
            assert a.name == b.name
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, name
    assert asm.modules[0].name == "min_phred"


# a user filter module file without check_batch, for each package's own
# Module class; {api} and {body} vary it for load_module's refusals
MODULE_FILE = '''from {pkg}.filters import Module

api = {api}


def opener(args, logger):
    {body}
'''
KEEP_SHORT = ("limit = int(args) if args else 400\n    return Module("
              "\"only_short\", check=lambda res: res.sequence_length <= "
              "limit, args=args)")
MODULE_CASES = {"ok": ("3", KEEP_SHORT), "old_api": ("2", KEEP_SHORT),
                "not_a_module": ("3", "return object()"),
                "raises": ("3", "raise ValueError('bad args')"),
                "missing": None}


def _module_file(tmp_path, pkg, case, other=None):
    """The module file of ``case`` for package ``pkg``, whose Module
    class is ``other``'s where given; returns its path."""
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    path = d / (case + ".py")
    if MODULE_CASES[case] is not None:
        api, body = MODULE_CASES[case]
        path.write_text(MODULE_FILE.format(pkg=other or pkg, api=api,
                                           body=body))
    return str(path)


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_load_module_file_equals_jax(tmp_path, case):
    """filters.load_module of a user file: the same module or the same
    refusal and log line in both packages (the file's path masked)."""
    import io

    from pandaseq_tpu import filters as jax_filters
    from pandaseq_tpu import stats as jax_stats
    from pandaseq_tpu_torch import filters, stats

    out = {}
    for pkg, filt, st in (("pandaseq_tpu_torch", filters, stats),
                          ("pandaseq_tpu", jax_filters, jax_stats)):
        path = _module_file(tmp_path, pkg, case)
        log = io.BytesIO()
        try:
            mod = filt.load_module(path + ":300", st.LogProxy(log))
            got = (mod.name, mod.args, isinstance(mod, filt.Module))
        except filt.ModuleError:
            got = "refused"
        except ValueError as e:  # the opener's own error propagates
            got = ("raised", str(e))
        out[pkg] = (got, log.getvalue().replace(
            os.path.dirname(path).encode(), b"<dir>"))
    assert out["pandaseq_tpu_torch"] == out["pandaseq_tpu"]
    assert (out["pandaseq_tpu"][0] == ("only_short", "300", True)) == \
        (case == "ok")


def test_load_module_file_refuses_the_jax_module_class(tmp_path):
    """A file whose opener returns the JAX package's Module is refused
    by the port: the port reaches for no class of pandaseq_tpu."""
    import io

    from pandaseq_tpu_torch import filters, stats

    log = io.BytesIO()
    path = _module_file(tmp_path, "pandaseq_tpu_torch", "ok",
                        other="pandaseq_tpu")
    with pytest.raises(filters.ModuleError):
        filters.load_module(path, stats.LogProxy(log))
    assert b"Unable to open module" in log.getvalue()


def test_add_module_file_stream_equals_jax(data, tmp_path):
    """add_module of a user module file without check_batch (the eager
    result path of the library), each package with its own file."""
    def configure(asm, pkg):
        asm.add_module(_module_file(tmp_path, pkg.__name__, "ok") + ":420")

    got, want, asm = _both(configure, data["n"])
    assert want[0] and got == want
    assert asm.modules[0].check_batch is None
    assert got[3] == [("only_short", got[3][0][1])] and got[3][0][1] > 0


def _renamed(base):
    """The custom algorithm of both packages, from one class body: the
    simple Bayesian model under another name."""
    class RenamedSimpleBayes(base):
        name = "renamed_sb"
    return RenamedSimpleBayes


@pytest.mark.parametrize("k", [2, 0])
def test_custom_algorithm_stream_equals_jax(data, k):
    """register_algorithm in both packages, make_algorithm by name: the
    dense device step at any num_kmers, every pair replayed through the
    oracle."""
    algorithms.register_algorithm("renamed_sb",
                                  _renamed(oracle.SimpleBayes))
    jax_algorithms.register_algorithm("renamed_sb",
                                      _renamed(jax_oracle.SimpleBayes))
    try:
        assert "renamed_sb" in algorithms.list_algorithms()
        assert algorithms.list_algorithms() == \
            jax_algorithms.list_algorithms()

        def configure(asm, pkg):
            reg = algorithms if pkg is tpt else jax_algorithms
            asm.algorithm = reg.make_algorithm("renamed_sb")
            asm.num_kmers = k

        got, want, asm = _both(configure, data["n"])
    finally:
        algorithms._CUSTOM.pop("renamed_sb", None)
        jax_algorithms._CUSTOM.pop("renamed_sb", None)
    assert want[0] and got == want
    assert asm._engine._custom and asm.algorithm == "renamed_sb"
    assert asm._engine._device_dispatches == 2


def test_missing_native_library_raises(data, monkeypatch):
    """Without the native host library the API raises the engine's
    error naming the reason (no Python reader behind it)."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(native, "build_error", "g++ exited 1")
    with pytest.raises(RuntimeError, match="native host library did not "
                       "build: g\\+\\+ exited 1"):
        next(tpt.Assembler().stream(*data["n"]))
    with pytest.raises(RuntimeError, match="g\\+\\+ exited 1"):
        tpt.Assembler().assemble_batch(
            [next(iter(fq.read_pairs(*data["n"])))])


def test_stream_missing_file_raises(data, tmp_path):
    with pytest.raises(OSError, match="cannot open"):
        next(tpt.Assembler().stream(str(tmp_path / "none_1.fastq"),
                                    data["n"][1]))


@pytest.mark.parametrize("threaded", [False, True])
def test_assemble_stream_mixed_buckets_equal_jax(data, threaded):
    """Batches of two shape buckets (2x250 and 2x100) in turns at group
    4: each bucket change flushes the pending group, so the stream makes
    one device step per run of same-bucket batches; a group handed to
    _dispatch_group with mixed buckets falls back to one step a batch."""
    def batches(pkg_native, order):
        readers = {k: iter(pkg_native.NativeBatchReader(
            *data[k], batch=BATCH)) for k in ("n", "short")}
        return [next(readers[k]) for k in order]

    order = ("n", "n", "short", "n")
    got_asm = tpt.Assembler()._ensure_engine()
    want_asm = jpt.Assembler()._ensure_engine()
    got = list(got_asm.assemble_stream(batches(native, order), group=4,
                                       threaded=threaded))
    want = list(want_asm.assemble_stream(batches(jax_native, order),
                                         group=4))
    assert [[(c, fields(r)) for c, r in res] for _, res in got] == \
        [[(c, fields(r)) for c, r in res] for _, res in want]
    assert got_asm._device_dispatches == 3  # (n, n), (short), (n)

    sts = [got_asm._pre(b) for b in batches(native, ("n", "short"))]
    assert (sts[0]["Lb"], sts[0]["O"]) != (sts[1]["Lb"], sts[1]["O"])
    jsts = [want_asm._pre(b) for b in batches(jax_native, ("n", "short"))]
    before = got_asm._device_dispatches
    devs = got_asm._dispatch_group(sts)
    assert got_asm._device_dispatches == before + 2
    got = [got_asm._finalize(st, d) for st, d in zip(sts, devs)]
    want = [want_asm._finalize(st, d)
            for st, d in zip(jsts, want_asm._dispatch_group(jsts))]
    assert [[(c, fields(r)) for c, r in res] for res in got] == \
        [[(c, fields(r)) for c, r in res] for res in want]


HEADERS = ["M00000:7:000000000-TEST1:1:1101:10000:2000 1:N:0:ACGTAC",
           "@M01271:10:000000000-A3WGH:1:1101:18786:6175 2:N:0:1",
           "M01271:10:000000000-A3WGH:1:1101:18786:6175",
           "HWI-ST1234:8:1101:1234:2000#ACGTAC/1",
           "garbage###", ""]


@pytest.mark.parametrize("policy", ["PRESENT", "OPTIONAL", "ABSENT"])
def test_idset_equals_jax(policy):
    got, want = IdSet(), JaxIdSet()
    from pandaseq_tpu import seqid as jax_seqid
    from pandaseq_tpu_torch import seqid
    for h in HEADERS:
        assert got.add_str(h, policy) == want.add_str(h, policy), h
    assert len(got) == len(want)
    for h in HEADERS:
        s = h[1:] if h.startswith("@") else h
        d, sid, _ = seqid.parse(s, policy)
        jd, jsid, _ = jax_seqid.parse(s, policy)
        assert d == jd and str(sid) == str(jsid)
        assert (sid in got) == (jsid in want)
        got.add(sid)
        want.add(jsid)
    assert len(got) == len(want) and got._set == want._set


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A local http.server over plain, gzip and bz2 FASTQ payloads."""
    d = tmp_path_factory.mktemp("url")
    body = open(os.path.join(ROOT, "tests", "data", "synth_1.fastq"),
                "rb").read()
    body2 = open(os.path.join(ROOT, "tests", "data", "synth_2.fastq"),
                 "rb").read()
    (d / "p.fastq").write_bytes(body)
    (d / "g.fastq.gz").write_bytes(gzip.compress(body))
    (d / "b.fastq.bz2").write_bytes(bz2.compress(body2))

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(d), **kw)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield (d, "http://127.0.0.1:%d" % srv.server_address[1],
               {"p.fastq": body, "g.fastq.gz": body, "b.fastq.bz2": body2})
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


@pytest.mark.parametrize("scheme", ["path", "file", "http"])
@pytest.mark.parametrize("name", ["p.fastq", "g.fastq.gz", "b.fastq.bz2"])
def test_open_url_equals_jax(served, scheme, name):
    d, base, bodies = served
    url = {"path": str(d / name), "file": "file://" + str(d / name),
           "http": base + "/" + name}[scheme]
    with open_url(url) as fh, jax_open_url(url) as jfh:
        got, want = fh.read(), jfh.read()
    assert got == want == bodies[name]


def test_fastq_reader_over_http_equals_jax(served):
    _, base, _ = served

    def sids(pkg_fq, opener):
        reader = pkg_fq.PairedFastqReader(
            opener(base + "/g.fastq.gz"), opener(base + "/b.fastq.bz2"),
            policy="PRESENT")
        out = []
        try:
            while len(out) < 32:
                out.append(str(next(reader).sid))
        except (StopIteration, pkg_fq.StreamError):
            pass
        return out

    got = sids(fq, open_url)
    assert len(got) == 32 and got == sids(jax_fq, jax_open_url)


@pytest.mark.parametrize("depth", [1, 3, 8])
def test_prefetch_order_and_errors_equal_jax(depth):
    assert list(prefetch(range(100), depth=depth)) == \
        list(jax_prefetch(range(100), depth=depth)) == list(range(100))

    def boom():
        yield 1
        raise ValueError("x")

    for pf in (prefetch, jax_prefetch):
        it = pf(boom(), depth=depth)
        assert next(it) == 1
        with pytest.raises(ValueError, match="x"):
            next(it)


def test_prefetch_close_releases_source():
    """An abandoned prefetch closes its source generator (the reader's
    file handles) in both packages."""
    for pf in (prefetch, jax_prefetch):
        closed = threading.Event()

        def source():
            try:
                for i in range(1000):
                    yield i
            finally:
                closed.set()

        it = pf(source(), depth=2)
        assert [next(it), next(it)] == [0, 1]
        it.close()
        assert closed.wait(timeout=10)


def test_package_exports_equal_jax():
    """pandaseq_tpu_torch's lazy exports: the names and what they bind,
    as in pandaseq_tpu."""
    from pandaseq_tpu_torch import idset

    assert tpt.Assembler is api.Assembler
    assert tpt.make_algorithm is oracle.make_algorithm
    assert tpt.OracleConfig is oracle.OracleConfig
    assert tpt.IdSet is idset.IdSet
    for name in ("Assembler", "make_algorithm", "OracleConfig", "IdSet"):
        assert getattr(tpt, name).__name__ == getattr(jpt, name).__name__
    with pytest.raises(AttributeError):
        tpt.NoSuchName
    algo = tpt.make_algorithm("pear", None)
    jalgo = jpt.make_algorithm("pear", None)
    assert type(algo).__name__ == type(jalgo).__name__
    assert vars(algo) == vars(jalgo)
