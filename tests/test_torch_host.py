"""The PyTorch port's own copies of the JAX package's host modules
(pandaseq_tpu_torch/tables.py, nt.py, seqid.py, assembler.make_batch,
io/fastq.py, io/native.py, oracle.py, filters.py) held to the originals
by value: the same inputs into both packages, equal values out. Each
package gets its own objects; nothing compares types across them.
Floats are compared bit for bit: the copies run the same numpy code."""

import dataclasses
import os

import numpy as np
import pytest

import pandaseq_tpu.assembler as jax_assembler
from pandaseq_tpu import filters as jax_filters
from pandaseq_tpu import nt as jax_nt
from pandaseq_tpu import oracle as jax_oracle
from pandaseq_tpu import seqid as jax_seqid
from pandaseq_tpu import stats as jax_stats
from pandaseq_tpu import tables as jax_tables
from pandaseq_tpu.io import fastq as jax_fq
from pandaseq_tpu.io import native as jax_native
from pandaseq_tpu_torch import assembler, filters, nt, oracle, seqid, stats
from pandaseq_tpu_torch import tables
from pandaseq_tpu_torch.io import fastq as fq
from pandaseq_tpu_torch.io import native
from tests.test_seqid import REFERENCE_CASES

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SYNTH = os.path.join(DATA, "synth")
ALGORITHMS = ["simple_bayesian", "uparse", "pear", "rdp_mle", "ea_util",
              "flash", "stitch"]

TABLE_NAMES = sorted(n for n in vars(jax_tables) if n.isupper())
NT_ARRAYS = ["NT_TO_ASCII", "COMPLEMENT", "IUPAC_FORWARD", "IUPAC_REVERSE"]


def _same(got, want):
    """Equal values, dtype and shape; floats bit for bit."""
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        got = got.view(np.uint8)
        want = want.view(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_table_names_copied():
    assert TABLE_NAMES == sorted(n for n in vars(tables) if n.isupper())
    assert len(TABLE_NAMES) >= 12


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_tables_equal(name):
    _same(getattr(tables, name), getattr(jax_tables, name))


@pytest.mark.parametrize("name", NT_ARRAYS)
def test_nt_arrays_equal(name):
    _same(getattr(nt, name), getattr(jax_nt, name))


@pytest.mark.parametrize("fn", ["nt_from_ascii", "nt_from_ascii_complement",
                                "nt_to_ascii", "is_degenerate", "is_n",
                                "result_phred"])
def test_nt_functions_equal(fn):
    """Every byte value, every code, and the probabilities of
    tests/test_nt.py (table values, midpoints, out of range, random)."""
    rng = np.random.default_rng(0)
    if fn == "result_phred":
        qs = jax_tables.QUAL_SCORE
        args = np.array(list(qs) + [(qs[i] + qs[i + 1]) / 2
                                    for i in range(46)]
                        + [-3.0, -2.0000001, 0.0, 1.0]
                        + list(rng.uniform(-2.5, 0.1, size=500)))
    elif fn in ("nt_to_ascii", "is_degenerate", "is_n"):
        args = np.arange(16, dtype=np.int8)
    else:
        args = np.arange(256, dtype=np.uint8)
    _same(getattr(nt, fn)(args), getattr(jax_nt, fn)(args))


_SEQID_CASES = [c[0] for c in REFERENCE_CASES] + [
    "SRR1234.5678 somejunk", "1468:1:1:12675:1118/1",
    "1468:1:1:12675:1118#AC/1", "", "a:b:c"]


@pytest.mark.parametrize("policy", ["TAG_ABSENT", "TAG_OPTIONAL",
                                    "TAG_PRESENT"])
@pytest.mark.parametrize("text", _SEQID_CASES)
def test_seqid_parse_equal(text, policy):
    """seqid.parse on the cases of tests/test_seqid.py under every tag
    policy: direction, format and the parsed id's fields."""
    d, sid, fmt = seqid.parse(text, getattr(seqid, policy))
    jd, jsid, jfmt = jax_seqid.parse(text, getattr(jax_seqid, policy))
    assert (d, fmt) == (jd, jfmt)
    assert (sid is None) == (jsid is None)
    if sid is not None:
        assert dataclasses.astuple(sid) == dataclasses.astuple(jsid)
        assert str(sid) == str(jsid)


def _pairs(reader_mod, n=None):
    pairs = list(reader_mod.read_pairs(SYNTH + "_1.fastq",
                                       SYNTH + "_2.fastq"))
    return pairs if n is None else pairs[:n]


_PAIR_FIELDS = ("flen", "rlen", "fwd_nt", "fwd_q", "rev_nt", "rev_q")


def test_fastq_pairs_equal():
    got, want = _pairs(fq), _pairs(jax_fq)
    assert len(got) == len(want) == 200
    for g, w in zip(got, want):
        assert str(g.sid) == str(w.sid)
        for f in _PAIR_FIELDS:
            _same(getattr(g, f), getattr(w, f))


_BATCH_ARRAYS = ("fwd_nt", "fwd_q", "rev_nt", "rev_q", "flen", "rlen")


@pytest.mark.parametrize("L", [256, 512])
def test_make_batch_equal(L):
    """make_batch from each package's pairs, the nibble plane, the raw
    copies and the packed upload plane (psq_pack4) of the batch."""
    got = assembler.make_batch(_pairs(fq), L)
    want = jax_assembler.make_batch(_pairs(jax_fq), L)
    for f in _BATCH_ARRAYS:
        _same(getattr(got, f), getattr(want, f))
    _same(got.nt_packed(), want.nt_packed())
    for g, w in zip(got.raw(), want.raw()):
        _same(g, w)
    for g, w in zip(native.pack4(got, L), jax_native.pack4(want, L)):
        _same(g, w)


def test_native_reader_batches_equal():
    """The port's native decoder (its own build of native/psq_io.cpp)
    against the JAX package's, batch by batch."""
    got = list(native.NativeBatchReader(SYNTH + "_1.fastq",
                                        SYNTH + "_2.fastq", batch=64,
                                        L=512))
    want = list(jax_native.NativeBatchReader(SYNTH + "_1.fastq",
                                             SYNTH + "_2.fastq", batch=64,
                                             L=512))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert [str(s) for s in g.sids] == [str(s) for s in w.sids]
        for f in _BATCH_ARRAYS:
            _same(getattr(g, f), getattr(w, f))
    assert os.path.dirname(native.build()).endswith(
        os.path.join("build", "native"))


_RESULT_FIELDS = ("sequence_length", "quality", "overlap",
                  "overlaps_examined", "overlap_mismatches", "degenerates",
                  "estimated_overlap_probability", "slow")


def _results(oracle_mod, pairs, name, num_kmers=2):
    cfg = oracle_mod.OracleConfig(num_kmers=num_kmers)
    cfg.algorithm = oracle_mod.make_algorithm(name, None)
    return [oracle_mod.assemble(cfg, p) for p in pairs]


@pytest.mark.parametrize("name", ALGORITHMS)
def test_oracle_equal(name):
    """oracle.assemble on the first 60 synth pairs: the code and every
    result field, the merged sequence and its probabilities."""
    got = _results(oracle, _pairs(fq, 60), name)
    want = _results(jax_oracle, _pairs(jax_fq, 60), name)
    assert any(c == "OK" for _, c in got)
    for (g, gc), (w, wc) in zip(got, want):
        assert gc == wc
        assert (g is None) == (w is None)
        if g is None:
            continue
        for f in _RESULT_FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        _same(g.sequence_nt, w.sequence_nt)
        _same(g.sequence_p, w.sequence_p)


@pytest.mark.parametrize("spec", ["min_phred:20", "min_overlapbits:30",
                                  "empty", "pear_test", "sample",
                                  "DEGENERATE", "SHORT:250", "LONG:280"])
def test_filter_verdicts_equal(spec):
    """Each filter module of the port and of the JAX package, loaded from
    the same spec, gives the same verdict on each package's oracle
    results for the synth pairs."""

    def load(mod, stats_mod):
        name, _, arg = spec.partition(":")
        if name == "DEGENERATE":
            return mod.degenerates_module()
        if name == "SHORT":
            return mod.short_module(int(arg))
        if name == "LONG":
            return mod.long_module(int(arg))
        return mod.load_module(spec, stats_mod.LogProxy())

    got = load(filters, stats)
    want = load(jax_filters, jax_stats)
    ok = [(g, w) for (g, gc), (w, _) in zip(
        _results(oracle, _pairs(fq), "simple_bayesian"),
        _results(jax_oracle, _pairs(jax_fq), "simple_bayesian"))
        if gc == "OK"]
    verdicts = [(bool(got.check(g)), bool(want.check(w))) for g, w in ok]
    assert len(verdicts) > 150
    assert all(a == b for a, b in verdicts)
